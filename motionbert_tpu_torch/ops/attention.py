"""Plain PyTorch LayerNorm and single-axis attention for the DSTformer pair.

These are the plain versions that the CUDA pair kernel is held against
(``ops/fused_pair.py``). They keep the kernel's rounding points: inputs arrive
in the compute dtype, every sum is taken in fp32, and results are rounded back
to the compute dtype where the kernel rounds. In fp32 they reduce to the JAX
package's XLA formulation (``motionbert_tpu/ops/attention.py``:
``layer_norm``, ``_attention_xla``).
"""

from __future__ import annotations

import torch

LN_EPS = 1e-6


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """fp32 ``x @ weight.T + bias`` with ``weight`` in nn.Linear layout
    (out, in); the inputs may be bf16 (exact products, fp32 sums)."""
    return torch.matmul(x.float(), weight.float().t()) + bias.float()


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, var = E[x^2] -
    mean^2 (flax semantics), returned in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# (B, F, J, H, d) -> groups of tokens, and back
_PERM = {"spatial": (0, 1, 3, 2, 4), "temporal": (0, 2, 3, 1, 4)}


def st_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mode: str, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over the joints of one frame ("spatial") or
    the frames of one joint ("temporal") of (B, F, J, C) tensors. Scores and
    softmax in fp32, P rounded to q's dtype before P.v, output in q's dtype."""
    if mode not in _PERM:
        raise ValueError(f"unknown attention mode: {mode!r}")
    B, F, J, C = q.shape
    perm = _PERM[mode]
    qh, kh, vh = (t.reshape(B, F, J, num_heads, C // num_heads)
                  .permute(perm).float() for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.matmul(p.float(), vh).to(q.dtype)
    inv = [perm.index(i) for i in range(5)]
    return o.permute(inv).reshape(B, F, J, C)


def attention_block(x: torch.Tensor, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                    num_heads: int, scale: float, mode: str) -> torch.Tensor:
    """Pre-LN attention sub-block with residual, ``x + proj(attn(qkv(LN x)))``,
    returned in fp32 (the caller rounds it)."""
    C = x.shape[-1]
    h = layer_norm(x, ln_w, ln_b)
    qkv = linear(h, wqkv, bqkv).to(x.dtype)
    attn = st_attention(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:],
                        mode, num_heads, scale)
    return linear(attn, wproj, bproj) + x.float()
