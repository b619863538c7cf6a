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


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in the plain versions' accumulation type: fp32, or fp64 for an fp64
    tensor (so that ``torch.autograd.gradcheck`` can run them)."""
    return t if t.dtype == torch.float64 else t.float()


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """fp32 ``x @ weight.T + bias`` with ``weight`` in nn.Linear layout
    (out, in); the inputs may be bf16 (exact products, fp32 sums)."""
    return torch.matmul(wide(x), wide(weight).t()) + wide(bias)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics, var = E[x^2] -
    mean^2 (flax semantics), returned in x's dtype."""
    xf = wide(x)
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * wide(weight) + wide(bias)).to(x.dtype)


def ln_fwd_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float = LN_EPS) -> tuple:
    """LayerNorm forward keeping what its backward needs: (xhat, rstd, h),
    all fp32 (the JAX package's ``_ln_fwd_stats``)."""
    xf = wide(x)
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    return xhat, rstd, xhat * wide(weight) + wide(bias)


def ln_bwd_rows(dh: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                weight: torch.Tensor) -> tuple:
    """LayerNorm backward from fp32 ``dh`` (the JAX package's
    ``_ln_bwd_rows``): (dx, dweight, dbias), all fp32, the parameter
    gradients summed over every leading axis."""
    lead = tuple(range(dh.dim() - 1))
    dweight = (dh * xhat).sum(lead)
    dbias = dh.sum(lead)
    dy = dh * wide(weight)
    m1 = dy.mean(-1, keepdim=True)
    m2 = (dy * xhat).mean(-1, keepdim=True)
    return rstd * (dy - m1 - xhat * m2), dweight, dbias


# (B, F, J, H, d) -> groups of tokens, and back
_PERM = {"spatial": (0, 1, 3, 2, 4), "temporal": (0, 2, 3, 1, 4)}


def to_groups(t: torch.Tensor, mode: str, num_heads: int) -> torch.Tensor:
    """(B, F, J, C) -> (B, ., H, N, d): the N tokens that attend to each
    other (the J joints of a frame, or the F frames of a joint) per head."""
    B, F, J, C = t.shape
    return t.reshape(B, F, J, num_heads, C // num_heads).permute(_PERM[mode])


def from_groups(t: torch.Tensor, mode: str) -> torch.Tensor:
    """Inverse of ``to_groups``."""
    perm = _PERM[mode]
    t = t.permute([perm.index(i) for i in range(5)])
    B, F, J, H, d = t.shape
    return t.reshape(B, F, J, H * d)


def st_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mode: str, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over the joints of one frame ("spatial") or
    the frames of one joint ("temporal") of (B, F, J, C) tensors. Scores and
    softmax in fp32, P rounded to q's dtype before P.v, output in q's dtype."""
    if mode not in _PERM:
        raise ValueError(f"unknown attention mode: {mode!r}")
    qh, kh, vh = (wide(to_groups(t, mode, num_heads)) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.matmul(wide(p), vh).to(q.dtype)
    return from_groups(o, mode)


def attention_block(x: torch.Tensor, ln_w, ln_b, wqkv, bqkv, wproj, bproj,
                    num_heads: int, scale: float, mode: str) -> torch.Tensor:
    """Pre-LN attention sub-block with residual, ``x + proj(attn(qkv(LN x)))``,
    returned in fp32 (the caller rounds it)."""
    C = x.shape[-1]
    h = layer_norm(x, ln_w, ln_b)
    qkv = linear(h, wqkv, bqkv).to(x.dtype)
    attn = st_attention(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:],
                        mode, num_heads, scale)
    return linear(attn, wproj, bproj) + wide(x)
