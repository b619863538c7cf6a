"""The DSTformer attention+MLP pair, and the pair with the att_fuse gate.

    y   = x + proj(attn(qkv(LN1 x)))      yb = y rounded to x's dtype
    out = yb + fc2(GELU(fc1(LN2 yb)))
    gated: out <- other * a0 + out * a1,  (a0, a1) = softmax(other.wg[:, :C]
                                                   + out.wg[:, C:] + bg)

``fused_pair_block`` and ``fused_gated_pair_block`` take x (B, F, J, C). On a
CUDA tensor they launch the hand-written kernel chain in
``csrc/pair_kernels.cu`` (bf16, fp32 accumulation) or raise; on a CPU tensor
they run the plain PyTorch version beside them (``pair_block_plain``,
``gated_pair_block_plain``). Each wrapper counts its kernel launches in its
``launches`` attribute.

Source note. The CUDA chain replaces the TPU kernels
``motionbert_tpu/ops/fused_pair.py:_pair_pallas`` (``_pair_kernel``) and
``motionbert_tpu/ops/fused_pair.py:fused_gated_pair_block``
(``_gated_pair_kernel`` + ``_gate_rows``). On the H100 the pair is bound by
tensor-core operations (~4.7 MFLOP per token against 2 KB of token I/O at
the flagship shape). The TPU design keeps every weight resident on chip,
which 227 KB of shared memory cannot; the port runs five GEMM/attention
launches over the flattened rows (six when gated) and pays for qkv, attn, y
and the hidden activation in device memory; see the note at the top of the
``.cu`` file.

Weights use nn.Linear's layout: wqkv (3C, C), wproj (C, C), w1 (hidden, C),
w2 (C, hidden), wg (2, 2C). LayerNorm weights stay fp32; everything else is
in the compute dtype. Activations keep the JAX package's (B, F, J, C) layout.
"""

from __future__ import annotations

import ctypes

import torch

from motionbert_tpu_torch.ops import _build
from motionbert_tpu_torch.ops.attention import attention_block
from motionbert_tpu_torch.ops.fused_mlp import mlp_block

MAX_FRAMES = 243   # the kernel keeps one temporal group's K and V in shared memory
NUM_JOINTS = 17
HEAD_DIMS = (32, 64)
MAX_ROWS = 65535 * 64  # the GEMM grid's y extent times its 64-row tile


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def pair_block_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                     w1, b1, w2, b2, num_heads: int, scale: float,
                     mode: str) -> torch.Tensor:
    yb = attention_block(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                         num_heads, scale, mode).to(x.dtype)
    return mlp_block(yb, ln2_w, ln2_b, w1, b1, w2, b2).to(x.dtype)


def gate_plain(other: torch.Tensor, out: torch.Tensor, wg: torch.Tensor,
               bg: torch.Tensor) -> torch.Tensor:
    """att_fuse gate: fp32 logits, weights rounded to the compute dtype, mix
    in the compute dtype. wg[:, :C] scores ``other`` (the S->T stream)."""
    C = other.shape[-1]
    s = (torch.matmul(other.float(), wg[:, :C].float().t())
         + torch.matmul(out.float(), wg[:, C:].float().t()) + bg.float())
    a = torch.softmax(s, dim=-1).to(out.dtype)
    return other * a[..., 0:1] + out * a[..., 1:2]


def gated_pair_block_plain(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                           ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                           num_heads: int, scale: float,
                           mode: str) -> torch.Tensor:
    out = pair_block_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                           ln2_b, w1, b1, w2, b2, num_heads, scale, mode)
    return gate_plain(other, out, wg, bg)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_kernel_args(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                      ln2_w, ln2_b, w1, b1, w2, b2, wg, bg, num_heads: int,
                      mode: str) -> None:
    """Raise ValueError on anything the CUDA pair kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, F, J, C), got shape {tuple(x.shape)}")
    B, F, J, C = x.shape
    if mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown attention mode: {mode!r}")
    if J != NUM_JOINTS:
        raise ValueError(f"the pair kernel takes J={NUM_JOINTS} joints, got {J}")
    if not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"the pair kernel takes 1..{MAX_FRAMES} frames, "
                         f"got {F}")
    if not 1 <= B * F * J <= MAX_ROWS:
        raise ValueError(f"the pair kernel takes 1..{MAX_ROWS} token rows "
                         f"(B*F*J), got {B * F * J}")
    if C % 64 or num_heads < 1 or C % num_heads \
            or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"the pair kernel takes C % 64 == 0 and head dim in "
                         f"{HEAD_DIMS}, got C={C}, heads={num_heads}")
    hidden = w1.shape[0]
    if hidden % 64:
        raise ValueError(f"hidden width must be a multiple of 64, got {hidden}")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, (B, F, J, C), bf16, dev)
    if other is not None:
        _check("other", other, (B, F, J, C), bf16, dev)
        _check("wg", wg, (2, 2 * C), bf16, dev)
        _check("bg", bg, (2,), bf16, dev)
    for name, t in (("ln1_w", ln1_w), ("ln1_b", ln1_b), ("ln2_w", ln2_w),
                    ("ln2_b", ln2_b)):
        _check(name, t, (C,), f32, dev)
    for name, t, shape in (("wqkv", wqkv, (3 * C, C)), ("bqkv", bqkv, (3 * C,)),
                           ("wproj", wproj, (C, C)), ("bproj", bproj, (C,)),
                           ("w1", w1, (hidden, C)), ("b1", b1, (hidden,)),
                           ("w2", w2, (C, hidden)), ("b2", b2, (C,))):
        _check(name, t, shape, bf16, dev)


_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("pair_kernels")
    fn = lib.mbt_pair_block
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _launch(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2, wg, bg, num_heads, scale, mode) -> torch.Tensor:
    check_kernel_args(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                      ln2_w, ln2_b, w1, b1, w2, b2, wg, bg, num_heads, mode)
    B, F, J, C = x.shape
    hidden = w1.shape[0]
    M = B * F * J
    lib = _library()
    with torch.cuda.device(x.device):
        scratch = lambda n: torch.empty((M, n), dtype=x.dtype, device=x.device)
        qkv, attn, y, hid = scratch(3 * C), scratch(C), scratch(C), \
            scratch(hidden)
        pair_out = scratch(C) if other is not None else None
        out = torch.empty_like(x)
        ptr = lambda t: None if t is None else t.data_ptr()
        rc = lib.mbt_pair_block(
            ptr(x), ptr(other), ptr(out), ptr(qkv), ptr(attn), ptr(y),
            ptr(hid), ptr(pair_out), ptr(ln1_w), ptr(ln1_b), ptr(wqkv),
            ptr(bqkv), ptr(wproj), ptr(bproj), ptr(ln2_w), ptr(ln2_b),
            ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(wg), ptr(bg),
            B, F, J, C, num_heads, hidden, float(scale),
            int(mode == "temporal"),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair kernel launch failed with CUDA error {rc}")
    return out


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def fused_pair_block(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                     w1, b1, w2, b2, num_heads: int, scale: float,
                     mode: str) -> torch.Tensor:
    """LN1 -> qkv -> attention -> proj -> +x -> LN2 -> fc1 -> GELU -> fc2
    -> +y on x (B, F, J, C): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return pair_block_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                                ln2_w, ln2_b, w1, b1, w2, b2, num_heads,
                                scale, mode)
    if x.device.type != "cuda":
        raise ValueError(f"no pair kernel for device {x.device}")
    out = _launch(x, None, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                  ln2_b, w1, b1, w2, b2, None, None, num_heads, scale, mode)
    fused_pair_block.launches += 1
    return out


fused_pair_block.launches = 0


def fused_gated_pair_block(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                           ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                           num_heads: int, scale: float,
                           mode: str) -> torch.Tensor:
    """fused_pair_block followed by the att_fuse gate against ``other``:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    wg (2, 2C) with columns [:C] scoring ``other``; bg (2,)."""
    if x.device.type == "cpu":
        return gated_pair_block_plain(x, other, ln1_w, ln1_b, wqkv, bqkv,
                                      wproj, bproj, ln2_w, ln2_b, w1, b1,
                                      w2, b2, wg, bg, num_heads, scale, mode)
    if x.device.type != "cuda":
        raise ValueError(f"no pair kernel for device {x.device}")
    out = _launch(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                  ln2_b, w1, b1, w2, b2, wg, bg, num_heads, scale, mode)
    fused_gated_pair_block.launches += 1
    return out


fused_gated_pair_block.launches = 0
