"""The standalone MLP block and the plain MLP sub-block of the pair.

``fused_mlp_block`` is the token-wise ``[LN ->] fc1 -> exact GELU -> fc2
[-> + x]`` on x (..., C), differentiable (``torch.autograd.Function``
``FusedMlpBlock``). The model runs it, with ``fused_attention_block``, in
place of the fused pair when drop-path is live in training. On a CUDA tensor
the forward and the backward launch the hand-written kernel chains in
``csrc/block_kernels.cu`` (bf16, fp32 accumulation), or they raise; on a CPU
tensor they run the plain PyTorch versions beside them (``mlp_block_plain``,
``mlp_block_bwd_plain``). The forward saves only its inputs and the backward
recomputes the block. The wrappers count their kernel launches in
``fused_mlp_block.launches`` and ``fused_mlp_block_bwd.launches``.

Source note. The CUDA chains replace the TPU kernels
``motionbert_tpu/ops/fused_mlp.py:_fused_mlp_pallas`` and
``motionbert_tpu/ops/fused_mlp.py:_fused_mlp_bwd_pallas``. On the H100 the
block is bound by tensor-core operations: 34.7 GFLOP forward and 86.6 GFLOP
backward (fc1 three times with its recompute, fc2 twice) at the flagship
shape (16,524 token rows, C 512, hidden 1024), ~2.1 MFLOP per token against
2 KB of token I/O. The TPU
kernel tiles 512 token rows with both weights resident on chip, and gets erf
from a polynomial (|error| <= 1.5e-7) because its compiler has none. On the
card the weights do not fit an SM, so the forward is two GEMM launches and
the backward a chain of five GEMMs with two-pass deterministic reductions,
all on ``csrc/hopper_gemm.cuh``: wgmma products fed by TMA through a
three-stage mbarrier ring, 128 x 128 tiles, two blocks an SM, the bias,
residual, GELU and GELU' epilogues applied to the register fragments. The
port uses the exact erf (``erff`` on the card, ``torch.erf`` here).
``engine_gemm`` runs one engine launch alone, for its tests; its plain
version is ``engine_gemm_plain``.

The hidden activation is rounded to x's dtype before fc2, as the kernels
round it. Weights use nn.Linear's layout: w1 (hidden, C), w2 (C, hidden).
``mlp_block`` (pre-LN, residual, fp32 result) is the MLP half of the plain
pair (``ops/fused_pair.py``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from motionbert_tpu_torch.ops.attention import (
    ENGINE_MAX_ROWS, block_library, check_aligned, check_ln_args,
    check_tensor, data_ptr, device_kind, layer_norm, linear, ln_bwd_rows,
    ln_fwd_stats, no_ln_grads, rows, slot_pointers, weight_grad, wide)


def mlp_block(x: torch.Tensor, ln_w, ln_b, w1, b1, w2, b2,
              use_ln: bool = True, residual: bool = True) -> torch.Tensor:
    """MLP sub-block ``[x +] fc2(GELU(fc1([LN] x)))``, returned in fp32 (the
    caller rounds it). The pair uses the pre-LN form with the residual."""
    h = layer_norm(x, ln_w, ln_b) if use_ln else x
    z = F.gelu(linear(h, w1, b1)).to(x.dtype)
    out = linear(z, w2, b2)
    return out + wide(x) if residual else out


def mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, use_ln: bool = False,
                    residual: bool = False) -> torch.Tensor:
    """``mlp_block`` rounded to x's dtype: the plain version of
    ``fused_mlp_block``."""
    return mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, use_ln,
                     residual).to(x.dtype)


def mlp_block_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2, use_ln: bool = False,
                        residual: bool = False) -> tuple:
    """Gradients of ``mlp_block_plain`` at x for the output gradient g,
    written out at the rounding points of the JAX package's
    ``_fused_mlp_bwd_kernel``: the forward is recomputed (h, fp32 z, a
    rounded), dz is rounded to the compute dtype before its products, and db1
    sums the rounded dz. Returns (dx, dln_w, dln_b, dw1, db1, dw2, db2), each
    in its tensor's dtype (db2 in w2's); without use_ln, ``no_ln_grads``."""
    dt = x.dtype
    if use_ln:
        xhat, rstd, hf = ln_fwd_stats(x, ln_w, ln_b)
        h = hf.to(dt)
    else:
        h = x
    z = linear(h, w1, b1)
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    a = (z * cdf).to(dt)
    dw2 = weight_grad(g, a)
    db2 = rows(g).sum(0)
    da = torch.matmul(wide(g), wide(w2))
    pdf = torch.exp(-0.5 * z * z) * 0.3989422804014327
    dz = (da * (cdf + z * pdf)).to(dt)
    dw1 = weight_grad(dz, h)
    db1 = rows(dz).sum(0)
    dh = torch.matmul(wide(dz), wide(w1))
    if use_ln:
        dx, dln_w, dln_b = ln_bwd_rows(dh, xhat, rstd, ln_w)
        dln_w, dln_b = dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype)
    else:
        dx, (dln_w, dln_b) = dh, no_ln_grads(ln_w, ln_b)
    if residual:
        dx = dx + wide(g)
    return (dx.to(dt), dln_w, dln_b,
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(w2.dtype))


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def check_mlp_args(x, ln_w, ln_b, w1, b1, w2, b2,
                   use_ln: bool = True) -> None:
    """Raise ValueError on anything the CUDA MLP block does not take (b2
    None: the backward, which does not read it)."""
    if x.dim() < 1:
        raise ValueError("x must be (..., C)")
    C = x.shape[-1]
    M = x.numel() // max(C, 1)
    if not 1 <= M <= ENGINE_MAX_ROWS:
        raise ValueError(f"the MLP kernel takes 1..{ENGINE_MAX_ROWS} token "
                         f"rows, got {M}")
    hidden = w1.shape[0]
    if C % 64 or hidden % 64:
        raise ValueError(f"the MLP kernel takes C % 64 == 0 and hidden % 64 "
                         f"== 0, got C={C}, hidden={hidden}")
    dev, bf16 = x.device, torch.bfloat16
    check_tensor("x", x, x.shape, bf16, dev)
    check_ln_args(ln_w, ln_b, C, use_ln, dev)
    for name, t, shape in (("w1", w1, (hidden, C)), ("b1", b1, (hidden,)),
                           ("w2", w2, (C, hidden)), ("b2", b2, (C,))):
        if t is not None:
            check_tensor(name, t, shape, bf16, dev)
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t is not None:
            check_aligned(name, t)


# mbt_mlp_block_bwd's pointer array, in the order of the MlpSlot enum in
# csrc/block_kernels.cu: inputs, outputs, scratch
MLP_BWD_SLOTS = (
    "x", "g", "ln_w", "ln_b", "w1", "b1", "w2",
    "dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2",
    "h", "st", "z", "a", "dz", "dh", "work")


def _library():
    lib = block_library()
    if lib.mbt_mlp_bwd_slot_count() != len(MLP_BWD_SLOTS):
        raise RuntimeError("block_kernels.cu and MLP_BWD_SLOTS disagree on "
                           "the pointer slots")
    return lib


def _launch(x, ln_w, ln_b, w1, b1, w2, b2, use_ln, residual) -> torch.Tensor:
    check_mlp_args(x, ln_w, ln_b, w1, b1, w2, b2, use_ln)
    C, hidden = x.shape[-1], w1.shape[0]
    M = x.numel() // C
    lib = _library()
    with torch.cuda.device(x.device):
        # hid (M, hidden); with use_ln then h (M, C) and the fp32 row
        # statistics (M, 2) of the LayerNorm pass, as 4 bf16 a row
        hid = torch.empty(M * (hidden + (C + 4 if use_ln else 0)),
                          dtype=x.dtype, device=x.device)
        out = torch.empty_like(x)
        rc = lib.mbt_mlp_block(
            x.data_ptr(), out.data_ptr(), hid.data_ptr(), data_ptr(ln_w),
            data_ptr(ln_b), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), M, C, hidden, int(use_ln), int(residual),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"MLP block kernel launch failed with CUDA error "
                           f"{rc}")
    return out


def _launch_bwd(x, g, ln_w, ln_b, w1, b1, w2, use_ln, residual) -> tuple:
    check_mlp_args(x, ln_w, ln_b, w1, b1, w2, None, use_ln)
    check_tensor("g", g, x.shape, x.dtype, x.device)
    check_aligned("g", g)
    C, hidden = x.shape[-1], w1.shape[0]
    M = x.numel() // C
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        bf = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device=dev)
        f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        ln = lambda t: t if use_ln else None
        t = dict(x=x, g=g, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2,
                 dx=torch.empty_like(x), dln_w=ln(f32(C)), dln_b=ln(f32(C)),
                 dw1=bf(hidden, C), db1=bf(hidden), dw2=bf(C, hidden),
                 db2=bf(C), h=ln(bf(M, C)), st=ln(f32(M, 2)),
                 z=f32(M, hidden), a=bf(M, hidden), dz=bf(M, hidden),
                 dh=ln(f32(M, C)),
                 work=f32(lib.mbt_block_work_floats(hidden, C)))
        rc = lib.mbt_mlp_block_bwd(
            slot_pointers(MLP_BWD_SLOTS, t), M, C, hidden, int(use_ln),
            int(residual), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"MLP block backward kernel launch failed with "
                           f"CUDA error {rc}")
    if not use_ln:
        t["dln_w"], t["dln_b"] = no_ln_grads(ln_w, ln_b)
    return tuple(t[n] for n in ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2",
                                "db2"))


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def fused_mlp_block_bwd(x, g, ln_w, ln_b, w1, b1, w2, use_ln: bool = False,
                        residual: bool = False) -> tuple:
    """The MLP block's gradients (as ``mlp_block_bwd_plain`` orders them):
    the CUDA backward chain for a CUDA tensor, the plain backward for a CPU
    tensor."""
    args = (x, g, ln_w, ln_b, w1, b1, w2, use_ln, residual)
    if device_kind(x, "MLP block") == "cpu":
        return mlp_block_bwd_plain(*args)
    grads = _launch_bwd(*args)
    fused_mlp_block_bwd.launches += 1
    return grads


fused_mlp_block_bwd.launches = 0


class FusedMlpBlock(torch.autograd.Function):
    """``fused_mlp_block`` with its backward. Saves only the inputs; the
    backward recomputes the block."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, use_ln, residual):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2)
        ctx.cfg = (use_ln, residual)
        args = (x, ln_w, ln_b, w1, b1, w2, b2, use_ln, residual)
        if device_kind(x, "MLP block") == "cpu":
            return mlp_block_plain(*args)
        out = _launch(*args)
        fused_mlp_block.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        grads = fused_mlp_block_bwd(x, g.contiguous(), *params, *ctx.cfg)
        return (*grads, None, None)


def fused_mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, use_ln: bool = False,
                    residual: bool = False) -> torch.Tensor:
    """[LN ->] fc1 -> GELU -> fc2 [-> + x] on x (..., C), token-wise and
    differentiable in x and every parameter: the CUDA kernels for a CUDA
    tensor, the plain versions for a CPU tensor. ln_w / ln_b (C,) fp32 are
    read only with use_ln, and may be None without it."""
    return FusedMlpBlock.apply(x, ln_w, ln_b, w1, b1, w2, b2, use_ln, residual)


fused_mlp_block.launches = 0


# ---------------------------------------------------------------------------
# the GEMM engine alone (csrc/hopper_gemm.cuh through block_kernels.cu's test
# entry): one launch of a (layout, epilogue) pair the MLP chains use
# ---------------------------------------------------------------------------

# csrc/pair_common.cuh's Layout and Epilogue values and hopper_gemm.cuh's
# HG_TN_SPLITS and HG_BK; _engine_library holds them against the library's
# mbt_hgemm_constant, the plain version needs them without one
ENGINE_LAYOUTS = {"NT": 0, "NN": 1, "TN": 2}
ENGINE_EPILOGUES = {"bias": 0, "bias_res": 1, "bias_gelu": 2,
                    "bias_gelu_z": 3, "f32": 4, "bf16": 5, "dgelu": 6,
                    "partial": 7, "res": 8}
ENGINE_CASES = (("NT", "bias"), ("NT", "bias_res"), ("NT", "bias_gelu"),
                ("NT", "bias_gelu_z"), ("NN", "dgelu"), ("NN", "f32"),
                ("NN", "bf16"), ("NN", "res"), ("TN", "partial"))
ENGINE_TN_SPLITS = 8
ENGINE_BK = 64


def engine_split_rows(M: int) -> int:
    """Token rows of one TN chunk: M split ENGINE_TN_SPLITS ways, rounded up
    to whole k-steps (hopper_gemm.cuh's hg_split_rows)."""
    per = -(-M // ENGINE_TN_SPLITS)
    return -(-per // ENGINE_BK) * ENGINE_BK


def engine_shapes(layout: str, a: torch.Tensor, w: torch.Tensor) -> tuple:
    """(M, N, K) of a launch and the output's (rows, cols): NT a (M, K), w
    (N, K); NN a (M, K), w (K, N); TN a (M, N), w (M, K) -> (N, K)."""
    if layout == "NT":
        (M, K), N = a.shape, w.shape[0]
    elif layout == "NN":
        (M, K), N = a.shape, w.shape[1]
    else:
        (M, N), K = a.shape, w.shape[1]
        return (M, N, K), (N, K)
    return (M, N, K), (M, N)


def engine_gemm_plain(layout: str, epi: str, a, w, bias=None, r=None,
                      z=None):
    """The engine's launch in plain PyTorch: the fp32 product (exact bf16
    products, fp32 sums) and the epilogue at the kernel's rounding points,
    written as ``mlp_block`` and ``mlp_block_bwd_plain`` write each step.
    Returns the output (bf16, or fp32 for "f32"); "bias_gelu_z" returns
    (bf16 GELU(z), fp32 z); TN returns the ENGINE_TN_SPLITS fp32 partials
    (splits, N, K) of the fixed row chunks."""
    if layout == "TN":
        step = engine_split_rows(a.shape[0])
        return torch.stack([
            torch.matmul(wide(a[s * step:(s + 1) * step]).t(),
                         wide(w[s * step:(s + 1) * step]))
            for s in range(ENGINE_TN_SPLITS)])
    acc = torch.matmul(wide(a), wide(w).t() if layout == "NT" else wide(w))
    if epi == "f32":
        return acc
    if epi == "dgelu":
        zf = wide(z)
        cdf = 0.5 * (1.0 + torch.erf(zf * 0.7071067811865476))
        pdf = torch.exp(-0.5 * zf * zf) * 0.3989422804014327
        acc = acc * (cdf + zf * pdf)
    if epi.startswith("bias"):
        acc = acc + wide(bias)
    if epi in ("bias_res", "res"):
        acc = acc + wide(r)
    if epi == "bias_gelu":
        return F.gelu(acc).to(a.dtype)
    if epi == "bias_gelu_z":
        cdf = 0.5 * (1.0 + torch.erf(acc * 0.7071067811865476))
        return (acc * cdf).to(a.dtype), acc
    return acc.to(a.dtype)


def engine_constants() -> dict:
    """Every constant the engine's test entry and plain version share, by
    the name ``mbt_hgemm_constant`` takes."""
    return {**ENGINE_LAYOUTS, **ENGINE_EPILOGUES, "BK": ENGINE_BK,
            "TN_SPLITS": ENGINE_TN_SPLITS}


def _engine_library(M: int):
    lib = _library()
    if lib.mbt_hgemm_test.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbt_hgemm_test.argtypes = [i, i] + [vp] * 7 + [i] * 3 + [vp]
        lib.mbt_hgemm_test.restype = i
        for fn, argtypes in ((lib.mbt_hgemm_constant, [ctypes.c_char_p]),
                             (lib.mbt_hgemm_split_rows, [i])):
            fn.argtypes, fn.restype = argtypes, i
    drift = {name: (value, lib.mbt_hgemm_constant(name.encode()))
             for name, value in engine_constants().items()
             if lib.mbt_hgemm_constant(name.encode()) != value}
    if drift:
        raise RuntimeError(f"fused_mlp's engine constants disagree with the "
                           f"library's (ours, the library's): {drift}")
    if lib.mbt_hgemm_split_rows(M) != engine_split_rows(M):
        raise RuntimeError("hopper_gemm.cuh and engine_split_rows disagree on "
                           "the TN chunks")
    return lib


def engine_gemm(layout: str, epi: str, a, w, bias=None, r=None, z=None):
    """One launch of the GEMM engine on a CUDA tensor (the plain version on
    a CPU tensor), with ``engine_gemm_plain``'s arguments and results. a and
    w are 2-D, contiguous, bf16 and 16-byte aligned; N and K multiples of
    64; bias (N,) bf16, r (M, N) bf16 and z (M, N) fp32 where the epilogue
    reads them."""
    if device_kind(a, "GEMM engine") == "cpu":
        return engine_gemm_plain(layout, epi, a, w, bias, r, z)
    if (layout, epi) not in ENGINE_CASES:
        raise ValueError(f"the engine's test entry has no {layout}/{epi}")
    dev, bf16 = a.device, torch.bfloat16
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError("a and w must be 2-D")
    (M, N, K), out_shape = engine_shapes(layout, a, w)
    if N % 64 or K % 64 or not 1 <= M <= ENGINE_MAX_ROWS:
        raise ValueError(f"the engine takes N % 64 == 0, K % 64 == 0 and "
                         f"1..{ENGINE_MAX_ROWS} rows, got M={M}, N={N}, K={K}")
    check_tensor("a", a, a.shape, bf16, dev)
    check_tensor("w", w, w.shape, bf16, dev)
    check_aligned("a", a)
    check_aligned("w", w)
    rows_, cols = out_shape
    for name, t, shape, dt in (("bias", bias, (cols,), bf16),
                               ("r", r, out_shape, bf16),
                               ("z", z, out_shape, torch.float32)):
        needed = (name == "bias" and epi.startswith("bias")) or \
            (name == "r" and epi in ("bias_res", "res")) or \
            (name == "z" and epi == "dgelu")
        if needed:
            if t is None:
                raise ValueError(f"{epi} reads {name}")
            check_tensor(name, t, shape, dt, dev)
            check_aligned(name, t)
    lib = _engine_library(M)
    with torch.cuda.device(dev):
        if layout == "TN":
            out = torch.empty((ENGINE_TN_SPLITS, rows_, cols),
                              dtype=torch.float32, device=dev)
        else:
            out = torch.empty(out_shape, device=dev, dtype=torch.float32
                              if epi == "f32" else bf16)
        out_z = torch.empty(out_shape, dtype=torch.float32, device=dev) \
            if epi == "bias_gelu_z" else None
        rc = lib.mbt_hgemm_test(
            ENGINE_LAYOUTS[layout], ENGINE_EPILOGUES[epi], a.data_ptr(),
            w.data_ptr(), data_ptr(bias), data_ptr(r), data_ptr(z),
            out.data_ptr(), data_ptr(out_z), M, N, K,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"GEMM engine launch failed with CUDA error {rc}")
    engine_gemm.launches += 1
    return (out, out_z) if epi == "bias_gelu_z" else out


engine_gemm.launches = 0
