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
version is ``engine_gemm_plain``. ``engine_gemm_pair`` runs two products in
one grouped launch (``hg_gemm_pair``: a TN weight gradient first, then
another or an NN product), each tile as its own launch computes it;
``engine_pair_schedule`` mirrors the tiles each block of it walks.

Tensor-parallel modes (``parallel/tensor.py``): a model rank holds a hidden
slice of the MLP, w1 (hid_r, C) and w2 (C, hid_r). ``fused_mlp_block_tp``
runs B6's chain on it with the LayerNorm and returns the fp32 partial
product (no b2, no residual), ``fused_mlp_block_tp_bwd`` B7's chain up to
the fp32 gradient at the LayerNorm's output, with the row statistics
(plain twins ``mlp_block_tp_plain``, ``mlp_block_tp_bwd_plain``); the
LayerNorm backward is ``ops.attention.fused_ln_bwd``. At a shard's widths
a TN weight gradient fills under half the card, so B7_tp runs dW2 in one
grouped launch with dz and dW1 with dh, and adds both gradients' partials
in one in-order pass.

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
    ENGINE_MAX_ROWS, ln_from_stats, block_library, check_aligned,
    check_ln_args, check_tensor, data_ptr, device_kind, layer_norm, linear,
    ln_bwd_rows, ln_row_stats, no_ln_grads, rows, slot_pointers, weight_grad,
    wide)


def mlp_block(x: torch.Tensor, ln_w, ln_b, w1, b1, w2, b2,
              use_ln: bool = True, residual: bool = True) -> torch.Tensor:
    """MLP sub-block ``[x +] fc2(GELU(fc1([LN] x)))``, returned in fp32 (the
    caller rounds it). The pair uses the pre-LN form with the residual."""
    h = layer_norm(x, ln_w, ln_b) if use_ln else x
    z = F.gelu(linear(h, w1, b1)).to(x.dtype)
    out = linear(z, w2, b2)
    return out + wide(x) if residual else out


def mlp_block_tp_plain(x, ln_w, ln_b, w1, b1, w2) -> torch.Tensor:
    """The plain version of ``fused_mlp_block_tp``: LN, fc1 on a hidden
    slice w1 (hid_r, C) and GELU, rounded, and the fp32 product with fc2's
    columns of the slice w2 (C, hid_r), without bias or residual. Summed
    over the slices, plus fc2's bias and x, it is ``mlp_block``'s
    output."""
    z = F.gelu(linear(layer_norm(x, ln_w, ln_b), w1, b1)).to(x.dtype)
    return torch.matmul(wide(z), wide(w2).t())


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
    stats = ln_row_stats(x) if use_ln else None
    dh, dw1, db1, dw2 = _mlp_bwd_products(x, g, stats, ln_w, ln_b, w1, b1, w2)
    db2 = rows(g).sum(0)
    if use_ln:
        xhat, rstd, _ = ln_from_stats(x, stats, ln_w)
        dx, dln_w, dln_b = ln_bwd_rows(dh, xhat, rstd, ln_w)
        dln_w, dln_b = dln_w.to(ln_w.dtype), dln_b.to(ln_b.dtype)
    else:
        dx, (dln_w, dln_b) = dh, no_ln_grads(ln_w, ln_b)
    if residual:
        dx = dx + wide(g)
    return (dx.to(dt), dln_w, dln_b,
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(w2.dtype))


def mlp_block_tp_bwd_plain(x, g, ln_w, ln_b, w1, b1, w2) -> tuple:
    """The plain version of ``fused_mlp_block_tp_bwd``: the gradients of
    ``mlp_block_tp_plain`` for the output gradient g, at
    ``mlp_block_bwd_plain``'s rounding points, up to the fp32 gradient at
    the LayerNorm's output. Returns (dw1, db1, dw2, dh fp32, the LayerNorm's
    row statistics (..., 2) fp32)."""
    stats = ln_row_stats(x)
    dh, dw1, db1, dw2 = _mlp_bwd_products(x, g, stats, ln_w, ln_b, w1, b1, w2)
    return dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), dh, stats


def _mlp_bwd_products(x, g, stats, ln_w, ln_b, w1, b1, w2) -> tuple:
    """The MLP block's backward up to the fp32 gradient at fc1's input (the
    LayerNorm's output with ``stats``, else x): (dh, dw1, db1, dw2), fp32.
    w1 (hid, C), w2 (C, hid), whole or a hidden slice."""
    dt = x.dtype
    h = x if stats is None else ln_from_stats(x, stats, ln_w, ln_b)[2].to(dt)
    z = linear(h, w1, b1)
    cdf = 0.5 * (1.0 + torch.erf(z * 0.7071067811865476))
    a = (z * cdf).to(dt)
    dw2 = weight_grad(g, a)
    da = torch.matmul(wide(g), wide(w2))
    pdf = torch.exp(-0.5 * z * z) * 0.3989422804014327
    dz = (da * (cdf + z * pdf)).to(dt)
    dw1 = weight_grad(dz, h)
    db1 = rows(dz).sum(0)
    return torch.matmul(wide(dz), wide(w1)), dw1, db1, dw2


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
# mbt_mlp_block_tp_bwd's, in the order of the MlpTpSlot enum
MLP_TP_BWD_SLOTS = (
    "x", "g", "ln_w", "ln_b", "w1", "b1", "w2",
    "dw1", "db1", "dw2", "dh", "st",
    "h", "z", "a", "dz", "work")


def _library():
    lib = block_library()
    if lib.mbt_mlp_bwd_slot_count() != len(MLP_BWD_SLOTS) or \
            lib.mbt_mlp_tp_bwd_slot_count() != len(MLP_TP_BWD_SLOTS):
        raise RuntimeError("block_kernels.cu and MLP_BWD_SLOTS / "
                           "MLP_TP_BWD_SLOTS disagree on the pointer slots")
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


def _launch_tp(x, ln_w, ln_b, w1, b1, w2) -> torch.Tensor:
    check_mlp_args(x, ln_w, ln_b, w1, b1, w2, None, True)
    C, hidden = x.shape[-1], w1.shape[0]
    M = x.numel() // C
    lib = _library()
    with torch.cuda.device(x.device):
        # hid (M, hid_r), then the LayerNorm rows h (M, C)
        hid = torch.empty(M * (hidden + C), dtype=x.dtype, device=x.device)
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        rc = lib.mbt_mlp_block_tp(
            x.data_ptr(), out.data_ptr(), hid.data_ptr(), ln_w.data_ptr(),
            ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), M,
            C, hidden, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-parallel MLP block kernel launch failed "
                           f"with CUDA error {rc}")
    return out


def _launch_tp_bwd(x, g, ln_w, ln_b, w1, b1, w2) -> tuple:
    check_mlp_args(x, ln_w, ln_b, w1, b1, w2, None, True)
    check_tensor("g", g, x.shape, x.dtype, x.device)
    check_aligned("g", g)
    C, hidden = x.shape[-1], w1.shape[0]
    M = x.numel() // C
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        bf = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device=dev)
        f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
        t = dict(x=x, g=g, ln_w=ln_w, ln_b=ln_b, w1=w1, b1=b1, w2=w2,
                 dw1=bf(hidden, C), db1=bf(hidden), dw2=bf(C, hidden),
                 dh=f32(*x.shape), st=f32(*x.shape[:-1], 2), h=bf(M, C),
                 z=f32(M, hidden), a=bf(M, hidden), dz=bf(M, hidden),
                 work=f32(lib.mbt_block_work_floats(2 * hidden, C)))
        rc = lib.mbt_mlp_block_tp_bwd(
            slot_pointers(MLP_TP_BWD_SLOTS, t), M, C, hidden,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tensor-parallel MLP block backward kernel launch "
                           f"failed with CUDA error {rc}")
    return tuple(t[n] for n in ("dw1", "db1", "dw2", "dh", "st"))


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def fused_mlp_block_tp(x, ln_w, ln_b, w1, b1, w2) -> torch.Tensor:
    """B6's tensor-parallel mode on x (..., C) and a hidden slice (see
    ``mlp_block_tp_plain``): the fp32 partial product, to be summed over the
    model ranks. The CUDA chain for a CUDA tensor, the plain version for a
    CPU tensor; ``parallel.tensor`` pairs it with ``fused_mlp_block_tp_bwd``."""
    if device_kind(x, "MLP block") == "cpu":
        return mlp_block_tp_plain(x, ln_w, ln_b, w1, b1, w2)
    out = _launch_tp(x, ln_w, ln_b, w1, b1, w2)
    fused_mlp_block_tp.launches += 1
    return out


fused_mlp_block_tp.launches = 0


def fused_mlp_block_tp_bwd(x, g, ln_w, ln_b, w1, b1, w2) -> tuple:
    """B7's tensor-parallel mode (see ``mlp_block_tp_bwd_plain``): (dw1,
    db1, dw2, dh fp32, row statistics)."""
    args = (x, g, ln_w, ln_b, w1, b1, w2)
    if device_kind(x, "MLP block") == "cpu":
        return mlp_block_tp_bwd_plain(*args)
    grads = _launch_tp_bwd(*args)
    fused_mlp_block_tp_bwd.launches += 1
    return grads


fused_mlp_block_tp_bwd.launches = 0


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


def _engine_launch(layout: str, epi: str, a, w, bias=None, r=None, z=None):
    """A launch's checked arguments and allocated outputs: ((M, N, K),
    its outputs (out, out_z or None), its pointer list (A, W, bias, R, Z,
    out, out_z))."""
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
    with torch.cuda.device(dev):
        if layout == "TN":
            out = torch.empty((ENGINE_TN_SPLITS, rows_, cols),
                              dtype=torch.float32, device=dev)
        else:
            out = torch.empty(out_shape, device=dev, dtype=torch.float32
                              if epi == "f32" else bf16)
        out_z = torch.empty(out_shape, dtype=torch.float32, device=dev) \
            if epi == "bias_gelu_z" else None
    ptrs = [a.data_ptr(), w.data_ptr(), data_ptr(bias), data_ptr(r),
            data_ptr(z), out.data_ptr(), data_ptr(out_z)]
    return (M, N, K), (out, out_z), ptrs


def _engine_result(epi: str, outs: tuple):
    return outs if epi == "bias_gelu_z" else outs[0]


def engine_gemm(layout: str, epi: str, a, w, bias=None, r=None, z=None):
    """One launch of the GEMM engine on a CUDA tensor (the plain version on
    a CPU tensor), with ``engine_gemm_plain``'s arguments and results. a and
    w are 2-D, contiguous, bf16 and 16-byte aligned; N and K multiples of
    64; bias (N,) bf16, r (M, N) bf16 and z (M, N) fp32 where the epilogue
    reads them."""
    if device_kind(a, "GEMM engine") == "cpu":
        return engine_gemm_plain(layout, epi, a, w, bias, r, z)
    (M, N, K), outs, ptrs = _engine_launch(layout, epi, a, w, bias, r, z)
    lib = _engine_library(M)
    with torch.cuda.device(a.device):
        rc = lib.mbt_hgemm_test(
            ENGINE_LAYOUTS[layout], ENGINE_EPILOGUES[epi], *ptrs, M, N, K,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"GEMM engine launch failed with CUDA error {rc}")
    engine_gemm.launches += 1
    return _engine_result(epi, outs)


engine_gemm.launches = 0

# the pairs of (layout, epilogue) the engine's grouped launch takes: a TN
# weight gradient first, then another or the NN product beside it
ENGINE_PAIRS = ((("TN", "partial"), ("TN", "partial")),
                (("TN", "partial"), ("NN", "dgelu")),
                (("TN", "partial"), ("NN", "f32")))


# the k-steps an epilogue adds to a tile's time (hopper_gemm.cuh's
# hg_epilogue_steps): GELU' reads z and computes erf and exp per element
ENGINE_EPILOGUE_STEPS = {"dgelu": 8}


def engine_pair_lead(steps0: int, steps1: int, epi0: str = "partial",
                     epi1: str = "partial") -> int:
    """hg_gemm_pair's lead: product 0's tile time in product 1's tiles,
    each a tile's k-steps plus its epilogue's, rounded, at least 1."""
    k0 = steps0 + ENGINE_EPILOGUE_STEPS.get(epi0, 0)
    k1 = steps1 + ENGINE_EPILOGUE_STEPS.get(epi1, 0)
    return max(1, (k0 + k1 // 2) // k1) if k1 > 0 else 1


def engine_pair_schedule(n0: int, n1: int, grid: int, lead: int) -> list:
    """The tiles each block of hg_gemm_pair_kernel's grid walks, in its
    order, as (product, tile): product 0's round robin; then, on the blocks
    product 0's last round left free (b >= n0 % grid), ``lead`` of product
    1's tiles each; then product 1's remaining tiles round robin."""
    rem = n0 % grid
    blocks = []
    for b in range(grid):
        tiles = [(0, t) for t in range(b, n0, grid)]
        if b >= rem:
            tiles += [(1, j) for j in (b - rem + i * (grid - rem)
                                       for i in range(lead)) if j < n1]
        tiles += [(1, j) for j in range(lead * (grid - rem) + b, n1, grid)]
        blocks.append(tiles)
    return blocks


def engine_gemm_pair(first: tuple, second: tuple, lead: int = 0) -> tuple:
    """Two products in one grouped launch of the engine
    (``hg_gemm_pair``) on CUDA tensors, each given as ``engine_gemm``'s
    arguments (layout, epi, a, w[, bias, r, z]) and returned as
    ``engine_gemm`` returns it: each tile computed as its own launch
    computes it; ``lead`` the second product's tiles a block takes where
    the first's last round left it free (0: ``engine_pair_lead``'s rule).
    The two plain versions on CPU tensors. Counted in
    ``engine_gemm_pair.launches``."""
    if device_kind(first[2], "GEMM engine") == "cpu":
        return engine_gemm_plain(*first), engine_gemm_plain(*second)
    if (tuple(first[:2]), tuple(second[:2])) not in ENGINE_PAIRS:
        raise ValueError(f"the engine's grouped launch has no "
                         f"{first[:2]} + {second[:2]}")
    launches = [_engine_launch(*case) for case in (first, second)]
    lib = _engine_library(launches[0][0][0])
    if lib.mbt_hgemm_pair_test.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbt_hgemm_pair_test.argtypes = (
            [i, i, ctypes.POINTER(vp)] + [i] * 3) * 2 + [i, vp]
        lib.mbt_hgemm_pair_test.restype = i
    args = []
    for case, (shape, _, ptrs) in zip((first, second), launches):
        args += [ENGINE_LAYOUTS[case[0]], ENGINE_EPILOGUES[case[1]],
                 (ctypes.c_void_p * 7)(*ptrs), *shape]
    dev = first[2].device
    with torch.cuda.device(dev):
        rc = lib.mbt_hgemm_pair_test(
            *args, int(lead), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped GEMM engine launch failed with CUDA "
                           f"error {rc}")
    engine_gemm_pair.launches += 1
    return tuple(_engine_result(case[1], outs)
                 for case, (_, outs, _) in zip((first, second), launches))


engine_gemm_pair.launches = 0


# ---------------------------------------------------------------------------
# the LayerNorm inside the first product (csrc/block_kernels.cu hg_ln_gemm;
# the test entry mbt_ln_gemm_test)
# ---------------------------------------------------------------------------

# hopper_gemm.cuh's LNG_* constants by mbt_ln_gemm_constant's names: the
# widest row a block keeps in shared memory, hg_ln_gemm's M tile and weight
# ring
LN_PRODUCT = {"max_c": 512, "bm": 128, "stages": 4}


def ln_product_takes(C: int) -> bool:
    """Whether ``hg_ln_gemm`` takes rows of C (hopper_gemm.cuh's lng_takes):
    whole 64-column k-blocks, at most LN_PRODUCT["max_c"]."""
    return C >= ENGINE_BK and C % ENGINE_BK == 0 and C <= LN_PRODUCT["max_c"]


def ln_engine_gemm_plain(x, ln_w, ln_b, w, bias) -> torch.Tensor:
    """``hg_ln_gemm`` in plain PyTorch: each block's LN_PRODUCT["bm"] rows of
    x normalised (``layer_norm``), then the engine's NT product with the
    bias (``engine_gemm_plain``); bit for bit ``layer_norm`` then
    ``engine_gemm_plain("NT", "bias", ...)`` over all rows."""
    step = LN_PRODUCT["bm"]
    return torch.cat([engine_gemm_plain("NT", "bias", layer_norm(
        x[m:m + step], ln_w, ln_b), w, bias) for m in range(0, x.shape[0],
                                                            step)])


def ln_engine_gemm(x, ln_w, ln_b, w, bias, fused: bool = True) -> torch.Tensor:
    """bf16 out (M, N) = bf16(LN(x)) w^T + bias for x (M, C), w (N, C),
    bias (N,) bf16, ln_w / ln_b (C,) fp32: on CUDA tensors one call of
    ``mbt_ln_gemm_test``, fused the LayerNorm inside the product (one
    launch; C must satisfy ``ln_product_takes``), else ln_fwd_rows and the
    engine's NT product, counted in ``ln_engine_gemm.launches``; on CPU
    tensors ``ln_engine_gemm_plain``."""
    if device_kind(x, "GEMM engine") == "cpu":
        return ln_engine_gemm_plain(x, ln_w, ln_b, w, bias)
    (M, N, C), (out, _), _ = _engine_launch("NT", "bias", x, w, bias)
    check_ln_args(ln_w, ln_b, C, True, x.device)
    lib = _library()
    drift = {k: (v, lib.mbt_ln_gemm_constant(k.encode()))
             for k, v in LN_PRODUCT.items()
             if lib.mbt_ln_gemm_constant(k.encode()) != v}
    if drift:
        raise RuntimeError(f"LN_PRODUCT disagrees with the library's "
                           f"(ours, the library's): {drift}")
    with torch.cuda.device(x.device):
        h = None if fused else torch.empty_like(x)
        rc = lib.mbt_ln_gemm_test(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
            bias.data_ptr(), out.data_ptr(), data_ptr(h), M, N, C,
            int(fused), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"LayerNorm-in-product launch failed with CUDA "
                           f"error {rc}")
    ln_engine_gemm.launches += 1
    return out


ln_engine_gemm.launches = 0
