"""The W8A8 serving tier of the DSTformer pair: the four projections (qkv,
proj, fc1, fc2) as int8 x int8 -> int32 products, the attention core, the
gate and all elementwise math as in the bf16 pair (``ops/fused_pair.py``).

    h    = LN1(x)                              fp32, never rounded to bf16
    qkv  = qdot(h, Wqkv) + bqkv                fp32; q, k, v rounded to x's dtype
    attn = softmax(q k^T * scale) v            x's dtype (the bf16 pair's core)
    yb   = (qdot(attn, Wproj) + bproj + x)     rounded to x's dtype
    z    = qdot(LN2(yb), W1) + b1              fp32
    out  = qdot(GELU(z), W2) + b2 + yb         GELU(z) fp32 into the quantiser
    qdot(a, W) = (a8 . W8^T) * row_scale(a) * col_scale(W)

Scheme (the JAX package's ``motionbert_tpu/ops/pair_q8.py``): weights get
per-output-channel symmetric int8 (``quant_cols``), activations per-row
symmetric int8 (``q8_rows``), the integer product is exact, and the rank-1
scale product dequantises inside the bias add. The gate of the gated pair is
the bf16 pair's ``gate_plain``.

``fused_pair_block_q8`` and ``fused_gated_pair_block_q8`` have the bf16
wrappers' signatures and take the same full-precision parameters, so one
checkpoint runs in either tier. On a CUDA tensor the forward launches the
hand-written chain in ``csrc/pair_q8_kernels.cu`` or raises; on a CPU tensor
it runs the plain versions below (``pair_block_q8_plain``,
``gated_pair_block_q8_plain``). The backward is straight-through: the bf16
pair's backward on the full-precision weights (``fused_pair_block_bwd`` /
``fused_gated_pair_block_bwd``), so a q8 backward counts as a launch of that
kernel. Each wrapper counts its forward launches in ``launches``.

Weight quantisation runs per call, before the chain, as the JAX package runs
it outside its kernel: the model hands each pair a fresh cast of its fp32
parameters, so there is no weight version to key a cache on at this level.
On a CUDA tensor ``quant_cols`` takes all the weights of a call in one
launch of ``csrc/pair_q8_common.cuh``'s ``quant_cols_kernel`` (the plain
``quant_cols_plain`` on a CPU tensor), bit for bit the plain version. Its
cost is part of every time measured for the wrappers (PERF.md, B9).

The plain versions take the integer products as fp32 ``matmul``s of the int8
values: every partial sum is an integer below 2^24 while 127 * 127 * K < 2^24
(K <= 1040), so the result is exact in any summation order; longer rows go
through float64.

The chain's four products run on the s8 variant of the wgmma + TMA GEMM
engine (``csrc/hopper_gemm_s8.cuh``) and its attention core on the bf16
pair's tensor-core forward (``csrc/attention_tc.cuh``).
``engine_gemm_q8`` launches the s8 engine alone on int8 operands (plain twin
``engine_gemm_q8_plain``, which it equals bit for bit in the bias and
residual epilogues: the integer sums are exact and the dequantise is the
same chain of fp32 roundings).

The pair on shards (B9_tp). Under tensor parallelism a model rank holds a
head group of the attention (wqkv's rows of Hl heads, wproj's matching Ci
columns) and a hidden slice of the MLP (w1's rows, w2's columns), and x is
replicated. ``fused_pair_block_q8_tp`` runs the W8A8 pair on them with the
model group's collectives between its stages: qkv and fc1 are
column-parallel, and a per-output-channel scale sees its whole column on
the rank's rows; the rows that proj and fc2 quantise (the attention output,
GELU(hid)) and the columns of wproj and w2 are the rank's K of them, so
their absolute maxima are all-reduced with MAX before quantising
(``quant_cols_tp`` for the weights; the activations' row maxima come out of
the attention core's and fc1's epilogues), and the raw int32 products are
all-reduced with SUM (exact) before the dequantising row passes (the one
after proj takes LN2 and its quantiser along, the gated one after fc2 the
gate). Every scale, integer and rounding is then the unsharded pair's:
the output equals B9's (and its plain twin ``pair_block_q8_tp_plain`` the
plain pair's) bit for bit at any model size. With a group of None that half
is whole on every rank. The backward is the caller's
(``parallel.tensor.TpPairsQ8``: the bf16 TP halves', straight-through).

Source note. The CUDA chain replaces the TPU kernel
``motionbert_tpu/ops/pair_q8.py:_q8_launch`` (``_pair_q8_kernel``,
``_gated_pair_q8_kernel``, body ``_pair_rows_q8``). Bound and design are in
the note at the top of the ``.cu`` file.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from motionbert_tpu_torch.ops import _build
from motionbert_tpu_torch.ops.attention import (
    ENGINE_MAX_ROWS, HEAD_DIMS, MAX_FRAMES, NUM_JOINTS, check_aligned,
    check_tensor, core_max_rows, ln_fwd_stats, st_attention_plain, wide)
from motionbert_tpu_torch.ops.fused_pair import (
    _device_kind, check_kernel_args, fused_gated_pair_block_bwd,
    fused_pair_block_bwd, gate_plain)

INV127 = 0.007874015718698502   # float32(1 / 127), exactly
ROW_AMAX_FLOOR = 1e-6
COL_AMAX_FLOOR = 1e-8
EXACT_FP32_K = (1 << 24) // (127 * 127)   # 1040


# ---------------------------------------------------------------------------
# quantisers and plain versions
# ---------------------------------------------------------------------------

def _quantise(a: torch.Tensor, amax: torch.Tensor, floor: float) -> tuple:
    scale = torch.clamp_min(amax, floor) * INV127
    q = torch.clamp(torch.round(a / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def q8_rows(a: torch.Tensor) -> tuple:
    """Per-row symmetric int8 of fp32 rows (..., K): (int8 (..., K), fp32
    scale (..., 1)); round half to even, a / scale as a division."""
    a = a.float()
    return _quantise(a, a.abs().amax(-1, keepdim=True), ROW_AMAX_FLOOR)


def quant_cols_plain(w: torch.Tensor) -> tuple:
    """Per-output-channel symmetric int8 of an nn.Linear weight (out, in):
    (int8 (out, in), fp32 scale (out,)), one scale per row of the stored
    weight."""
    wf = w.float()
    return quant_cols_given_plain(wf, col_amax_plain(wf))


def col_amax_plain(w: torch.Tensor) -> torch.Tensor:
    """Each output channel's |w| maximum over the weight's columns, fp32
    (out,): the first half of the split quantiser."""
    return w.float().abs().amax(1)


def quant_cols_given_plain(w: torch.Tensor, amax: torch.Tensor) -> tuple:
    """``quant_cols_plain`` with each output channel's maximum given (the
    split quantiser's second half, after the MAX over the model ranks)."""
    q, scale = _quantise(w.float(), amax[:, None], COL_AMAX_FLOOR)
    return q, scale.reshape(-1)


# the column quantisers' passes (csrc/pair_q8_common.cuh ColQuantMode) and
# the weights one launch takes (COLQ_MAX)
COLQ_WHOLE, COLQ_AMAX, COLQ_GIVEN = 0, 1, 2
COLQ_MAX = 8


def check_quant_cols_args(ws) -> None:
    """Raise ValueError on weights the column quantisers do not take: 1 to
    COLQ_MAX of them, each 2-D, bf16 or fp32, contiguous, on one CUDA
    device, K % 4 == 0 (a lane reads four values) and 8-byte (bf16) or
    16-byte (fp32) aligned."""
    if not 1 <= len(ws) <= COLQ_MAX:
        raise ValueError(f"a column quantiser launch takes 1..{COLQ_MAX} "
                         f"weights, got {len(ws)}")
    dev = ws[0].device
    for i, w in enumerate(ws):
        if w.dim() != 2 or w.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"weight {i}: the column quantiser takes 2-D "
                             f"bf16 or fp32, got {w.dtype} {tuple(w.shape)}")
        N, K = w.shape
        if N < 1 or K < 4 or K % 4:
            raise ValueError(f"weight {i}: the column quantiser takes K % 4 "
                             f"== 0 and a row or more, got {tuple(w.shape)}")
        if w.device != dev or not w.is_contiguous():
            raise ValueError(f"weight {i}: contiguous, on {dev}")
        if w.data_ptr() % (4 * w.element_size()):
            raise ValueError(f"weight {i}: the column quantiser reads "
                             f"{4 * w.element_size()}-byte-aligned rows")


# argument types of the column quantisers' C entry (csrc/pair_q8_kernels.cu)
QUANT_COLS_ARGTYPES = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8


def _quant_cols_library() -> ctypes.CDLL:
    lib = _library()
    fn = lib.mbt_quant_cols
    if fn.argtypes is None:
        fn.argtypes = QUANT_COLS_ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _col_quant(mode: int, ws, amax=None):
    """One launch of the column quantisers' pass ``mode`` for the weights
    ``ws`` (checked by the caller): COLQ_WHOLE and COLQ_GIVEN return
    [(int8, scale)], COLQ_AMAX fills ``amax`` (a fp32 (out,) tensor a
    weight)."""
    lib = _quant_cols_library()
    dev, n = ws[0].device, len(ws)
    pairs = [] if mode == COLQ_AMAX else [
        (torch.empty(w.shape, dtype=torch.int8, device=dev),
         torch.empty((w.shape[0],), dtype=torch.float32, device=dev))
        for w in ws]
    ints = lambda vals: (ctypes.c_int * n)(*vals)
    ptrs = lambda ts: None if not ts else (ctypes.c_void_p * n)(
        *(t.data_ptr() for t in ts))
    rc = lib.mbt_quant_cols(
        mode, n, ptrs(ws), ints(int(w.dtype == torch.float32) for w in ws),
        ptrs([q for q, _ in pairs]), ptrs([s for _, s in pairs]), ptrs(amax),
        ints(w.shape[0] for w in ws), ints(w.shape[1] for w in ws),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"column quantiser launch failed with CUDA error "
                           f"{rc}")
    return pairs


def quant_cols(*ws: torch.Tensor):
    """Per-output-channel symmetric int8 of nn.Linear weights (out, in):
    for one weight (int8 (out, in), fp32 scale (out,)), for several a list
    of those pairs. On CUDA tensors one launch of ``quant_cols_kernel``
    takes them all (up to COLQ_MAX, counted in ``quant_cols.launches``),
    bit for bit ``quant_cols_plain``, which CPU tensors take."""
    if _device_kind(ws[0], "column quantiser") == "cpu":
        out = [quant_cols_plain(w) for w in ws]
    else:
        check_quant_cols_args(ws)
        with torch.cuda.device(ws[0].device):
            out = _col_quant(COLQ_WHOLE, ws)
        quant_cols.launches += 1
    return out[0] if len(ws) == 1 else out


quant_cols.launches = 0


def _int_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact a8 (..., K) . w8 (N, K)^T as fp32 values (see the module note)."""
    dt = torch.float32 if a8.shape[-1] <= EXACT_FP32_K else torch.float64
    return torch.matmul(a8.to(dt), w8.to(dt).t()).float()


def _int_products(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The exact integer product a8 (..., K) . w8 (N, K)^T as int32."""
    dt = torch.float32 if a8.shape[-1] <= EXACT_FP32_K else torch.float64
    return torch.matmul(a8.to(dt), w8.to(dt).t()).to(torch.int32)


def qdot_plain(a: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Quantise the fp32 rows of ``a`` and the weight (out, in), take the
    integer product, dequantise and add the bias: fp32 rows (..., out)."""
    a8, ascale = q8_rows(a)
    w8, wscale = quant_cols_plain(w)
    return _int_matmul(a8, w8) * ascale * wscale + bias.float()


# the s8 engine's epilogues (csrc/hopper_gemm_s8.cuh's Q8Epilogue)
Q8_EPILOGUES = {"bias": 0, "bias_res": 1, "bias_gelu_f32": 2, "acc_s32": 3}


def engine_gemm_q8_plain(epi: str, a8, ascale, w8, wscale, bias,
                         r=None) -> torch.Tensor:
    """The s8 engine's function (``Q8_EPILOGUES``): the exact integer
    product a8 (M, K) . w8 (N, K)^T dequantised as ((acc * ascale[m]) *
    wscale[n]) + bias[n] in fp32, one rounding at a time, as ``qdot_plain``
    takes it; "bias_res" adds r (M, N); both round once to bias's dtype.
    "bias_gelu_f32" returns the fp32 GELU of the sum, as
    ``pair_block_q8_plain`` takes it; "acc_s32" the int32 product itself
    (B9_tp's row-parallel partials), reading no scale, bias or r."""
    if epi == "acc_s32":
        return _int_products(a8, w8)
    acc = _int_matmul(a8, w8) * ascale.reshape(-1, 1) * wscale + bias.float()
    if epi == "bias_gelu_f32":
        return 0.5 * acc * (1.0 + torch.erf(acc * 0.7071067811865476))
    if epi == "bias_res":
        acc = acc + wide(r)
    return acc.to(bias.dtype)


def pair_block_q8_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                        ln2_b, w1, b1, w2, b2, num_heads: int, scale: float,
                        mode: str) -> torch.Tensor:
    """The W8A8 pair at the TPU kernel's rounding points (module note)."""
    dt = x.dtype
    C = x.shape[-1]
    h = ln_fwd_stats(x, ln1_w, ln1_b)[2]
    qkv = qdot_plain(h, wqkv, bqkv)
    attn = st_attention_plain(qkv[..., :C].to(dt), qkv[..., C:2 * C].to(dt),
                              qkv[..., 2 * C:].to(dt), mode, num_heads, scale)
    yb = (qdot_plain(wide(attn), wproj, bproj) + wide(x)).to(dt)
    z = qdot_plain(ln_fwd_stats(yb, ln2_w, ln2_b)[2], w1, b1)
    g = 0.5 * z * (1.0 + torch.erf(z * 0.7071067811865476))
    return (qdot_plain(g, w2, b2) + wide(yb)).to(dt)


def gated_pair_block_q8_plain(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj,
                              bproj, ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                              num_heads: int, scale: float,
                              mode: str) -> torch.Tensor:
    out = pair_block_q8_plain(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                              ln2_w, ln2_b, w1, b1, w2, b2, num_heads, scale,
                              mode)
    return gate_plain(other, out, wg, bg)


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_ARGTYPES = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("pair_q8_kernels")
    fn = lib.mbt_pair_block_q8
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _launch(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2, wg, bg, num_heads, scale, mode) -> torch.Tensor:
    # the bf16 kernels' conditions are the int8 chain's too: C and hidden
    # multiples of 64 give the s8 engine's TMA 16-byte row strides, the
    # tensor-core core bounds the rows, and x and the biases sit at 16-byte-
    # aligned addresses (the weights' int8 casts and the scratch are fresh)
    check_kernel_args(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                      ln2_w, ln2_b, w1, b1, w2, b2, wg, bg, num_heads, mode)
    B, F, J, C = x.shape
    hidden = w1.shape[0]
    M = B * F * J
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        (wqkv8, sqkv), (wproj8, sproj), (w18, s1), (w28, s2) = quant_cols(
            wqkv, wproj, w1, w2)
        empty = lambda n, dtype: torch.empty((M, n), dtype=dtype, device=dev)
        a8 = empty(max(C, hidden), torch.int8)
        ascale = torch.empty((M,), dtype=torch.float32, device=dev)
        qkv, attn, y = (empty(n, x.dtype) for n in (3 * C, C, C))
        act = empty(hidden, torch.float32)
        pair_out = empty(C, x.dtype) if other is not None else None
        out = torch.empty_like(x)
        ptr = lambda t: None if t is None else t.data_ptr()
        rc = lib.mbt_pair_block_q8(
            ptr(x), ptr(other), ptr(out), ptr(a8), ptr(ascale), ptr(qkv),
            ptr(attn), ptr(y), ptr(act), ptr(pair_out), ptr(ln1_w),
            ptr(ln1_b), ptr(wqkv8), ptr(sqkv), ptr(bqkv), ptr(wproj8),
            ptr(sproj), ptr(bproj), ptr(ln2_w), ptr(ln2_b), ptr(w18),
            ptr(s1), ptr(b1), ptr(w28), ptr(s2), ptr(b2), ptr(wg), ptr(bg),
            B, F, J, C, num_heads, hidden, float(scale),
            int(mode == "temporal"),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"q8 pair kernel launch failed with CUDA error {rc}")
    return out


def check_engine_q8_args(epi: str, a8, ascale, w8, wscale, bias, r) -> tuple:
    """Raise ValueError on anything the s8 engine's test entry does not
    take; return (M, N, K). The TMA reads int8 rows of K bytes at 16-byte
    strides from 16-byte-aligned bases, and the chain's widths are whole
    64-column tiles, so N and K are multiples of 64."""
    if epi not in Q8_EPILOGUES:
        raise ValueError(f"unknown s8 engine epilogue: {epi!r}")
    if a8.dim() != 2 or w8.dim() != 2:
        raise ValueError("a8 and w8 must be 2-D")
    (M, K), N = a8.shape, w8.shape[0]
    if N % 64 or K % 64 or not 1 <= M <= ENGINE_MAX_ROWS:
        raise ValueError(f"the s8 engine takes N % 64 == 0, K % 64 == 0 and "
                         f"1..{ENGINE_MAX_ROWS} rows, got M={M}, N={N}, K={K}")
    dev, f32 = a8.device, torch.float32
    for name, t, shape, dt in (
            ("a8", a8, (M, K), torch.int8), ("w8", w8, (N, K), torch.int8),
            ("ascale", ascale, (M,), f32), ("wscale", wscale, (N,), f32),
            ("bias", bias, (N,), torch.bfloat16),
            ("r", r, (M, N), torch.bfloat16)):
        if t is None and (name == "r" and epi != "bias_res"
                          or name == "bias" and epi == "acc_s32"):
            continue
        if t is None:
            raise ValueError(f"{epi} reads {name}")
        check_tensor(name, t, shape, dt, dev)
        check_aligned(name, t)
    return M, N, K


def _engine_library() -> ctypes.CDLL:
    lib = _library()
    if lib.mbt_q8_gemm_test.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mbt_q8_gemm_test.argtypes = [i] + [vp] * 7 + [i] * 3 + [vp]
        lib.mbt_q8_gemm_test.restype = i
    return lib


def engine_gemm_q8(epi: str, a8, ascale, w8, wscale, bias,
                   r=None) -> torch.Tensor:
    """One launch of the s8 engine (the W8A8 chain's products, through the
    test entry ``mbt_q8_gemm_test``) on CUDA tensors, counted in
    ``engine_gemm_q8.launches``; ``engine_gemm_q8_plain`` on CPU tensors.
    a8 (M, K) and w8 (N, K) int8, ascale (M,) and wscale (N,) fp32, bias
    (N,) and r (M, N) bf16; out (M, N) bf16, fp32 for "bias_gelu_f32",
    int32 for "acc_s32".
    The chain launches the engine itself; this entry is for the tests and
    chip_smoke.py."""
    if _device_kind(a8, "s8 engine") == "cpu":
        return engine_gemm_q8_plain(epi, a8, ascale, w8, wscale, bias, r)
    M, N, K = check_engine_q8_args(epi, a8, ascale, w8, wscale, bias, r)
    lib = _engine_library()
    dev = a8.device
    with torch.cuda.device(dev):
        out = torch.empty((M, N), device=dev, dtype={
            "bias_gelu_f32": torch.float32, "acc_s32": torch.int32}.get(
                epi, torch.bfloat16))
        rc = lib.mbt_q8_gemm_test(
            Q8_EPILOGUES[epi], a8.data_ptr(), ascale.data_ptr(),
            w8.data_ptr(), wscale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if r is None else r.data_ptr(), out.data_ptr(), M, N, K,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"s8 engine launch failed with CUDA error {rc}")
    engine_gemm_q8.launches += 1
    return out


engine_gemm_q8.launches = 0


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

class FusedPairQ8(torch.autograd.Function):
    """``fused_pair_block_q8`` with the straight-through backward: the bf16
    pair's backward on the saved full-precision inputs."""

    @staticmethod
    def forward(ctx, x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                w1, b1, w2, b2, num_heads, scale, mode):
        params = (ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1,
                  b1, w2, b2)
        ctx.save_for_backward(x, *params)
        ctx.cfg = (num_heads, scale, mode)
        if _device_kind(x) == "cpu":
            return pair_block_q8_plain(x, *params, num_heads, scale, mode)
        out = _launch(x, None, *params, None, None, num_heads, scale, mode)
        fused_pair_block_q8.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        grads = fused_pair_block_bwd(x, g.contiguous(), *params, *ctx.cfg)
        return (*grads, None, None, None)


class FusedGatedPairQ8(torch.autograd.Function):
    """``fused_gated_pair_block_q8`` with the straight-through backward."""

    @staticmethod
    def forward(ctx, x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                ln2_b, w1, b1, w2, b2, wg, bg, num_heads, scale, mode):
        params = (ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1,
                  b1, w2, b2)
        ctx.save_for_backward(x, other, *params, wg, bg)
        ctx.cfg = (num_heads, scale, mode)
        if _device_kind(x) == "cpu":
            return gated_pair_block_q8_plain(x, other, *params, wg, bg,
                                             num_heads, scale, mode)
        out = _launch(x, other, *params, wg, bg, num_heads, scale, mode)
        fused_gated_pair_block_q8.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, other, *rest = ctx.saved_tensors
        grads = fused_gated_pair_block_bwd(x, other, g.contiguous(), *rest,
                                           *ctx.cfg)
        return (*grads, None, None, None)


def fused_pair_block_q8(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                        ln2_b, w1, b1, w2, b2, num_heads: int, scale: float,
                        mode: str) -> torch.Tensor:
    """The W8A8 forward of ``fused_pair_block`` on x (B, F, J, C), same
    arguments: the CUDA int8 chain for a CUDA tensor, the plain version for
    a CPU tensor; the gradients are the bf16 pair's."""
    return FusedPairQ8.apply(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                             ln2_b, w1, b1, w2, b2, num_heads, scale, mode)


fused_pair_block_q8.launches = 0


def fused_gated_pair_block_q8(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj,
                              bproj, ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                              num_heads: int, scale: float,
                              mode: str) -> torch.Tensor:
    """The W8A8 forward of ``fused_gated_pair_block``, same arguments; the
    gate stays in the compute dtype."""
    return FusedGatedPairQ8.apply(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj,
                                  bproj, ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                                  num_heads, scale, mode)


fused_gated_pair_block_q8.launches = 0


# ---------------------------------------------------------------------------
# the pair on shards (B9_tp)
# ---------------------------------------------------------------------------

def all_reduce_group(t: torch.Tensor, group,
                     op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t, in place, reduced with ``op`` over the ranks of ``group`` (nothing
    with None). Exact for both of B9_tp's uses: the maximum, and the sum of
    int32 partial products, none of which nears 2^31."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _quant_cols_tp_plain(ws, groups) -> list:
    """``quant_cols_tp`` in plain PyTorch, weight after weight."""
    return [quant_cols_given_plain(w, all_reduce_group(
        col_amax_plain(w), g, dist.ReduceOp.MAX)) for w, g in zip(ws, groups)]


def quant_cols_tp(ws, groups) -> list:
    """``quant_cols`` of whole weights on a rank's columns of them, each
    w (out, K_r) with its model group in ``groups`` (None: whole): each
    output channel's absolute maximum over the rank's columns, all-reduced
    with MAX over the group (weight after weight, in order), scales every
    rank's columns. [(int8, scale)] a weight. On CUDA tensors two launches
    for all of them, ``col_amax_kernel`` before the all-reduces and
    ``quant_cols_given_kernel`` after (counted once a call in
    ``quant_cols_tp.launches``); the plain split on CPU tensors."""
    if _device_kind(ws[0], "column quantiser") == "cpu":
        return _quant_cols_tp_plain(ws, groups)
    check_quant_cols_args(ws)
    dev = ws[0].device
    with torch.cuda.device(dev):
        amax = [torch.empty((w.shape[0],), dtype=torch.float32, device=dev)
                for w in ws]
        _col_quant(COLQ_AMAX, ws, amax)
        for a, g in zip(amax, groups):
            all_reduce_group(a, g, dist.ReduceOp.MAX)
        out = _col_quant(COLQ_GIVEN, ws, amax)
    quant_cols_tp.launches += 1
    return out


quant_cols_tp.launches = 0


class _PlainTp:
    """B9_tp's stages in plain PyTorch, at ``pair_block_q8_plain``'s
    rounding points: the plain twin."""

    def weights(self, wqkv, wproj, w1, w2, attn_group, mlp_group) -> list:
        return [quant_cols_plain(wqkv), quant_cols_plain(w1),
                *_quant_cols_tp_plain((wproj, w2), (attn_group, mlp_group))]

    def attn(self, x, ln1_w, ln1_b, wqkv8, sqkv, bqkv, heads, scale, mode):
        dt = x.dtype
        a8, ascale = q8_rows(ln_fwd_stats(x, ln1_w, ln1_b)[2])
        qkv = _int_matmul(a8, wqkv8) * ascale * sqkv + bqkv.float()
        ci = wqkv8.shape[0] // 3
        attn = st_attention_plain(qkv[..., :ci].to(dt),
                                  qkv[..., ci:2 * ci].to(dt),
                                  qkv[..., 2 * ci:].to(dt), mode, heads, scale)
        return attn, attn.float().abs().amax(-1)

    def partial(self, src, amax, w8, wscale):
        a8, self.ascale = _quantise(src.float(), amax[..., None],
                                    ROW_AMAX_FLOOR)
        return _int_products(a8, w8)

    def mlp(self, acc, sproj, bproj, x, ln2_w, ln2_b, w18, s1, b1):
        y = (acc.float() * self.ascale * sproj + bproj.float()
             + wide(x)).to(x.dtype)
        a8, ascale = q8_rows(ln_fwd_stats(y, ln2_w, ln2_b)[2])
        z = _int_matmul(a8, w18) * ascale * s1 + b1.float()
        act = 0.5 * z * (1.0 + torch.erf(z * 0.7071067811865476))
        return y, act, act.abs().amax(-1)

    def out(self, acc, s2, b2, y, other, wg, bg):
        out = (acc.float() * self.ascale * s2 + b2.float()
               + wide(y)).to(y.dtype)
        return out if other is None else gate_plain(other, out, wg, bg)


_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# B9_tp's C entries (csrc/pair_q8_kernels.cu) and their argument types
TP_ARGTYPES = {
    "mbt_pair_q8_tp_attn": [_vp] * 11 + [_i] * 6 + [_f, _i, _vp],
    "mbt_pair_q8_tp_partial": [_vp, _i] + [_vp] * 6 + [_i] * 3 + [_vp],
    "mbt_pair_q8_tp_mlp": [_vp] * 14 + [_i] * 3 + [_vp],
    "mbt_pair_q8_tp_out": [_vp] * 9 + [_i] * 2 + [_vp],
}


def _tp_library() -> ctypes.CDLL:
    lib = _library()
    if lib.mbt_pair_q8_tp_attn.argtypes is None:
        for name, argtypes in TP_ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


class _KernelTp:
    """B9_tp's stages on the card: the entries ``mbt_pair_q8_tp_*`` of
    ``csrc/pair_q8_kernels.cu`` over one set of scratch buffers."""

    def __init__(self, x, ci: int, hid_r: int):
        B, F, J, C = x.shape
        self.M, self.C, self.dev = B * F * J, C, x.device
        self.lib = _tp_library()
        self.stream = torch.cuda.current_stream(self.dev).cuda_stream
        new = lambda *shape, dtype: torch.empty(shape, dtype=dtype,
                                                device=self.dev)
        self.a8 = new(self.M, max(C, ci, hid_r), dtype=torch.int8)
        self.ascale = new(self.M, dtype=torch.float32)
        self.amax = new(self.M, dtype=torch.float32)
        self.acc = new(self.M, C, dtype=torch.int32)

    @staticmethod
    def weights(wqkv, wproj, w1, w2, attn_group, mlp_group) -> list:
        return [*quant_cols(wqkv, w1),
                *quant_cols_tp((wproj, w2), (attn_group, mlp_group))]

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"q8 pair on shards: {what} launch failed "
                               f"with CUDA error {rc}")

    def attn(self, x, ln1_w, ln1_b, wqkv8, sqkv, bqkv, heads, scale, mode):
        B, F, J, C = x.shape
        ci = wqkv8.shape[0] // 3
        qkv = torch.empty((self.M, 3 * ci), dtype=x.dtype, device=self.dev)
        attn = torch.empty((self.M, ci), dtype=x.dtype, device=self.dev)
        self._check(self.lib.mbt_pair_q8_tp_attn(
            x.data_ptr(), self.a8.data_ptr(), self.ascale.data_ptr(),
            qkv.data_ptr(), attn.data_ptr(), self.amax.data_ptr(),
            ln1_w.data_ptr(), ln1_b.data_ptr(), wqkv8.data_ptr(),
            sqkv.data_ptr(), bqkv.data_ptr(), B, F, J, C, ci, heads,
            float(scale), int(mode == "temporal"), self.stream), "attention")
        return attn, self.amax

    def partial(self, src, amax, w8, wscale):
        self._check(self.lib.mbt_pair_q8_tp_partial(
            src.data_ptr(), int(src.dtype == torch.float32), amax.data_ptr(),
            self.a8.data_ptr(), self.ascale.data_ptr(), w8.data_ptr(),
            wscale.data_ptr(), self.acc.data_ptr(), self.M, self.C,
            src.shape[-1], self.stream), "partial product")
        return self.acc

    def mlp(self, acc, sproj, bproj, x, ln2_w, ln2_b, w18, s1, b1):
        hid_r = w18.shape[0]
        y = torch.empty_like(x)
        act = torch.empty((self.M, hid_r), dtype=torch.float32,
                          device=self.dev)
        self._check(self.lib.mbt_pair_q8_tp_mlp(
            acc.data_ptr(), self.ascale.data_ptr(), sproj.data_ptr(),
            bproj.data_ptr(), x.data_ptr(), y.data_ptr(), self.a8.data_ptr(),
            ln2_w.data_ptr(), ln2_b.data_ptr(), w18.data_ptr(),
            s1.data_ptr(), b1.data_ptr(), act.data_ptr(),
            self.amax.data_ptr(), self.M, self.C, hid_r, self.stream), "MLP")
        return y, act, self.amax

    def out(self, acc, s2, b2, y, other, wg, bg):
        out = torch.empty_like(y)
        ptr = lambda t: None if t is None else t.data_ptr()
        self._check(self.lib.mbt_pair_q8_tp_out(
            acc.data_ptr(), self.ascale.data_ptr(), s2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), ptr(other), ptr(wg), ptr(bg),
            out.data_ptr(), self.M, self.C, self.stream), "output")
        return out


# the widest C of B9_tp: its row pass after proj holds a row in registers
# (csrc/pair_q8_common.cuh DEQUANT_LN_MAX_STEPS x 128)
TP_MAX_WIDTH = 1024


def check_tp_args(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
                  ln2_b, w1, b1, w2, b2, wg, bg, num_heads: int,
                  mode: str) -> None:
    """Raise ValueError on anything B9_tp does not take: the pair kernels'
    conditions (``check_kernel_args``) with the weights a rank's shards: a
    head group wqkv (3 Ci, C), wproj (C, Ci) of ``num_heads`` local heads
    and a hidden slice w1 (hid_r, C), w2 (C, hid_r), Ci and hid_r multiples
    of 64 (the s8 engine's N and K), Ci / num_heads a head dim of the
    core, C at most TP_MAX_WIDTH."""
    if x.dim() != 4 or wqkv.dim() != 2 or w1.dim() != 2:
        raise ValueError("x must be (B, F, J, C) and the weights 2-D")
    B, F, J, C = x.shape
    ci, hid_r = wqkv.shape[0] // 3, w1.shape[0]
    if mode not in ("spatial", "temporal"):
        raise ValueError(f"unknown attention mode: {mode!r}")
    if J != NUM_JOINTS or not 1 <= F <= MAX_FRAMES:
        raise ValueError(f"the pair kernel takes J={NUM_JOINTS} joints and "
                         f"1..{MAX_FRAMES} frames, got J={J}, F={F}")
    if C % 64 or C > TP_MAX_WIDTH or ci % 64 or hid_r % 64 \
            or num_heads < 1 or ci % num_heads \
            or ci // num_heads not in HEAD_DIMS:
        raise ValueError(f"the W8A8 pair on shards takes C % 64 == 0 up to "
                         f"{TP_MAX_WIDTH}, a head group of Ci % 64 == 0 "
                         f"channels with a head dim in {HEAD_DIMS} and a "
                         f"hidden slice % 64 == 0, got C={C}, Ci={ci}, "
                         f"heads={num_heads}, hidden slice={hid_r}")
    limit = core_max_rows(num_heads)
    if not 1 <= B * F * J <= limit:
        raise ValueError(f"the pair kernel takes 1..{limit} token rows "
                         f"(B*F*J) at {num_heads} heads, got {B * F * J}")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    check_tensor("x", x, (B, F, J, C), bf16, dev)
    if other is not None:
        check_tensor("other", other, (B, F, J, C), bf16, dev)
        check_tensor("wg", wg, (2, 2 * C), bf16, dev)
        check_tensor("bg", bg, (2,), bf16, dev)
    for name, t in (("ln1_w", ln1_w), ("ln1_b", ln1_b), ("ln2_w", ln2_w),
                    ("ln2_b", ln2_b)):
        check_tensor(name, t, (C,), f32, dev)
    for name, t, shape in (
            ("wqkv", wqkv, (3 * ci, C)), ("bqkv", bqkv, (3 * ci,)),
            ("wproj", wproj, (C, ci)), ("bproj", bproj, (C,)),
            ("w1", w1, (hid_r, C)), ("b1", b1, (hid_r,)),
            ("w2", w2, (C, hid_r)), ("b2", b2, (C,))):
        check_tensor(name, t, shape, bf16, dev)
    for name, t in (("x", x), ("other", other), ("bqkv", bqkv),
                    ("bproj", bproj), ("b1", b1), ("b2", b2), ("wg", wg),
                    ("bg", bg)):
        if t is not None:
            check_aligned(name, t)


def _q8_tp(stages, x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w,
           ln2_b, w1, b1, w2, b2, wg, bg, num_heads, scale, mode, attn_group,
           mlp_group) -> torch.Tensor:
    """B9_tp's stages with the collectives between them (module note)."""
    (wqkv8, sqkv), (w18, s1), (wproj8, sproj), (w28, s2) = stages.weights(
        wqkv, wproj, w1, w2, attn_group, mlp_group)
    attn, amax = stages.attn(x, ln1_w, ln1_b, wqkv8, sqkv, bqkv, num_heads,
                             scale, mode)
    MAX = dist.ReduceOp.MAX
    acc = stages.partial(attn, all_reduce_group(amax, attn_group, MAX),
                         wproj8, sproj)
    y, act, amax = stages.mlp(all_reduce_group(acc, attn_group), sproj,
                              bproj, x, ln2_w, ln2_b, w18, s1, b1)
    acc = stages.partial(act, all_reduce_group(amax, mlp_group, MAX), w28, s2)
    return stages.out(all_reduce_group(acc, mlp_group), s2, b2, y, other, wg,
                      bg)


def pair_block_q8_tp_plain(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                           ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                           num_heads: int, scale: float, mode: str,
                           attn_group=None, mlp_group=None) -> torch.Tensor:
    """The plain twin of ``fused_pair_block_q8_tp``: on a rank's shards
    (module note), with the model group's collectives, ``pair_block_q8_plain``
    (gated: ``gated_pair_block_q8_plain``) of the whole weights bit for
    bit. other None: the ungated pair. Every rank of the groups calls it."""
    return _q8_tp(_PlainTp(), x, other, ln1_w, ln1_b, wqkv, bqkv, wproj,
                  bproj, ln2_w, ln2_b, w1, b1, w2, b2, wg, bg, num_heads,
                  scale, mode, attn_group, mlp_group)


def fused_pair_block_q8_tp(x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj,
                           ln2_w, ln2_b, w1, b1, w2, b2, wg, bg,
                           num_heads: int, scale: float, mode: str,
                           attn_group=None, mlp_group=None) -> torch.Tensor:
    """B9_tp: the W8A8 pair (other None) or gated pair on a model rank's
    shards, ``num_heads`` the local heads, with the collectives over
    ``attn_group`` / ``mlp_group`` (None: that half's weights are whole).
    The CUDA stages for a CUDA tensor (counted once a call in
    ``fused_pair_block_q8_tp.launches``), the plain twin for a CPU tensor.
    Forward only: ``parallel.tensor.TpPairsQ8`` gives it the straight-through
    backward. Every rank of the groups calls it."""
    args = (x, other, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2, wg, bg, num_heads, scale, mode)
    if _device_kind(x, "q8 pair on shards") == "cpu":
        return pair_block_q8_tp_plain(*args, attn_group, mlp_group)
    check_tp_args(*args[:17], mode)
    with torch.cuda.device(x.device):
        out = _q8_tp(_KernelTp(x, wqkv.shape[0] // 3, w1.shape[0]), *args,
                     attn_group, mlp_group)
    fused_pair_block_q8_tp.launches += 1
    return out


fused_pair_block_q8_tp.launches = 0
