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

Weight quantisation runs per call, in plain PyTorch outside the kernel, as in
the JAX package: the model hands each pair a fresh cast of its fp32
parameters, so there is no weight version to key a cache on at this level.
Its cost is part of every time measured for the wrappers (PERF.md, B9).

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

Source note. The CUDA chain replaces the TPU kernel
``motionbert_tpu/ops/pair_q8.py:_q8_launch`` (``_pair_q8_kernel``,
``_gated_pair_q8_kernel``, body ``_pair_rows_q8``). Bound and design are in
the note at the top of the ``.cu`` file.
"""

from __future__ import annotations

import ctypes

import torch

from motionbert_tpu_torch.ops import _build
from motionbert_tpu_torch.ops.attention import (
    ENGINE_MAX_ROWS, check_aligned, check_tensor, ln_fwd_stats,
    st_attention_plain, wide)
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


def quant_cols(w: torch.Tensor) -> tuple:
    """Per-output-channel symmetric int8 of an nn.Linear weight (out, in):
    (int8 (out, in), fp32 scale (out,)), one scale per row of the stored
    weight."""
    wf = w.float()
    q, scale = _quantise(wf, wf.abs().amax(1, keepdim=True), COL_AMAX_FLOOR)
    return q, scale.reshape(-1)


def _int_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact a8 (..., K) . w8 (N, K)^T as fp32 values (see the module note)."""
    dt = torch.float32 if a8.shape[-1] <= EXACT_FP32_K else torch.float64
    return torch.matmul(a8.to(dt), w8.to(dt).t()).float()


def qdot_plain(a: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Quantise the fp32 rows of ``a`` and the weight (out, in), take the
    integer product, dequantise and add the bias: fp32 rows (..., out)."""
    a8, ascale = q8_rows(a)
    w8, wscale = quant_cols(w)
    return _int_matmul(a8, w8) * ascale * wscale + bias.float()


# the s8 engine's epilogues (csrc/hopper_gemm.cuh's Q8Epilogue)
Q8_EPILOGUES = {"bias": 0, "bias_res": 1, "bias_gelu_f32": 2}


def engine_gemm_q8_plain(epi: str, a8, ascale, w8, wscale, bias,
                         r=None) -> torch.Tensor:
    """The s8 engine's function (``Q8_EPILOGUES``): the exact integer
    product a8 (M, K) . w8 (N, K)^T dequantised as ((acc * ascale[m]) *
    wscale[n]) + bias[n] in fp32, one rounding at a time, as ``qdot_plain``
    takes it; "bias_res" adds r (M, N); both round once to bias's dtype.
    "bias_gelu_f32" returns the fp32 GELU of the sum, as
    ``pair_block_q8_plain`` takes it."""
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
        (wqkv8, sqkv), (wproj8, sproj), (w18, s1), (w28, s2) = (
            quant_cols(w) for w in (wqkv, wproj, w1, w2))
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
        if t is None and name == "r" and epi != "bias_res":
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
    (N,) and r (M, N) bf16; out (M, N) bf16, or fp32 for "bias_gelu_f32".
    The chain launches the engine itself; this entry is for the tests and
    chip_smoke.py."""
    if _device_kind(a8, "s8 engine") == "cpu":
        return engine_gemm_q8_plain(epi, a8, ascale, w8, wscale, bias, r)
    M, N, K = check_engine_q8_args(epi, a8, ascale, w8, wscale, bias, r)
    lib = _engine_library()
    dev = a8.device
    with torch.cuda.device(dev):
        out = torch.empty((M, N), device=dev, dtype=torch.float32
                          if epi == "bias_gelu_f32" else torch.bfloat16)
        rc = lib.mbt_q8_gemm_test(
            Q8_EPILOGUES[epi], a8.data_ptr(), ascale.data_ptr(),
            w8.data_ptr(), wscale.data_ptr(), bias.data_ptr(),
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
