// The W8A8 DSTformer pair for NVIDIA Hopper (sm_90a): the four projections as
// int8 x int8 -> int32 tensor-core products with per-row activation scales and
// per-output-channel weight scales, the attention core and the gate in bf16.
// Built by motionbert_tpu_torch/ops/_build.py with nvcc and bound through a
// plain C interface (ctypes); see ops/pair_q8.py.
//
// Replaces the TPU kernel
//   motionbert_tpu/ops/pair_q8.py:_q8_launch  (_pair_q8_kernel, _gated_pair_q8_kernel;
//                                              body _pair_rows_q8)
// which computes, per token row of x (B, F, J, C), with
// qdot(a, W) = (q8(a) . W8^T) * row_scale(a) * col_scale(W):
//   qkv = qdot(LN1(x), Wqkv) + bqkv          LN output fp32 into the quantiser
//   yb  = bf16(qdot(attn(qkv), Wproj) + bproj + x)    q, k, v, attn in bf16
//   out = bf16(qdot(GELU(qdot(LN2(yb), W1) + b1), W2) + b2 + yb)
//   gated: the bf16 pair's att_fuse gate on (other, out).
//
// Design. The TPU body keeps the int8 weights and a whole row block in VMEM
// and quantises rows in place. A Hopper block sees one tile, and a row's scale
// needs the whole row's absolute maximum before any product of that row can
// start, so quantisation gets passes of its own and the pair runs as a chain
// of nine launches (ten when gated) over the flattened rows (M = B*F*J):
//   1. ln_quant_rows          a8, s = q8(LN1(x))             a warp per row, LN in fp32
//   2. hg_gemm_s8<BIAS>       qkv  = bf16(deq + bqkv)
//   3. attn_tc_fwd_kernel     attn = bf16(bf16(P) v)         (attention_tc.cuh)
//   4. quant_rows<bf16>       a8, s = q8(attn)
//   5. hg_gemm_s8<BIAS_RES>   yb   = bf16(deq + bproj + x)
//   6. ln_quant_rows          a8, s = q8(LN2(yb))
//   7. hg_gemm_s8<GELU_F32>   act  = GELU(deq + b1), fp32, to device memory
//   8. quant_rows<float>      a8, s = q8(act)
//   9. hg_gemm_s8<BIAS_RES>   out  = bf16(deq + b2 + yb)
//  10. gate                   (gated only; pair_common.cuh)
// hg_gemm_s8 (hopper_gemm_s8.cuh) is the wgmma + TMA engine of the bf16
// chains with m64n128k32 s8 wgmmas and int32 accumulators; int32 sums are
// exact, and the epilogue dequantises as ((acc * row_scale) * col_scale) +
// bias in fp32, without fused multiply-adds, the order the plain version
// takes. The core is the bf16 chains' tensor-core forward on the packed qkv
// (tc_packed_args): fp32 scores, P = exp(S - max) times the row's fp32
// reciprocal sum, rounded to bf16 before P.v. Nothing between launches is
// rounded more than the TPU kernel rounds it: LN output goes straight into
// the quantiser inside one kernel, GELU(z) is spilled in fp32, and qkv, attn
// and yb are bf16 where the TPU kernel rounds them to bf16 as well. The
// quantiser divides by the scale (a / s, then round half to even), as the TPU
// kernel does. LN statistics and GELU use this card's rsqrtf / erff and their
// own summation order, the core's P is one fp32 rounding from the plain
// version's division, so a value that lies within an ulp of a rounding
// boundary can land one int8 or bf16 step from the plain version's: the two
// agree to a tolerance, not bit for bit.
//
// Bound. At the flagship shape (4, 243, 17, 512), hidden 1024, the four
// products are 69.3 GOP of the pair's 77.5 (temporal) or 69.9 (spatial); at
// the H100's int8 peak (1,979 TOP/s) plus the core at the bf16 peak (989
// TFLOP/s) that is about 0.043 ms temporal and 0.036 ms spatial, against
// 0.011 ms for the 36 MB of x, out and weights: bound by operations. The
// chain passes a8, qkv, attn, yb and the fp32 activation through device
// memory: ~27.7 KB read and written per token row, 0.136 ms at 3.35 TB/s at
// that shape, so this design's own floor is bytes, about three times the
// function's bound; fusing a quantiser into the epilogue before it (which
// needs the whole row's maximum) or keeping the activation on chip is the
// lever past it. Measured times are in PERF.md (kernel B9).
//
// The weights reach the chain quantised: one launch of quant_cols_kernel
// (mbt_quant_cols) takes all four per call, as the TPU kernel's wrapper
// quantises them outside its pallas_call (W8A8 stream: both pairs' eight).
// The quantisers and the chain (q8_pair_chain) live in pair_q8_common.cuh,
// which the W8A8 stream (stream_kernels.cu) shares.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include "pair_q8_common.cuh"

// One W8A8 pair (other == nullptr) or gated pair on x (B, F, J, C) bf16. The
// weights arrive quantised: w*8 int8 in nn.Linear layout (out, in) with fp32
// scales s* (out,); biases bf16, LayerNorm parameters fp32. Scratch from the
// caller: a8 (M, max(C, hidden)) int8, ascale (M,) fp32, qkv (M, 3C), attn
// (M, C), y (M, C) bf16, act (M, hidden) fp32, and pair_out (M, C) bf16 when
// gated. Returns 0 or the first CUDA error.
extern "C" int mbt_pair_block_q8(
    const void* x, const void* other, void* out,
    void* a8, void* ascale, void* qkv, void* attn, void* y, void* act, void* pair_out,
    const void* ln1_w, const void* ln1_b,
    const void* wqkv8, const void* sqkv, const void* bqkv,
    const void* wproj8, const void* sproj, const void* bproj,
    const void* ln2_w, const void* ln2_b,
    const void* w18, const void* s1, const void* b1,
    const void* w28, const void* s2, const void* b2,
    const void* wg, const void* bg,
    int B, int F, int J, int C, int H, int hidden, float scale, int temporal,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const bool gated = other != nullptr;
    const PairQ8Params p{ln1_w, ln1_b, wqkv8, sqkv, bqkv, wproj8, sproj, bproj,
                         ln2_w, ln2_b, w18, s1, b1, w28, s2, b2};
    cudaError_t err = q8_pair_chain(x, gated ? pair_out : out, a8, ascale, qkv, attn, y, act,
                                    p, B, F, J, C, H, hidden, scale, temporal, stream);
    if (err != cudaSuccess) return (int)err;
    if (gated) err = launch_gate(other, pair_out, wg, bg, out, B * F * J, C, stream);
    return (int)err;
}

// ---------------------------------------------------------------------------
// The weight quantisers (ops/pair_q8.py quant_cols, quant_cols_tp): mode 0
// quant_cols_kernel on n weights, 1 col_amax_kernel (a rank's maxima into
// amax), 2 quant_cols_given_kernel (with amax after the caller's MAX
// all-reduce); one launch for the n <= COLQ_MAX weights (pair_q8_common.cuh).
// Weight e: src[e] (rows[e], K[e]), bf16 or fp32 (src_f32[e] 1), into q8[e]
// (rows[e], K[e]) int8 and scale[e] (rows[e],) fp32; amax may be null in
// mode 0, q8 and scale in mode 1. K % 4 == 0, 8-byte-aligned bf16 or
// 16-byte-aligned fp32 rows. Returns 0 or the CUDA error.
// ---------------------------------------------------------------------------

extern "C" int mbt_quant_cols(int mode, int n, const void* const* src, const int* src_f32,
                              void* const* q8, void* const* scale, void* const* amax,
                              const int* rows, const int* K, void* stream_ptr) {
    if (n < 1 || n > COLQ_MAX) return (int)cudaErrorInvalidValue;
    ColQuantTable t{};
    t.n = n;
    for (int e = 0; e < n; ++e) {
        t.src[e] = src[e];
        t.f32[e] = src_f32[e];
        t.q8[e] = q8 != nullptr ? q8[e] : nullptr;
        t.scale[e] = scale != nullptr ? scale[e] : nullptr;
        t.amax[e] = amax != nullptr ? amax[e] : nullptr;
        t.K[e] = K[e];
        t.first[e + 1] = t.first[e] + rows[e];
    }
    return (int)launch_col_quant(mode, t, static_cast<cudaStream_t>(stream_ptr));
}

// ---------------------------------------------------------------------------
// B9_tp: the W8A8 pair on a model rank's shards (ops/pair_q8.py
// fused_pair_block_q8_tp). A rank holds a head group of the attention (wqkv
// rows 3 Ci, wproj columns Ci, Hl heads) and a hidden slice of the MLP (w1
// rows hid_r, w2 columns hid_r), x is replicated. Before the entries the
// caller quantises the weights: wqkv and w1 whole (quant_cols_kernel, one
// launch), wproj and w2 split (col_amax_kernel, the MAX all-reduce of each
// over its group, quant_cols_given_kernel: two launches). Four entries, with
// the caller's collectives over the model ranks between them:
//   mbt_pair_q8_tp_attn      ln_quant_rows (whole C; amax zeroed),
//                            hg_gemm_s8<BIAS> qkv_r, the core on the local
//                            heads, its store taking the row maxima of attn_r
//       all-reduce MAX of the row maxima (M floats)
//   mbt_pair_q8_tp_partial   quant_rows_given(attn_r), hg_gemm_s8<ACC_S32>
//       all-reduce SUM of the int32 partials (M x C)
//   mbt_pair_q8_tp_mlp       dequant_ln_quant_rows (y = bf16(deq + bproj +
//                            x) written, LN2(y) quantised from the
//                            registers; amax zeroed), hg_gemm_s8<GELU_F32,
//                            AMAX> act_r with its row maxima
//       all-reduce MAX
//   mbt_pair_q8_tp_partial   quant_rows_given(act_r), hg_gemm_s8<ACC_S32>
//       all-reduce SUM
//   mbt_pair_q8_tp_out       dequant_rows (out = bf16(deq + b2 + y)), or
//                            gated dequant_gate_rows (the gate on the
//                            dequantised row, never stored)
// 10 launches a call besides the weights' 3. Every row scale is the whole
// row's, every column scale the whole column's, every int32 sum the whole
// product's (exact: 127^2 K stays below 2^31 for K up to 133,000), and each
// row pass dequantises with q8_dequant4<Q8_BIAS_RES>'s operations and keeps
// the lane order and arithmetic of the passes it replaced (ln_quant_rows,
// gate_kernel): the output is B9's bit for bit at any model size T.
//
// Bound and design. At the flagship's rows on shards of 2 the function must
// move x, the output, the weights' shards and each int32 partial (M x C)
// written for the all-reduce and read back summed: 4 x 33.8 MB of its ~172
// MB, 0.0511 ms at 3.35 TB/s; bit-exactness needs the partials, so they
// stay. What the design keeps off device memory: the row maxima ride in the
// producers' epilogues (no pass re-reads attn_r or the fp32 act_r for
// them), y goes from the dequantise into LN2 in registers, the gated pair's
// output goes from the dequantise into the gate, and the weight quantisers
// take one launch for all weights of a pass instead of PyTorch operators.
// The one atomic of this file: the row maxima's atomicMax, whose order does
// not change a maximum. The quantise of attn_r and act_r stays a pass of
// its own: its scale needs the all-reduced maximum.
// Scratch: a8 (M, max(C, Ci, hid_r)) int8, ascale and amax (M,) fp32, qkv
// (M, 3 Ci) and attn (M, Ci) bf16, acc (M, C) int32, y (M, C) bf16, act
// (M, hid_r) fp32. Ci, hid_r and C are multiples of 64 (the s8 engine's N
// and K), C <= 1024 (dequant_ln_quant_rows holds a row in registers).
// ---------------------------------------------------------------------------

// 3 launches. Writes a8 / ascale (LN1's rows, whole), qkv, attn and amax.
extern "C" int mbt_pair_q8_tp_attn(
    const void* x, void* a8, void* ascale, void* qkv, void* attn, void* amax,
    const void* ln1_w, const void* ln1_b, const void* wqkv8, const void* sqkv,
    const void* bqkv, int B, int F, int J, int C, int Ci, int Hl, float scale, int temporal,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = B * F * J;
    cudaError_t err = launch_ln_quant(x, ln1_w, ln1_b, a8, ascale, M, C, stream,
                                      static_cast<float*>(amax));
    if (err != cudaSuccess) return (int)err;
    err = hg_gemm_s8<Q8_BIAS>(a8, ascale, wqkv8, sqkv, bqkv, nullptr, qkv, M, 3 * Ci, C,
                              stream);
    if (err != cudaSuccess) return (int)err;
    TcArgs core = tc_packed_args(qkv, B, F, J, Ci, Hl, scale, temporal);
    core.out = attn;
    core.ld_out = Ci;
    core.amax = static_cast<float*>(amax);
    return (int)launch_attention_tc(core, false, stream);
}

// 2 launches: src (M, K), bf16 (src_f32 0) or fp32, quantised with the
// all-reduced row maxima amax, times w8 (N, K): acc (M, N) int32, this
// rank's partial. ascale gets the rows' scales.
extern "C" int mbt_pair_q8_tp_partial(const void* src, int src_f32, const void* amax,
                                      void* a8, void* ascale, const void* w8,
                                      const void* wscale, void* acc, int M, int N, int K,
                                      void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err = src_f32
        ? launch_quant_rows_given<float>(src, amax, a8, ascale, M, K, stream)
        : launch_quant_rows_given<bf16>(src, amax, a8, ascale, M, K, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)hg_gemm_s8<Q8_ACC_S32>(a8, ascale, w8, wscale, nullptr, nullptr, acc, M, N, K,
                                       stream);
}

// 2 launches: y from the summed proj products and LN2's quantised rows in
// one pass, then fc1 on the rank's slice with its rows' maxima. ascale holds
// the proj input's scales on entry and LN2's rows' on exit.
extern "C" int mbt_pair_q8_tp_mlp(
    const void* acc, void* ascale, const void* sproj, const void* bproj, const void* x, void* y,
    void* a8, const void* ln2_w, const void* ln2_b, const void* w18, const void* s1,
    const void* b1, void* act, void* amax, int M, int C, int hid_r, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err = launch_dequant_ln_quant(acc, ascale, sproj, bproj, x, y, ln2_w, ln2_b, a8,
                                              amax, M, C, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)hg_gemm_s8<Q8_BIAS_GELU_F32, true>(a8, ascale, w18, s1, b1, nullptr, act, M,
                                                   hid_r, C, stream,
                                                   static_cast<float*>(amax));
}

// 1 launch: out = bf16(deq(acc) + b2 + y), or with other not null the gate
// of other against it.
extern "C" int mbt_pair_q8_tp_out(const void* acc, const void* ascale, const void* s2,
                                  const void* b2, const void* y, const void* other,
                                  const void* wg, const void* bg, void* out, int M, int C,
                                  void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (other != nullptr)
        return (int)launch_dequant_gate(acc, ascale, s2, b2, y, other, wg, bg, out, M, C,
                                        stream);
    return (int)launch_dequant_rows(acc, ascale, s2, b2, y, out, M, C, stream);
}

// The int8 engine alone (ops/pair_q8.py engine_gemm_q8, tests and
// chip_smoke.py): one hg_gemm_s8 launch with epilogue epi (Q8Epilogue) on
// A8 (M, K) and W8 (N, K) int8, ascale (M,) and wscale (N,) fp32, bias (N,)
// bf16 and R (M, N) bf16 for Q8_BIAS_RES; out (M, N) bf16, fp32 for
// Q8_BIAS_GELU_F32, int32 for Q8_ACC_S32. Returns 0 or the CUDA error.
extern "C" int mbt_q8_gemm_test(int epi, const void* A, const void* ascale, const void* W,
                                const void* wscale, const void* bias, const void* R,
                                void* out, int M, int N, int K, void* stream_ptr) {
    cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    switch (epi) {
        case Q8_BIAS:
            return (int)hg_gemm_s8<Q8_BIAS>(A, ascale, W, wscale, bias, R, out, M, N, K, s);
        case Q8_BIAS_RES:
            return (int)hg_gemm_s8<Q8_BIAS_RES>(A, ascale, W, wscale, bias, R, out, M, N, K, s);
        case Q8_BIAS_GELU_F32:
            return (int)hg_gemm_s8<Q8_BIAS_GELU_F32>(A, ascale, W, wscale, bias, R, out, M, N,
                                                     K, s);
        case Q8_ACC_S32:
            return (int)hg_gemm_s8<Q8_ACC_S32>(A, ascale, W, wscale, bias, R, out, M, N, K, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
