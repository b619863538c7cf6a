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

// The int8 engine alone (ops/pair_q8.py engine_gemm_q8, tests and
// chip_smoke.py): one hg_gemm_s8 launch with epilogue epi (Q8Epilogue) on
// A8 (M, K) and W8 (N, K) int8, ascale (M,) and wscale (N,) fp32, bias (N,)
// bf16 and R (M, N) bf16 for Q8_BIAS_RES; out (M, N) bf16, or fp32 for
// Q8_BIAS_GELU_F32. Returns 0 or the CUDA error.
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
        default:
            return (int)cudaErrorInvalidValue;
    }
}
