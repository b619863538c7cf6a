// Shared device code of the W8A8 DSTformer pair (pair_q8_kernels.cu) and the
// W8A8 stream (stream_kernels.cu), for NVIDIA Hopper (sm_90a): the per-row
// quantisers (ln_quant_rows_kernel, quant_rows_kernel) and the pair's chain
// of nine launches (q8_pair_chain), whose products run on the int8 engine
// (hopper_gemm_s8.cuh) and whose attention core is the tensor-core forward
// (attention_tc.cuh). The scheme, the rounding points and the bound are in
// the note at the top of pair_q8_kernels.cu.
//
// Everything is in an anonymous namespace, as in pair_common.cuh: each .cu
// that includes this file builds into its own shared library with its own
// copy.

#pragma once

#include "attention_tc.cuh"
#include "hopper_gemm_s8.cuh"

namespace {

constexpr float INV127 = 0.007874015718698502f;  // float(1 / 127)
constexpr float ROW_AMAX_FLOOR = 1e-6f;

__device__ __forceinline__ float row_scale(float amax) {
    return __fmul_rn(fmaxf(amax, ROW_AMAX_FLOOR), INV127);
}

__device__ __forceinline__ signed char quantise(float v, float scale) {
    const float q = rintf(__fdiv_rn(v, scale));
    return (signed char)(int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
}

__device__ __forceinline__ void store_q4(signed char* dst, const float v[4], float scale) {
    char4 q;
    q.x = quantise(v[0], scale);
    q.y = quantise(v[1], scale);
    q.z = quantise(v[2], scale);
    q.w = quantise(v[3], scale);
    *reinterpret_cast<char4*>(dst) = q;
}

// Per-row symmetric int8 of src (M, K), a warp per row: the row's absolute
// maximum, then q = clip(rint(v / scale)). The row is read twice (the second
// time from cache). K % 4 == 0.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
quant_rows_kernel(const T* __restrict__ src, signed char* __restrict__ a8,
                  float* __restrict__ ascale, int M, int K) {
    const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const T* s = src + (size_t)row * K;
    float v[4];
    float amax = 0.f;
    for (int k = lane * 4; k < K; k += 128) {
        load4(s + k, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) amax = fmaxf(amax, fabsf(v[t]));
    }
    const float scale = row_scale(warp_max(amax));
    if (lane == 0) ascale[row] = scale;
    signed char* dst = a8 + (size_t)row * K;
    for (int k = lane * 4; k < K; k += 128) {
        load4(s + k, v);
        store_q4(dst + k, v, scale);
    }
}

__device__ __forceinline__ void ln4(const bf16* row, const float* ln_w, const float* ln_b,
                                    int k, float mean, float rstd, float h[4]) {
    load4(row + k, h);
    const float4 w = *reinterpret_cast<const float4*>(ln_w + k);
    const float4 b = *reinterpret_cast<const float4*>(ln_b + k);
    h[0] = (h[0] - mean) * rstd * w.x + b.x;
    h[1] = (h[1] - mean) * rstd * w.y + b.y;
    h[2] = (h[2] - mean) * rstd * w.z + b.z;
    h[3] = (h[3] - mean) * rstd * w.w + b.w;
}

// LayerNorm of x (M, K) bf16 (fp32 statistics, var = E[x^2] - mean^2, eps
// 1e-6, fp32 output) followed by the per-row quantiser, a warp per row. The
// fp32 LN output never leaves the registers: one pass for the statistics, one
// for the absolute maximum, one that quantises.
__global__ void __launch_bounds__(ROW_THREADS)
ln_quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, signed char* __restrict__ a8,
                     float* __restrict__ ascale, int M, int K) {
    const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const bf16* xr = x + (size_t)row * K;
    float v[4];
    float s = 0.f, ss = 0.f;
    for (int k = lane * 4; k < K; k += 128) {
        load4(xr + k, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            s += v[t];
            ss += v[t] * v[t];
        }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / K;
    const float rstd = rsqrtf(ss / K - mean * mean + LN_EPS);
    float amax = 0.f;
    for (int k = lane * 4; k < K; k += 128) {
        ln4(xr, ln_w, ln_b, k, mean, rstd, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) amax = fmaxf(amax, fabsf(v[t]));
    }
    const float scale = row_scale(warp_max(amax));
    if (lane == 0) ascale[row] = scale;
    signed char* dst = a8 + (size_t)row * K;
    for (int k = lane * 4; k < K; k += 128) {
        ln4(xr, ln_w, ln_b, k, mean, rstd, v);
        store_q4(dst + k, v, scale);
    }
}

inline int row_blocks(int M) { return (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32); }

cudaError_t launch_ln_quant(const void* x, const void* ln_w, const void* ln_b, void* a8,
                            void* ascale, int M, int K, cudaStream_t stream) {
    ln_quant_rows_kernel<<<row_blocks(M), ROW_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), static_cast<signed char*>(a8),
        static_cast<float*>(ascale), M, K);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quant_rows(const void* src, void* a8, void* ascale, int M, int K,
                              cudaStream_t stream) {
    quant_rows_kernel<T><<<row_blocks(M), ROW_THREADS, 0, stream>>>(
        static_cast<const T*>(src), static_cast<signed char*>(a8),
        static_cast<float*>(ascale), M, K);
    return cudaGetLastError();
}

// The 16 parameters of one quantised pair, in the order of the TPU kernel's
// operands: LayerNorm parameters fp32, int8 weights (out, in) with their fp32
// per-output-channel scales (out,), biases bf16.
struct PairQ8Params {
    const void *ln1_w, *ln1_b, *wqkv8, *sqkv, *bqkv, *wproj8, *sproj, *bproj,
               *ln2_w, *ln2_b, *w18, *s1, *b1, *w28, *s2, *b2;
};

// One W8A8 pair's chain of nine launches (pair_q8_kernels.cu's note): out =
// pair(x), with scratch a8 (M, max(C, hidden)) int8, ascale (M,) fp32, qkv
// (M, 3C), attn (M, C), y (M, C) bf16 and act (M, hidden) fp32. The four
// products run on the int8 engine, which reads a8 and the int8 weights
// through TMA (16-byte-aligned bases and rows: hg_gemm_s8 returns
// cudaErrorInvalidValue otherwise), and the core on the tensor-core forward,
// which reads the packed qkv with 16-byte cp.async. x is read by the first
// and fifth launch only, so out may alias x's buffer once they have run (the
// stream chain, stream_kernels.cu).
cudaError_t q8_pair_chain(const void* x, void* out, void* a8, void* ascale, void* qkv,
                          void* attn, void* y, void* act, const PairQ8Params& p, int B,
                          int F, int J, int C, int H, int hidden, float scale, int temporal,
                          cudaStream_t stream) {
    const int M = B * F * J;
    cudaError_t err;
    err = launch_ln_quant(x, p.ln1_w, p.ln1_b, a8, ascale, M, C, stream);
    if (err != cudaSuccess) return err;
    err = hg_gemm_s8<Q8_BIAS>(a8, ascale, p.wqkv8, p.sqkv, p.bqkv, nullptr, qkv, M, 3 * C, C,
                              stream);
    if (err != cudaSuccess) return err;
    TcArgs core = tc_packed_args(qkv, B, F, J, C, H, scale, temporal);
    core.out = attn;
    core.ld_out = C;
    err = launch_attention_tc(core, false, stream);
    if (err != cudaSuccess) return err;
    err = launch_quant_rows<bf16>(attn, a8, ascale, M, C, stream);
    if (err != cudaSuccess) return err;
    err = hg_gemm_s8<Q8_BIAS_RES>(a8, ascale, p.wproj8, p.sproj, p.bproj, x, y, M, C, C,
                                  stream);
    if (err != cudaSuccess) return err;
    err = launch_ln_quant(y, p.ln2_w, p.ln2_b, a8, ascale, M, C, stream);
    if (err != cudaSuccess) return err;
    err = hg_gemm_s8<Q8_BIAS_GELU_F32>(a8, ascale, p.w18, p.s1, p.b1, nullptr, act, M, hidden,
                                       C, stream);
    if (err != cudaSuccess) return err;
    err = launch_quant_rows<float>(act, a8, ascale, M, hidden, stream);
    if (err != cudaSuccess) return err;
    return hg_gemm_s8<Q8_BIAS_RES>(a8, ascale, p.w28, p.s2, p.b2, y, out, M, C, hidden,
                                   stream);
}

}  // namespace
