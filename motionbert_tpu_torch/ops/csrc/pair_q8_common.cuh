// Shared device code of the W8A8 DSTformer pair (pair_q8_kernels.cu) and the
// W8A8 stream (stream_kernels.cu), for NVIDIA Hopper (sm_90a): the per-row
// quantisers (ln_quant_rows_kernel, quant_rows_kernel and its second half
// for the pair on shards), the per-output-channel weight quantisers
// (quant_cols_kernel and its split, col_amax_kernel and
// quant_cols_given_kernel), the pair's chain of nine launches
// (q8_pair_chain), whose products run on the int8 engine
// (hopper_gemm_s8.cuh) and whose attention core is the tensor-core forward
// (attention_tc.cuh), and the dequantising row passes of the pair on shards
// (dequant_rows_kernel, dequant_ln_quant_rows_kernel,
// dequant_gate_rows_kernel). The scheme, the rounding points and the bound
// are in the note at the top of pair_q8_kernels.cu.
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
constexpr float COL_AMAX_FLOOR = 1e-8f;

// A quantiser's scale from its absolute maximum: max(amax, floor) / 127 as
// one fp32 multiply by float(1 / 127), as the plain versions take it.
__device__ __forceinline__ float q8_scale(float amax, float floor) {
    return __fmul_rn(fmaxf(amax, floor), INV127);
}

__device__ __forceinline__ float row_scale(float amax) {
    return q8_scale(amax, ROW_AMAX_FLOOR);
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

// The absolute maximum of one row's K values (lane-strided, K % 4 == 0),
// reduced over the warp: every lane holds it.
template <typename T>
__device__ __forceinline__ float row_amax(const T* __restrict__ s, int K, int lane) {
    float v[4];
    float amax = 0.f;
    for (int k = lane * 4; k < K; k += 128) {
        load4(s + k, v);
#pragma unroll
        for (int t = 0; t < 4; ++t) amax = fmaxf(amax, fabsf(v[t]));
    }
    return warp_max(amax);
}

// One row's K values quantised with scale: q = clip(rint(v / scale)).
template <typename T>
__device__ __forceinline__ void quant_row(const T* __restrict__ s, float scale,
                                          signed char* __restrict__ dst, int K, int lane) {
    float v[4];
    for (int k = lane * 4; k < K; k += 128) {
        load4(s + k, v);
        store_q4(dst + k, v, scale);
    }
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
    const float scale = row_scale(row_amax(s, K, lane));
    if (lane == 0) ascale[row] = scale;
    quant_row(s, scale, a8 + (size_t)row * K, K, lane);
}

// quant_rows_kernel's second half for the W8A8 pair on shards (B9_tp),
// whose rank holds K of a row's columns: the row maxima over the rank's
// columns come from the producer's epilogue (attention_tc.cuh's tc_store,
// hopper_gemm_s8.cuh's HgQ8Epilogue<.., AMAX>), the caller takes the maximum
// over the model ranks (an exact all-reduce), and this pass quantises the
// rank's columns with it. Over a whole row the two give quant_rows_kernel's
// bits.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
quant_rows_given_kernel(const T* __restrict__ src, const float* __restrict__ amax,
                        signed char* __restrict__ a8, float* __restrict__ ascale, int M,
                        int K) {
    const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const float scale = row_scale(amax[row]);
    if (lane == 0) ascale[row] = scale;
    quant_row(src + (size_t)row * K, scale, a8 + (size_t)row * K, K, lane);
}

// LayerNorm of four values of a row from its statistics: fp32, the same
// expression wherever a pass takes it (so its rounding is one).
__device__ __forceinline__ void ln_apply4(const float in[4], const float* ln_w,
                                          const float* ln_b, int k, float mean, float rstd,
                                          float h[4]) {
    const float4 w = *reinterpret_cast<const float4*>(ln_w + k);
    const float4 b = *reinterpret_cast<const float4*>(ln_b + k);
    h[0] = (in[0] - mean) * rstd * w.x + b.x;
    h[1] = (in[1] - mean) * rstd * w.y + b.y;
    h[2] = (in[2] - mean) * rstd * w.z + b.z;
    h[3] = (in[3] - mean) * rstd * w.w + b.w;
}

__device__ __forceinline__ void ln4(const bf16* row, const float* ln_w, const float* ln_b,
                                    int k, float mean, float rstd, float h[4]) {
    float v[4];
    load4(row + k, v);
    ln_apply4(v, ln_w, ln_b, k, mean, rstd, h);
}

// LayerNorm of x (M, K) bf16 (fp32 statistics, var = E[x^2] - mean^2, eps
// 1e-6, fp32 output) followed by the per-row quantiser, a warp per row. The
// fp32 LN output never leaves the registers: one pass for the statistics, one
// for the absolute maximum, one that quantises. Where zero is not null, the
// row's zero[row] is set to 0 (the row maxima the next producer's epilogue
// folds into: B9_tp's attention core).
__global__ void __launch_bounds__(ROW_THREADS)
ln_quant_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, signed char* __restrict__ a8,
                     float* __restrict__ ascale, float* __restrict__ zero, int M, int K) {
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
    if (lane == 0) {
        ascale[row] = scale;
        if (zero != nullptr) zero[row] = 0.f;
    }
    signed char* dst = a8 + (size_t)row * K;
    for (int k = lane * 4; k < K; k += 128) {
        ln4(xr, ln_w, ln_b, k, mean, rstd, v);
        store_q4(dst + k, v, scale);
    }
}

inline int row_blocks(int M) { return (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32); }

cudaError_t launch_ln_quant(const void* x, const void* ln_w, const void* ln_b, void* a8,
                            void* ascale, int M, int K, cudaStream_t stream,
                            float* zero = nullptr) {
    ln_quant_rows_kernel<<<row_blocks(M), ROW_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), static_cast<signed char*>(a8),
        static_cast<float*>(ascale), zero, M, K);
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

template <typename T>
cudaError_t launch_quant_rows_given(const void* src, const void* amax, void* a8, void* ascale,
                                    int M, int K, cudaStream_t stream) {
    quant_rows_given_kernel<T><<<row_blocks(M), ROW_THREADS, 0, stream>>>(
        static_cast<const T*>(src), static_cast<const float*>(amax),
        static_cast<signed char*>(a8), static_cast<float*>(ascale), M, K);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The column quantisers (ops/pair_q8.py quant_cols, quant_cols_tp): the
// per-output-channel int8 of nn.Linear weights (N, K), bf16 or fp32, which
// the JAX package computes outside its pallas_call (motionbert_tpu/ops/
// pair_q8.py quant_cols). An output channel is a row of the stored weight, so
// each is a warp-per-row pass: the |w| maximum over K, scale = max(amax,
// 1e-8) * float(1 / 127), q = clip(rint(w / scale)), the plain version's
// bits. One launch takes every weight of a call that needs the same pass,
// through a table of pointers and shapes passed by value:
//   quant_cols_kernel        the whole quantiser (column-parallel weights)
//   col_amax_kernel          the maxima of a rank's K columns, then the
//                            caller's MAX all-reduce over the model ranks,
//   quant_cols_given_kernel  and the quantiser with the all-reduced maxima
//                            (row-parallel weights: B9_tp's wproj and w2)
// Bound: each weight read once (the second read hits the cache) and its int8
// and scales written: ~6.3 MB at the flagship's four bf16 weights, 1.9 us at
// 3.35 TB/s; a launch's own latency weighs as much at these sizes.
// ---------------------------------------------------------------------------

constexpr int COLQ_MAX = 8;   // weights a launch takes (a W8A8 stream: two pairs' four)

enum ColQuantMode { COLQ_WHOLE = 0, COLQ_AMAX = 1, COLQ_GIVEN = 2 };

struct ColQuantTable {
    const void* src[COLQ_MAX];   // (rows, K), bf16 or fp32 (f32 1)
    void* q8[COLQ_MAX];          // (rows, K) int8
    void* scale[COLQ_MAX];       // (rows,) fp32
    void* amax[COLQ_MAX];        // (rows,) fp32: the split's maxima
    int f32[COLQ_MAX];
    int K[COLQ_MAX];
    int first[COLQ_MAX + 1];     // weight e's rows are [first[e], first[e + 1])
    int n;
};

template <int MODE, typename T>
__device__ __forceinline__ void col_quant_row(const ColQuantTable& t, int e, int r, int lane) {
    const int K = t.K[e];
    const T* s = static_cast<const T*>(t.src[e]) + (size_t)r * K;
    const float amax = MODE == COLQ_GIVEN ? static_cast<const float*>(t.amax[e])[r]
                                          : row_amax(s, K, lane);
    if (MODE == COLQ_AMAX) {
        if (lane == 0) static_cast<float*>(t.amax[e])[r] = amax;
        return;
    }
    const float scale = q8_scale(amax, COL_AMAX_FLOOR);
    if (lane == 0) static_cast<float*>(t.scale[e])[r] = scale;
    quant_row(s, scale, static_cast<signed char*>(t.q8[e]) + (size_t)r * K, K, lane);
}

// Row g of the table's weights, a warp each.
template <int MODE>
__device__ __forceinline__ void col_quant(const ColQuantTable& t) {
    const int g = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (g >= t.first[t.n]) return;
    int e = 0;
    while (g >= t.first[e + 1]) ++e;
    if (t.f32[e])
        col_quant_row<MODE, float>(t, e, g - t.first[e], lane);
    else
        col_quant_row<MODE, bf16>(t, e, g - t.first[e], lane);
}

__global__ void __launch_bounds__(ROW_THREADS)
quant_cols_kernel(const __grid_constant__ ColQuantTable t) {
    col_quant<COLQ_WHOLE>(t);
}

__global__ void __launch_bounds__(ROW_THREADS)
col_amax_kernel(const __grid_constant__ ColQuantTable t) {
    col_quant<COLQ_AMAX>(t);
}

__global__ void __launch_bounds__(ROW_THREADS)
quant_cols_given_kernel(const __grid_constant__ ColQuantTable t) {
    col_quant<COLQ_GIVEN>(t);
}

// One launch of the pass `mode` over the table's weights. K % 4 == 0 and
// rows >= 1 for every weight, 1..COLQ_MAX weights; cudaErrorInvalidValue
// otherwise.
cudaError_t launch_col_quant(int mode, const ColQuantTable& t, cudaStream_t stream) {
    if (t.n < 1 || t.n > COLQ_MAX || t.first[0] != 0) return cudaErrorInvalidValue;
    for (int e = 0; e < t.n; ++e)
        if (t.K[e] < 4 || t.K[e] % 4 || t.first[e + 1] <= t.first[e])
            return cudaErrorInvalidValue;
    const int blocks = row_blocks(t.first[t.n]);
    switch (mode) {
        case COLQ_WHOLE: quant_cols_kernel<<<blocks, ROW_THREADS, 0, stream>>>(t); break;
        case COLQ_AMAX: col_amax_kernel<<<blocks, ROW_THREADS, 0, stream>>>(t); break;
        case COLQ_GIVEN: quant_cols_given_kernel<<<blocks, ROW_THREADS, 0, stream>>>(t); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B9_tp's row passes after the int32 all-reduce (pair_q8_kernels.cu), each a
// dequantise with q8_dequant4<Q8_BIAS_RES>'s operations, so every value is
// the s8 engine's Q8_BIAS_RES output of the same sums bit for bit.
// ---------------------------------------------------------------------------

// out = bf16(((float)acc * ascale[m]) * wscale[n] + bias[n] + R), four
// columns a thread. N % 4 == 0.
constexpr int DEQUANT_THREADS = 256;

__global__ void __launch_bounds__(DEQUANT_THREADS)
dequant_rows_kernel(const int* __restrict__ acc, const float* __restrict__ ascale,
                    const float* __restrict__ wscale, const bf16* __restrict__ bias,
                    const bf16* __restrict__ R, bf16* __restrict__ out, int M, int N) {
    const size_t o = ((size_t)blockIdx.x * DEQUANT_THREADS + threadIdx.x) * 4;
    if (o >= (size_t)M * N) return;
    const int m = (int)(o / N), n = (int)(o % N);
    const int4 a = *reinterpret_cast<const int4*>(acc + o);
    const int v[4] = {a.x, a.y, a.z, a.w};
    q8_epilogue4<Q8_BIAS_RES>(v, __ldg(ascale + m), o, n, wscale, bias, R, out);
}

cudaError_t launch_dequant_rows(const void* acc, const void* ascale, const void* wscale,
                                const void* bias, const void* R, void* out, int M, int N,
                                cudaStream_t stream) {
    const size_t quads = (size_t)M * N / 4;
    dequant_rows_kernel<<<(unsigned)((quads + DEQUANT_THREADS - 1) / DEQUANT_THREADS),
                          DEQUANT_THREADS, 0, stream>>>(
        static_cast<const int*>(acc), static_cast<const float*>(ascale),
        static_cast<const float*>(wscale), static_cast<const bf16*>(bias),
        static_cast<const bf16*>(R), static_cast<bf16*>(out), M, N);
    return cudaGetLastError();
}

// The MLP stage's row pass, a warp per row: y = bf16(deq(acc) + bias + R)
// written (the residual of the output stage), then LN2(y) quantised from the
// registers, with ln_quant_rows_kernel's lane order and arithmetic (lane l
// holds columns 4l + 128i), so the statistics, the scale and the int8 are
// the two passes' bits; ascale holds the proj input's scales on entry and
// LN2's on exit, and zero[row] is set to 0 for fc1's row maxima. NI = the
// row's 128-column steps (K <= 128 NI).
template <int NI>
__global__ void __launch_bounds__(ROW_THREADS)
dequant_ln_quant_rows_kernel(const int* __restrict__ acc, float* __restrict__ ascale,
                             const float* __restrict__ wscale, const bf16* __restrict__ bias,
                             const bf16* __restrict__ R, bf16* __restrict__ y,
                             const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                             signed char* __restrict__ a8, float* __restrict__ zero, int M,
                             int K) {
    const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const size_t base = (size_t)row * K;
    const float as = ascale[row];
    float v[NI][4];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
        const int k = lane * 4 + i * 128;
        if (k >= K) continue;
        const int4 a = *reinterpret_cast<const int4*>(acc + base + k);
        const int av[4] = {a.x, a.y, a.z, a.w};
        float d[4];
        q8_dequant4<Q8_BIAS_RES>(av, as, base + k, k, wscale, bias, R, d);
        const bf162 lo = __floats2bfloat162_rn(d[0], d[1]);
        const bf162 hi = __floats2bfloat162_rn(d[2], d[3]);
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(y + base + k) = packed;
        v[i][0] = __low2float(lo);
        v[i][1] = __high2float(lo);
        v[i][2] = __low2float(hi);
        v[i][3] = __high2float(hi);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            s += v[i][t];
            ss += v[i][t] * v[i][t];
        }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / K;
    const float rstd = rsqrtf(ss / K - mean * mean + LN_EPS);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
        const int k = lane * 4 + i * 128;
        if (k >= K) continue;
        ln_apply4(v[i], ln_w, ln_b, k, mean, rstd, v[i]);
#pragma unroll
        for (int t = 0; t < 4; ++t) amax = fmaxf(amax, fabsf(v[i][t]));
    }
    const float scale = row_scale(warp_max(amax));
    if (lane == 0) {
        ascale[row] = scale;
        zero[row] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
        const int k = lane * 4 + i * 128;
        if (k < K) store_q4(a8 + base + k, v[i], scale);
    }
}

constexpr int DEQUANT_LN_MAX_STEPS = 8;   // K <= 1024: the row in registers

template <int NI>
cudaError_t launch_dequant_ln_quant_ni(const void* acc, void* ascale, const void* wscale,
                                       const void* bias, const void* R, void* y,
                                       const void* ln_w, const void* ln_b, void* a8,
                                       void* zero, int M, int K, cudaStream_t stream) {
    if ((K + 127) / 128 != NI) {
        if constexpr (NI < DEQUANT_LN_MAX_STEPS)
            return launch_dequant_ln_quant_ni<NI + 1>(acc, ascale, wscale, bias, R, y, ln_w,
                                                      ln_b, a8, zero, M, K, stream);
        return cudaErrorInvalidValue;
    }
    dequant_ln_quant_rows_kernel<NI><<<row_blocks(M), ROW_THREADS, 0, stream>>>(
        static_cast<const int*>(acc), static_cast<float*>(ascale),
        static_cast<const float*>(wscale), static_cast<const bf16*>(bias),
        static_cast<const bf16*>(R), static_cast<bf16*>(y), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), static_cast<signed char*>(a8),
        static_cast<float*>(zero), M, K);
    return cudaGetLastError();
}

// K % 4 == 0 and 4 <= K <= 128 * DEQUANT_LN_MAX_STEPS; cudaErrorInvalidValue
// otherwise.
cudaError_t launch_dequant_ln_quant(const void* acc, void* ascale, const void* wscale,
                                    const void* bias, const void* R, void* y,
                                    const void* ln_w, const void* ln_b, void* a8, void* zero,
                                    int M, int K, cudaStream_t stream) {
    if (K < 4 || K % 4) return cudaErrorInvalidValue;
    return launch_dequant_ln_quant_ni<1>(acc, ascale, wscale, bias, R, y, ln_w, ln_b, a8, zero,
                                         M, K, stream);
}

// The gated output stage's row pass, a warp per row: the pair output
// bf16(deq(acc) + bias + R) two columns a lane, straight into the gate
// (pair_common.cuh's gate_row, the order of gate_kernel's sums), so it never
// reaches device memory. C % 64 == 0.
__global__ void __launch_bounds__(GATE_THREADS)
dequant_gate_rows_kernel(const int* __restrict__ acc, const float* __restrict__ ascale,
                         const float* __restrict__ wscale, const bf16* __restrict__ bias,
                         const bf16* __restrict__ R, const bf16* __restrict__ other,
                         const bf16* __restrict__ wg, const bf16* __restrict__ bg,
                         bf16* __restrict__ out, int M, int C) {
    const int row = blockIdx.x * (GATE_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const size_t base = (size_t)row * C;
    const float as = __ldg(ascale + row);
    const auto pair = [=](int c) {
        const int2 a = *reinterpret_cast<const int2*>(acc + base + c);
        const float2 ws = __ldg(reinterpret_cast<const float2*>(wscale + c));
        const float2 b = load_bf162(bias + c);
        const float2 r = load_bf162(R + base + c);
        return make_float2(round_bf16(__fadd_rn(q8_deq(a.x, as, ws.x, b.x), r.x)),
                           round_bf16(__fadd_rn(q8_deq(a.y, as, ws.y, b.y), r.y)));
    };
    gate_row(other + base, pair, wg, bg, out + base, C, lane);
}

cudaError_t launch_dequant_gate(const void* acc, const void* ascale, const void* wscale,
                                const void* bias, const void* R, const void* other,
                                const void* wg, const void* bg, void* out, int M, int C,
                                cudaStream_t stream) {
    if (C < 64 || C % 64) return cudaErrorInvalidValue;
    const int blocks = (M + GATE_THREADS / 32 - 1) / (GATE_THREADS / 32);
    dequant_gate_rows_kernel<<<blocks, GATE_THREADS, 0, stream>>>(
        static_cast<const int*>(acc), static_cast<const float*>(ascale),
        static_cast<const float*>(wscale), static_cast<const bf16*>(bias),
        static_cast<const bf16*>(R), static_cast<const bf16*>(other),
        static_cast<const bf16*>(wg), static_cast<const bf16*>(bg), static_cast<bf16*>(out),
        M, C);
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
