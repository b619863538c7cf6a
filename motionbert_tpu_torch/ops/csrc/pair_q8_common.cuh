// Shared device code of the W8A8 DSTformer pair (pair_q8_kernels.cu) and the
// W8A8 stream (stream_kernels.cu), for NVIDIA Hopper (sm_90a): the per-row
// quantisers (ln_quant_rows_kernel, quant_rows_kernel), the int8 tensor-core
// GEMM with its dequantising epilogues (gemm_q8_kernel) and the pair's chain
// of nine launches (q8_pair_chain). The scheme, the rounding points and the
// bound are in the note at the top of pair_q8_kernels.cu.
//
// Everything is in an anonymous namespace, as in pair_common.cuh: each .cu
// that includes this file builds into its own shared library with its own
// copy.

#pragma once

#include "pair_common.cuh"

namespace {

constexpr int QBM = 64, QBN = 64, QBK = 64;
// byte row stride of the int8 tiles: rows start 16-byte aligned, and the
// eight rows a warp reads at once fall on distinct banks (20 words apart)
constexpr int QLD = QBK + 16;
constexpr int QGEMM_THREADS = 128;
constexpr int ROW_THREADS = 256;
constexpr float INV127 = 0.007874015718698502f;  // float(1 / 127)
constexpr float ROW_AMAX_FLOOR = 1e-6f;

enum Q8Epilogue {
    Q8_BIAS = 0,          // bf16(deq + bias)
    Q8_BIAS_RES = 1,      // bf16(deq + bias + R)
    Q8_BIAS_GELU_F32 = 2  // fp32 GELU(deq + bias)
};

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

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out[M, N] = epilogue((A8[M, K] . W8[N, K]^T) * ascale[m] * wscale[n] + bias[n])
// A8 the quantised rows, W8 the quantised nn.Linear weight (out, in), both
// row-major int8; int32 accumulation on the tensor cores. Four warps, each a
// 32x32 corner of the 64x64 tile as 2x4 m16n8k32 fragments read straight from
// shared memory. Needs N % 64 == 0 and K % 64 == 0; rows past M are zero.
template <int EPI>
__global__ void __launch_bounds__(QGEMM_THREADS)
gemm_q8_kernel(const signed char* __restrict__ A, const float* __restrict__ ascale,
               const signed char* __restrict__ W, const float* __restrict__ wscale,
               const bf16* __restrict__ bias, const bf16* __restrict__ R,
               void* __restrict__ out, int M, int N, int K) {
    __shared__ __align__(16) signed char As[QBM * QLD];
    __shared__ __align__(16) signed char Bs[QBN * QLD];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = blockIdx.y * QBM, c0 = blockIdx.x * QBN;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int k0 = 0; k0 < K; k0 += QBK) {
        // both tiles: 64 rows x 64 bytes as 16-byte chunks
        for (int c = tid; c < QBM * (QBK / 16); c += QGEMM_THREADS) {
            const int r = c / (QBK / 16), kc = (c % (QBK / 16)) * 16;
            const int m = r0 + r;
            uint4 va = zero4;
            if (m < M) va = *reinterpret_cast<const uint4*>(A + (size_t)m * K + k0 + kc);
            *reinterpret_cast<uint4*>(As + r * QLD + kc) = va;
            *reinterpret_cast<uint4*>(Bs + r * QLD + kc) =
                *reinterpret_cast<const uint4*>(W + (size_t)(c0 + r) * K + k0 + kc);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < QBK; kk += 32) {
            uint32_t a[2][4], b[4][2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const signed char* p = As + (wm + i * 16 + g) * QLD + kk + t * 4;
                a[i][0] = *reinterpret_cast<const uint32_t*>(p);
                a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * QLD);
                a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
                a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * QLD + 16);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const signed char* p = Bs + (wn + j * 8 + g) * QLD + kk + t * 4;
                b[j][0] = *reinterpret_cast<const uint32_t*>(p);
                b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
        }
        __syncthreads();
    }

    // accumulator (i, j): rows wm + i*16 + g (+8), columns wn + j*8 + t*2 (+1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int m = r0 + wm + i * 16 + g + half * 8;
            if (m >= M) continue;
            const float as = ascale[m];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = c0 + wn + j * 8 + t * 2;
                const size_t o = (size_t)m * N + n;
                const float2 ws = *reinterpret_cast<const float2*>(wscale + n);
                const float2 bv = load_bf162(bias + n);
                float v0 = __fadd_rn(
                    __fmul_rn(__fmul_rn((float)acc[i][j][half * 2], as), ws.x), bv.x);
                float v1 = __fadd_rn(
                    __fmul_rn(__fmul_rn((float)acc[i][j][half * 2 + 1], as), ws.y), bv.y);
                if (EPI == Q8_BIAS_RES) {
                    const float2 rv = load_bf162(R + o);
                    v0 = __fadd_rn(v0, rv.x);
                    v1 = __fadd_rn(v1, rv.y);
                }
                if (EPI == Q8_BIAS_GELU_F32) {
                    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
                        make_float2(gelu(v0), gelu(v1));
                } else {
                    *reinterpret_cast<bf162*>(static_cast<bf16*>(out) + o) =
                        __floats2bfloat162_rn(v0, v1);
                }
            }
        }
    }
}

template <int EPI>
cudaError_t launch_gemm_q8(const void* A, const void* ascale, const void* W,
                           const void* wscale, const void* bias, const void* R, void* out,
                           int M, int N, int K, cudaStream_t stream) {
    const dim3 grid(N / QBN, (M + QBM - 1) / QBM);
    gemm_q8_kernel<EPI><<<grid, QGEMM_THREADS, 0, stream>>>(
        static_cast<const signed char*>(A), static_cast<const float*>(ascale),
        static_cast<const signed char*>(W), static_cast<const float*>(wscale),
        static_cast<const bf16*>(bias), static_cast<const bf16*>(R), out, M, N, K);
    return cudaGetLastError();
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
// (M, 3C), attn (M, C), y (M, C) bf16 and act (M, hidden) fp32. x is read by
// the first and fifth launch only, so out may alias x's buffer once they have
// run (the stream chain, stream_kernels.cu).
cudaError_t q8_pair_chain(const void* x, void* out, void* a8, void* ascale, void* qkv,
                          void* attn, void* y, void* act, const PairQ8Params& p, int B,
                          int F, int J, int C, int H, int hidden, float scale, int temporal,
                          cudaStream_t stream) {
    const int M = B * F * J;
    cudaError_t err;
    err = launch_ln_quant(x, p.ln1_w, p.ln1_b, a8, ascale, M, C, stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm_q8<Q8_BIAS>(a8, ascale, p.wqkv8, p.sqkv, p.bqkv, nullptr, qkv, M, 3 * C,
                                  C, stream);
    if (err != cudaSuccess) return err;
    err = launch_attention_any(qkv, attn, B, F, J, C, H, scale, temporal, stream);
    if (err != cudaSuccess) return err;
    err = launch_quant_rows<bf16>(attn, a8, ascale, M, C, stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm_q8<Q8_BIAS_RES>(a8, ascale, p.wproj8, p.sproj, p.bproj, x, y, M, C, C,
                                      stream);
    if (err != cudaSuccess) return err;
    err = launch_ln_quant(y, p.ln2_w, p.ln2_b, a8, ascale, M, C, stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm_q8<Q8_BIAS_GELU_F32>(a8, ascale, p.w18, p.s1, p.b1, nullptr, act, M,
                                           hidden, C, stream);
    if (err != cudaSuccess) return err;
    err = launch_quant_rows<float>(act, a8, ascale, M, hidden, stream);
    if (err != cudaSuccess) return err;
    return launch_gemm_q8<Q8_BIAS_RES>(a8, ascale, p.w28, p.s2, p.b2, y, out, M, C, hidden,
                                       stream);
}

}  // namespace
