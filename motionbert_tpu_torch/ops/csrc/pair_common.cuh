// Shared device code of the DSTformer pair kernels (pair_kernels.cu, the
// forward, pair_bwd_kernels.cu, the backward, and pair_q8_kernels.cu, the int8
// forward), of the standalone attention and MLP blocks (block_kernels.cu) and
// of the standalone attention core (st_attention_kernels.cu):
// bf16 with fp32 accumulation, for NVIDIA Hopper (sm_90a).
//
// - gemm_kernel<LAYOUT, LN, EPI>: one WMMA (mma.sync) GEMM with 64x64 output
//   tiles and a 32-deep reduction step, in three operand layouts:
//     NT  out[M, N] = prologue(A)[M, K] . W[N, K]^T   (nn.Linear forward)
//     NN  out[M, N] = A[M, K] . W[K, N]               (input gradients)
//     TN  out[N, K] = sum_m A[m, n] W[m, k]           (weight gradients)
//   TN reduces over the token rows M: the rows are cut into `splits` fixed
//   chunks, each block writes its chunk's fp32 partial tile, and
//   reduce_splits_kernel adds the partials in chunk order. No atomics, so
//   the result is the same bits on every run.
// - attention_kernel<D>: softmax(q k^T * scale) v over one (group, head) per
//   block, K and V of the group in shared memory, a warp per query row; q, k
//   and v are three row-strided pointers, so the chains' packed qkv and the
//   standalone core's separate tensors (st_attention_kernels.cu) share it.
// - gate_kernel: the att_fuse gate of the gated pair, a warp per token row.
//
// Everything is in an anonymous namespace: each .cu that includes this file
// builds into its own shared library with its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;   // bf16 row stride of the k-contiguous tiles (80 bytes)
constexpr int LDT = BN + 8;   // bf16 row stride of the k-major tiles (144 bytes)
constexpr int TILE_ELEMS = BM * LDS;  // >= BK * LDT
constexpr int LDC = BN + 4;   // fp32 row stride of the accumulator tile
constexpr int GEMM_THREADS = 128;
constexpr int ATTN_THREADS = 256;
constexpr float LN_EPS = 1e-6f;

static_assert(BK * LDT <= TILE_ELEMS, "k-major tile must fit the tile buffer");

enum Layout { NT = 0, NN = 1, TN = 2 };

enum Epilogue {
    EPI_BIAS = 0,         // bf16(acc + bias)
    EPI_BIAS_RES = 1,     // bf16(acc + bias + R)
    EPI_BIAS_GELU = 2,    // bf16(GELU(acc + bias))
    EPI_BIAS_GELU_Z = 3,  // bf16(GELU(z)) to out and fp32 z = acc + bias to out_z
    EPI_F32 = 4,          // fp32 acc
    EPI_BF16 = 5,         // bf16(acc)
    EPI_DGELU = 6,        // bf16(acc * GELU'(Z)), Z fp32 of the output's shape
    EPI_PARTIAL = 7,      // fp32 acc into this block's split slice (TN)
    EPI_RES = 8           // bf16(acc + R)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float2 load_bf162(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

// exact-erf GELU and its derivative Phi(z) + z phi(z)
__device__ __forceinline__ float gelu(float v) {
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float z) {
    const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
    const float pdf = expf(-0.5f * z * z) * 0.3989422804014327f;
    return cdf + z * pdf;
}

// See the layouts above. A, W, R row-major bf16; W in NT is the nn.Linear
// weight (out, in), in NN the same weight read as (K, N) = (out, in). With LN
// (NT only) the A rows are layer-normalised (fp32 statistics, ln_w/ln_b fp32)
// and rounded to bf16 as they enter shared memory. Needs the output's column
// count % 64 == 0 and the reduction length % 32 == 0 (NT, NN); TN needs
// N % 64 == 0 and K % 64 == 0 and reduces over rows [z * split, z * split +
// split) of M.
template <int LAYOUT, bool LN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, const bf16* __restrict__ R,
            const float* __restrict__ ln_w, const float* __restrict__ ln_b,
            const float* __restrict__ Z, void* __restrict__ out,
            float* __restrict__ out_z, int M, int N, int K, int split) {
    static_assert(!LN || LAYOUT == NT, "the LayerNorm prologue is NT only");
    __shared__ __align__(128) bf16 As[TILE_ELEMS];
    __shared__ __align__(128) bf16 Bs[TILE_ELEMS];
    __shared__ __align__(128) float Cs[BM * LDC];
    __shared__ float mean_s[BM];
    __shared__ float rstd_s[BM];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
    const int rows = (LAYOUT == TN) ? N : M;
    const int cols = (LAYOUT == TN) ? K : N;
    int k_begin = 0, k_end = K;
    if (LAYOUT == TN) {
        k_begin = blockIdx.z * split;
        k_end = min(M, k_begin + split);
    }

    if (LN) {
        for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
            const int m = r0 + r;
            float s = 0.f, ss = 0.f;
            if (m < M) {
                const bf16* row = A + (size_t)m * K;
                for (int k = lane * 2; k < K; k += 64) {
                    const float2 v = load_bf162(row + k);
                    s += v.x + v.y;
                    ss += v.x * v.x + v.y * v.y;
                }
            }
            s = warp_sum(s);
            ss = warp_sum(ss);
            if (lane == 0) {
                const float mean = s / K;
                const float var = ss / K - mean * mean;
                mean_s[r] = mean;
                rstd_s[r] = rsqrtf(var + LN_EPS);
            }
        }
        __syncthreads();
    }

    using ALayout = typename std::conditional<LAYOUT == TN, wmma::col_major,
                                              wmma::row_major>::type;
    using BLayout = typename std::conditional<LAYOUT == NT, wmma::col_major,
                                              wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
        if (LAYOUT == TN) {
            // BK token rows of A (M, N) cols [r0, r0+64) and of W (M, K)
            // cols [c0, c0+64), both stored k-major
            for (int c = tid; c < BK * (BM / 8); c += GEMM_THREADS) {
                const int r = c / (BM / 8), cc = (c % (BM / 8)) * 8;
                const int m = k0 + r;
                uint4 va = zero4, vb = zero4;
                if (m < k_end) {
                    va = *reinterpret_cast<const uint4*>(A + (size_t)m * N + r0 + cc);
                    vb = *reinterpret_cast<const uint4*>(W + (size_t)m * K + c0 + cc);
                }
                *reinterpret_cast<uint4*>(As + r * LDT + cc) = va;
                *reinterpret_cast<uint4*>(Bs + r * LDT + cc) = vb;
            }
        } else {
            // A tile: BM rows x BK cols as 16-byte chunks of 8 bf16
            for (int c = tid; c < BM * (BK / 8); c += GEMM_THREADS) {
                const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
                const int m = r0 + r;
                uint4 v = zero4;
                if (m < M) {
                    v = *reinterpret_cast<const uint4*>(A + (size_t)m * K + k0 + kc);
                    if (LN) {
                        bf16* e = reinterpret_cast<bf16*>(&v);
                        const float mean = mean_s[r], rstd = rstd_s[r];
#pragma unroll
                        for (int t = 0; t < 8; ++t) {
                            const int k = k0 + kc + t;
                            const float h = (__bfloat162float(e[t]) - mean) * rstd;
                            e[t] = __float2bfloat16(h * ln_w[k] + ln_b[k]);
                        }
                    }
                }
                *reinterpret_cast<uint4*>(As + r * LDS + kc) = v;
            }
            if (LAYOUT == NT) {
                // BN weight rows x BK cols
                for (int c = tid; c < BN * (BK / 8); c += GEMM_THREADS) {
                    const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
                    *reinterpret_cast<uint4*>(Bs + r * LDS + kc) =
                        *reinterpret_cast<const uint4*>(W + (size_t)(c0 + r) * K + k0 + kc);
                }
            } else {
                // NN: BK weight rows (K, N) x BN cols, k-major
                for (int c = tid; c < BK * (BN / 8); c += GEMM_THREADS) {
                    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
                    *reinterpret_cast<uint4*>(Bs + r * LDT + nc) =
                        *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + c0 + nc);
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (LAYOUT == TN)
                    wmma::load_matrix_sync(a[i], As + kk * LDT + wm + i * 16, LDT);
                else
                    wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDS + kk, LDS);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                if (LAYOUT == NT)
                    wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * LDS + kk, LDS);
                else
                    wmma::load_matrix_sync(b[j], Bs + kk * LDT + wn + j * 16, LDT);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16,
                                    acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();

    for (int e = tid; e < BM * (BN / 2); e += GEMM_THREADS) {
        const int r = e / (BN / 2), c = (e % (BN / 2)) * 2;
        const int m = r0 + r;
        if (m >= rows) continue;
        const int n = c0 + c;
        const size_t o = (size_t)m * cols + n;
        float v0 = Cs[r * LDC + c];
        float v1 = Cs[r * LDC + c + 1];
        if (EPI == EPI_F32) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
            continue;
        }
        if (EPI == EPI_PARTIAL) {
            float* part = static_cast<float*>(out) + (size_t)blockIdx.z * rows * cols;
            *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
            continue;
        }
        if (EPI == EPI_DGELU) {
            const float2 z = *reinterpret_cast<const float2*>(Z + o);
            v0 *= gelu_grad(z.x);
            v1 *= gelu_grad(z.y);
        }
        if (EPI == EPI_BIAS || EPI == EPI_BIAS_RES || EPI == EPI_BIAS_GELU ||
            EPI == EPI_BIAS_GELU_Z) {
            const float2 bv = load_bf162(bias + n);
            v0 += bv.x;
            v1 += bv.y;
        }
        if (EPI == EPI_BIAS_RES || EPI == EPI_RES) {
            const float2 rv = load_bf162(R + o);
            v0 += rv.x;
            v1 += rv.y;
        }
        if (EPI == EPI_BIAS_GELU_Z)
            *reinterpret_cast<float2*>(out_z + o) = make_float2(v0, v1);
        if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_Z) {
            v0 = gelu(v0);
            v1 = gelu(v1);
        }
        *reinterpret_cast<bf162*>(static_cast<bf16*>(out) + o) = __floats2bfloat162_rn(v0, v1);
    }
}

// Attention core over one (group, head) per block. q, k and v are bf16 token
// rows with row stride ld (elements), each split into H heads of D: the pair
// and block chains pass one packed (M, 3C) qkv as (qkv, qkv + C, qkv + 2C,
// 3C), the standalone core (st_attention_kernels.cu) three (M, C) tensors and
// C. The group's N tokens sit at rows base + t * stride. K and V of the group
// stay in shared memory (row stride D + 2 so lanes reading different keys hit
// different banks); each warp owns one query row at a time: fp32 scores,
// max-subtracted fp32 softmax, P rounded to bf16, fp32 P.V, bf16 output
// (M, C).
__device__ __forceinline__ void attention_group(int g, int F, int J, int temporal,
                                                int* N, int* base, int* stride) {
    if (temporal) {
        const int b = g / J, j = g % J;
        *N = F;
        *base = b * F * J + j;
        *stride = J;
    } else {
        *N = J;
        *base = g * J;
        *stride = 1;
    }
}

template <int D>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const bf16* __restrict__ q_in, const bf16* __restrict__ k_in,
                 const bf16* __restrict__ v_in, int ld, bf16* __restrict__ out,
                 int F, int J, int C, float scale, int temporal) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int LDK = D + 2;
    const int h = blockIdx.y;
    int N, base, stride;
    attention_group(blockIdx.x, F, J, temporal, &N, &base, &stride);
    const int nwarps = ATTN_THREADS / 32;
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + N * LDK;
    float* Ps = reinterpret_cast<float*>(Vs + N * LDK);

    for (int idx = threadIdx.x; idx < N * (D / 2); idx += ATTN_THREADS) {
        const int t = idx / (D / 2), c = (idx % (D / 2)) * 2;
        const size_t r = (size_t)(base + t * stride) * ld + h * D + c;
        *reinterpret_cast<bf162*>(Ks + t * LDK + c) =
            *reinterpret_cast<const bf162*>(k_in + r);
        *reinterpret_cast<bf162*>(Vs + t * LDK + c) =
            *reinterpret_cast<const bf162*>(v_in + r);
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* p = Ps + warp * N;
    for (int i = warp; i < N; i += nwarps) {
        const size_t qrow = (size_t)(base + i * stride);
        const bf16* qp = q_in + qrow * ld + h * D;
        float q[D];
#pragma unroll
        for (int c = 0; c < D; c += 2) {
            const float2 v = load_bf162(qp + c);
            q[c] = v.x;
            q[c + 1] = v.y;
        }
        float mx = __int_as_float(0xff800000);  // -inf
        for (int m = lane; m < N; m += 32) {
            const bf16* kr = Ks + m * LDK;
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < D; c += 2) {
                const float2 kv = load_bf162(kr + c);
                s += q[c] * kv.x + q[c + 1] * kv.y;
            }
            s *= scale;
            p[m] = s;
            mx = fmaxf(mx, s);
        }
        mx = warp_max(mx);
        float sum = 0.f;
        for (int m = lane; m < N; m += 32) {
            const float e = expf(p[m] - mx);
            p[m] = e;
            sum += e;
        }
        sum = warp_sum(sum);
        for (int m = lane; m < N; m += 32) p[m] = round_bf16(p[m] / sum);
        __syncwarp();
        for (int c = lane * 2; c < D; c += 64) {
            float a0 = 0.f, a1 = 0.f;
            for (int m = 0; m < N; ++m) {
                const float pm = p[m];
                const float2 v = load_bf162(Vs + m * LDK + c);
                a0 += pm * v.x;
                a1 += pm * v.y;
            }
            *reinterpret_cast<bf162*>(out + qrow * C + h * D + c) = __floats2bfloat162_rn(a0, a1);
        }
        __syncwarp();
    }
}

template <int LAYOUT, bool LN, int EPI>
cudaError_t launch_gemm(const void* A, const void* W, const void* bias, const void* R,
                        const void* ln_w, const void* ln_b, const void* Z, void* out,
                        void* out_z, int M, int N, int K, cudaStream_t stream,
                        int splits = 1) {
    dim3 grid;
    int split = 0;
    if (LAYOUT == TN) {
        split = ((M + splits - 1) / splits + BK - 1) / BK * BK;
        grid = dim3(K / BN, N / BM, splits);
    } else {
        grid = dim3(N / BN, (M + BM - 1) / BM);
    }
    gemm_kernel<LAYOUT, LN, EPI><<<grid, GEMM_THREADS, 0, stream>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(W),
        static_cast<const bf16*>(bias), static_cast<const bf16*>(R),
        static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
        static_cast<const float*>(Z), out, static_cast<float*>(out_z), M, N, K, split);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_attention(const void* q, const void* k, const void* v, int ld,
                             void* out, int B, int F, int J, int C, float scale,
                             int temporal, cudaStream_t stream) {
    const int N = temporal ? F : J;
    const size_t smem = 2 * (size_t)N * (D + 2) * sizeof(bf16)
                      + (size_t)(ATTN_THREADS / 32) * N * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(temporal ? B * J : B * F, C / D);
    attention_kernel<D><<<grid, ATTN_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), ld, static_cast<bf16*>(out), F, J, C, scale,
        temporal);
    return cudaGetLastError();
}

// The attention core on separate q, k, v token rows of row stride ld.
cudaError_t launch_st_attention_any(const void* q, const void* k, const void* v, int ld,
                                    void* out, int B, int F, int J, int C, int H,
                                    float scale, int temporal, cudaStream_t stream) {
    const int D = C / H;
    if (D == 64) return launch_attention<64>(q, k, v, ld, out, B, F, J, C, scale, temporal, stream);
    if (D == 32) return launch_attention<32>(q, k, v, ld, out, B, F, J, C, scale, temporal, stream);
    return cudaErrorInvalidValue;
}

// The attention core on one packed (M, 3C) qkv ([q | k | v] per row).
cudaError_t launch_attention_any(const void* qkv, void* out, int B, int F, int J, int C,
                                 int H, float scale, int temporal, cudaStream_t stream) {
    const bf16* q = static_cast<const bf16*>(qkv);
    return launch_st_attention_any(q, q + C, q + 2 * C, 3 * C, out, B, F, J, C, H, scale,
                                   temporal, stream);
}

constexpr int GATE_THREADS = 256;

// att_fuse gate, one warp per token row: s_k = other.wg[k, :C] + pair.wg[k, C:]
// + bg[k] in fp32, (a0, a1) = bf16(softmax(s)), out = bf16(bf16(other * a0) +
// bf16(pair * a1)). wg is the nn.Linear weight (2, 2C).
__global__ void __launch_bounds__(GATE_THREADS)
gate_kernel(const bf16* __restrict__ other, const bf16* __restrict__ pair,
            const bf16* __restrict__ wg, const bf16* __restrict__ bg,
            bf16* __restrict__ out, int M, int C) {
    const int row = blockIdx.x * (GATE_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const bf16* o = other + (size_t)row * C;
    const bf16* u = pair + (size_t)row * C;
    const bf16* w0 = wg;
    const bf16* w1 = wg + 2 * C;
    float s0a = 0.f, s1a = 0.f, s0b = 0.f, s1b = 0.f;
    for (int c = lane * 2; c < C; c += 64) {
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const bf162*>(o + c));
        const float2 uv = __bfloat1622float2(*reinterpret_cast<const bf162*>(u + c));
        const float2 w0a = __bfloat1622float2(*reinterpret_cast<const bf162*>(w0 + c));
        const float2 w1a = __bfloat1622float2(*reinterpret_cast<const bf162*>(w1 + c));
        const float2 w0b = __bfloat1622float2(*reinterpret_cast<const bf162*>(w0 + C + c));
        const float2 w1b = __bfloat1622float2(*reinterpret_cast<const bf162*>(w1 + C + c));
        s0a += ov.x * w0a.x + ov.y * w0a.y;
        s1a += ov.x * w1a.x + ov.y * w1a.y;
        s0b += uv.x * w0b.x + uv.y * w0b.y;
        s1b += uv.x * w1b.x + uv.y * w1b.y;
    }
    s0a = warp_sum(s0a);
    s1a = warp_sum(s1a);
    s0b = warp_sum(s0b);
    s1b = warp_sum(s1b);
    const float s0 = s0a + s0b + __bfloat162float(bg[0]);
    const float s1 = s1a + s1b + __bfloat162float(bg[1]);
    const float mx = fmaxf(s0, s1);
    const float e0 = expf(s0 - mx), e1 = expf(s1 - mx);
    const float a0 = round_bf16(e0 / (e0 + e1));
    const float a1 = round_bf16(e1 / (e0 + e1));
    bf16* dst = out + (size_t)row * C;
    for (int c = lane * 2; c < C; c += 64) {
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const bf162*>(o + c));
        const float2 uv = __bfloat1622float2(*reinterpret_cast<const bf162*>(u + c));
        const float r0 = round_bf16(ov.x * a0) + round_bf16(uv.x * a1);
        const float r1 = round_bf16(ov.y * a0) + round_bf16(uv.y * a1);
        *reinterpret_cast<bf162*>(dst + c) = __floats2bfloat162_rn(r0, r1);
    }
}

cudaError_t launch_gate(const void* other, const void* pair, const void* wg,
                        const void* bg, void* out, int M, int C, cudaStream_t stream) {
    const int blocks = (M + GATE_THREADS / 32 - 1) / (GATE_THREADS / 32);
    gate_kernel<<<blocks, GATE_THREADS, 0, stream>>>(
        static_cast<const bf16*>(other), static_cast<const bf16*>(pair),
        static_cast<const bf16*>(wg), static_cast<const bf16*>(bg),
        static_cast<bf16*>(out), M, C);
    return cudaGetLastError();
}

// The 12 parameters of one pair, in the order of ops/fused_pair.py's
// PAIR_PARAMS: LayerNorm parameters fp32, the rest bf16, weights (out, in).
struct PairParams {
    const void *ln1_w, *ln1_b, *wqkv, *bqkv, *wproj, *bproj,
               *ln2_w, *ln2_b, *w1, *b1, *w2, *b2;
};

// One pair's chain of five launches (pair_kernels.cu's note): out =
// pair(x), with scratch qkv (M, 3C), attn (M, C), y (M, C), hid (M, hidden).
// x is read by the first and third launch only, so out may alias x's buffer
// once they have run: the stream chain (stream_kernels.cu) reads its
// inter-pair activation from the buffer that pass 2's last GEMM writes.
cudaError_t pair_chain(const void* x, void* out, void* qkv, void* attn, void* y, void* hid,
                       const PairParams& p, int B, int F, int J, int C, int H, int hidden,
                       float scale, int temporal, cudaStream_t stream) {
    const int M = B * F * J;
    cudaError_t err;
    err = launch_gemm<NT, true, EPI_BIAS>(x, p.wqkv, p.bqkv, nullptr, p.ln1_w, p.ln1_b,
                                          nullptr, qkv, nullptr, M, 3 * C, C, stream);
    if (err != cudaSuccess) return err;
    err = launch_attention_any(qkv, attn, B, F, J, C, H, scale, temporal, stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm<NT, false, EPI_BIAS_RES>(attn, p.wproj, p.bproj, x, nullptr, nullptr,
                                               nullptr, y, nullptr, M, C, C, stream);
    if (err != cudaSuccess) return err;
    err = launch_gemm<NT, true, EPI_BIAS_GELU>(y, p.w1, p.b1, nullptr, p.ln2_w, p.ln2_b,
                                               nullptr, hid, nullptr, M, hidden, C, stream);
    if (err != cudaSuccess) return err;
    return launch_gemm<NT, false, EPI_BIAS_RES>(hid, p.w2, p.b2, y, nullptr, nullptr, nullptr,
                                                out, nullptr, M, C, hidden, stream);
}

}  // namespace
