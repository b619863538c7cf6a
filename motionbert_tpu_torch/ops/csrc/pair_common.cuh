// Shared device code of the DSTformer chains, bf16 with fp32 accumulation, for
// NVIDIA Hopper (sm_90a): the constants, enums and helpers every chain uses
// (the operand layouts and epilogues of hopper_gemm.cuh's engine, GELU,
// rounding), the att_fuse gate, and the first design's CUDA-core attention
// core, which the chains not yet redesigned still run:
//
// - attention_kernel<D>: softmax(q k^T * scale) v over one (group, head) per
//   block, K and V of the group in shared memory, a warp per query row; q, k
//   and v are three row-strided pointers, so the W8A8 chain's packed qkv and
//   the standalone core's separate tensors (st_attention_kernels.cu) share
//   it. Its users: the standalone core (B8) and the W8A8 pair chain
//   (pair_q8_common.cuh, B9 and B10's W8A8 passes).
// - gate_kernel: the att_fuse gate of the gated pair, a warp per token row.
//
// The bf16 chains (the pairs B1 and B2 and B10's bf16 passes in
// pair_chain.cuh, the pair backward B3, the attention and MLP blocks B4-B7)
// run every product on hopper_gemm.cuh's engine and their attention core on
// attention_tc.cuh's tensor-core kernels instead.
//
// Everything is in an anonymous namespace: each .cu that includes this file
// builds into its own shared library with its own copy.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int ATTN_THREADS = 256;
constexpr int ROW_THREADS = 256;   // one warp per token row (the row passes)
constexpr float LN_EPS = 1e-6f;

// The engine's operand layouts (hopper_gemm.cuh): A, W row-major bf16, W the
// nn.Linear weight (out, in)
//   NT  out[M, N] = A[M, K] . W[N, K]^T   (nn.Linear forward)
//   NN  out[M, N] = A[M, K] . W[K, N]     (input gradients)
//   TN  out[N, K] = sum_m A[m, n] W[m, k] (weight gradients)
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

// Attention core over one (group, head) per block. q, k and v are bf16 token
// rows with row stride ld (elements), each split into H heads of D: the W8A8
// pair chain passes one packed (M, 3C) qkv as (qkv, qkv + C, qkv + 2C, 3C),
// the standalone core (st_attention_kernels.cu) three (M, C) tensors and
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

// The attention core on one packed (M, 3C) qkv ([q | k | v] per row): the
// W8A8 pair chain's.
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

}  // namespace
