// Shared device code of the DSTformer chains, bf16 with fp32 accumulation, for
// NVIDIA Hopper (sm_90a): the constants, enums and helpers every chain uses
// (the operand layouts and epilogues of hopper_gemm.cuh's engine, GELU,
// rounding, a warp's sums), the token rows of an attention group
// (attention_group, which attention_tc.cuh's core reads), and the att_fuse
// gate of the gated pair (gate_row; gate_kernel, a warp per token row).
//
// Every chain runs its products on hopper_gemm.cuh's wgmma + TMA engine
// (bf16) or on its int8 variant (hopper_gemm_s8.cuh, the W8A8 chain), and
// its attention core on attention_tc.cuh's tensor-core kernels: the pairs B1
// and B2 and B10's bf16 passes (pair_chain.cuh), the W8A8 pair B9 and B10's
// W8A8 passes (pair_q8_common.cuh), the pair backward B3, the attention and
// MLP blocks B4-B7, and the attention core alone B8.
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

// The N token rows of attention group g: the F frames of joint g % J of
// clip g / J ("temporal"), or the J joints of frame g ("spatial"), at rows
// base + t * stride of the flattened (B*F*J) token rows.
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

constexpr int GATE_THREADS = 256;

// att_fuse gate of one token row, a warp: s_k = other.wg[k, :C] + pair.wg[k,
// C:] + bg[k] in fp32, (a0, a1) = bf16(softmax(s)), out = bf16(bf16(other *
// a0) + bf16(pair * a1)). wg is the nn.Linear weight (2, 2C). pair(c) gives
// the pair's values at columns c and c + 1 (a lane takes two columns every
// 64), so the order of every sum is the same whatever holds the pair row.
template <class Pair>
__device__ __forceinline__ void gate_row(const bf16* __restrict__ o, const Pair& pair,
                                         const bf16* __restrict__ wg,
                                         const bf16* __restrict__ bg, bf16* __restrict__ dst,
                                         int C, int lane) {
    const bf16* w0 = wg;
    const bf16* w1 = wg + 2 * C;
    float s0a = 0.f, s1a = 0.f, s0b = 0.f, s1b = 0.f;
    for (int c = lane * 2; c < C; c += 64) {
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const bf162*>(o + c));
        const float2 uv = pair(c);
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
    for (int c = lane * 2; c < C; c += 64) {
        const float2 ov = __bfloat1622float2(*reinterpret_cast<const bf162*>(o + c));
        const float2 uv = pair(c);
        const float r0 = round_bf16(ov.x * a0) + round_bf16(uv.x * a1);
        const float r1 = round_bf16(ov.y * a0) + round_bf16(uv.y * a1);
        *reinterpret_cast<bf162*>(dst + c) = __floats2bfloat162_rn(r0, r1);
    }
}

// The gate on a pair output in device memory, one warp per token row.
__global__ void __launch_bounds__(GATE_THREADS)
gate_kernel(const bf16* __restrict__ other, const bf16* __restrict__ pair,
            const bf16* __restrict__ wg, const bf16* __restrict__ bg,
            bf16* __restrict__ out, int M, int C) {
    const int row = blockIdx.x * (GATE_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const bf16* u = pair + (size_t)row * C;
    gate_row(other + (size_t)row * C,
             [u](int c) { return __bfloat1622float2(*reinterpret_cast<const bf162*>(u + c)); },
             wg, bg, out + (size_t)row * C, C, lane);
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
