// Fused DSTformer attention+MLP pair for NVIDIA Hopper (sm_90a), bf16 with
// fp32 accumulation. Built by motionbert_tpu_torch/ops/_build.py with nvcc and
// bound through a plain C interface (ctypes); see ops/fused_pair.py.
//
// Replaces the TPU kernels
//   motionbert_tpu/ops/fused_pair.py:_pair_pallas       (_pair_kernel / _pair_rows)
//   motionbert_tpu/ops/fused_pair.py:fused_gated_pair_block (_gated_pair_kernel / _gate_rows)
// which compute, per token row of x (B, F, J, C):
//   y   = x + proj(attn(qkv(LN1 x)))        y rounded to bf16 -> yb
//   out = yb + fc2(GELU(fc1(LN2 yb)))
//   gated: out <- other * a0 + out * a1, (a0, a1) = softmax(other.wg[:, :C] + out.wg[:, C:] + bg)
// with attention over the F frames of one joint ("temporal") or the J joints
// of one frame ("spatial").
//
// Design. The TPU kernel keeps all 4 MiB of a pair's bf16 weights resident in
// VMEM and runs the whole pair per (batch block, tile). 227 KB of shared memory
// cannot hold that, so the pair runs here as a chain of five launches (six when
// gated) over the flattened token rows (M = B*F*J, C):
//   1. gemm<LN, BIAS>       qkv  = bf16(LN1(x) @ Wqkv^T + bqkv)      LN in the A-tile prologue
//   2. attention<D>         attn = bf16(softmax(q k^T * scale) v)   one block per (group, head)
//   3. gemm<-, BIAS_RES>    y    = bf16(attn @ Wproj^T + bproj + x)
//   4. gemm<LN, BIAS_GELU>  hid  = bf16(GELU(LN2(y) @ W1^T + b1))
//   5. gemm<-, BIAS_RES>    out  = bf16(hid @ W2^T + b2 + y)
//   6. gate                 (gated only) per-row 2-way softmax mix
// The rounding points are the TPU kernel's: qkv, P, the attention output, y and
// the hidden activation are bf16; every sum is fp32; LN statistics are fp32
// with var = E[x^2] - mean^2 and eps 1e-6; GELU is the exact erf form.
// Spatial groups are the 17 joints of one frame, so the TPU's 8-frame tile and
// its block-diagonal mask are not needed here.
//
// Bound. At the flagship shape (C 512, hidden 1024, F 243) a pair does about
// 4.2 MFLOP per token in the four products and 0.5 MFLOP per token in temporal
// attention, against 2 KB of token input and output: far above the H100's
// ~295 FLOP/byte ridge, so the pair is bound by tensor-core operations. This
// first design spends bytes to stay simple: the chain writes qkv, attn, y and
// hid to device memory (~20 KB of reads and writes per token), the GEMM uses
// WMMA (mma.sync) with 64x64x32 tiles and no cp.async pipeline, and the
// attention core runs in fp32 on CUDA cores, so the chain sits well short of
// that bound. Tensor-core attention, wgmma, TMA and keeping the chain on chip
// are later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;   // bf16 row stride of the A/B tiles (80 bytes)
constexpr int LDC = BN + 4;   // fp32 row stride of the accumulator tile
constexpr int GEMM_THREADS = 128;
constexpr int ATTN_THREADS = 256;
constexpr int GATE_THREADS = 256;
constexpr float LN_EPS = 1e-6f;

enum Epilogue { EPI_BIAS = 0, EPI_BIAS_RES = 1, EPI_BIAS_GELU = 2 };

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

// out[M, N] = epilogue(prologue(A)[M, K] @ W[N, K]^T + bias[N] (+ R[M, N]))
// A, W, R, out row-major bf16; W is the nn.Linear weight (out, in). With LN the
// A rows are layer-normalised (fp32 statistics, ln_w/ln_b fp32) and rounded to
// bf16 as they enter shared memory. Needs N % 64 == 0 and K % 32 == 0.
template <bool LN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, const bf16* __restrict__ R,
            const float* __restrict__ ln_w, const float* __restrict__ ln_b,
            bf16* __restrict__ out, int M, int N, int K) {
    __shared__ __align__(128) bf16 As[BM * LDS];
    __shared__ __align__(128) bf16 Bs[BN * LDS];
    __shared__ __align__(128) float Cs[BM * LDC];
    __shared__ float mean_s[BM];
    __shared__ float rstd_s[BM];

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    if (LN) {
        for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
            const int m = m0 + r;
            float s = 0.f, ss = 0.f;
            if (m < M) {
                const bf16* row = A + (size_t)m * K;
                for (int k = lane * 2; k < K; k += 64) {
                    const float2 v = __bfloat1622float2(
                        *reinterpret_cast<const bf162*>(row + k));
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

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

    for (int k0 = 0; k0 < K; k0 += BK) {
        // A tile: BM rows x BK cols as 16-byte chunks of 8 bf16
        for (int c = tid; c < BM * (BK / 8); c += GEMM_THREADS) {
            const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
            const int m = m0 + r;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
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
        // B tile: BN weight rows x BK cols
        for (int c = tid; c < BN * (BK / 8); c += GEMM_THREADS) {
            const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
            *reinterpret_cast<uint4*>(Bs + r * LDS + kc) =
                *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 + kc);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(a[i], As + (wm + i * 16) * LDS + kk, LDS);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * LDS + kk, LDS);
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
        const int m = m0 + r;
        if (m >= M) continue;
        const int n = n0 + c;
        const float2 bv = __bfloat1622float2(*reinterpret_cast<const bf162*>(bias + n));
        float v0 = Cs[r * LDC + c] + bv.x;
        float v1 = Cs[r * LDC + c + 1] + bv.y;
        if (EPI == EPI_BIAS_RES) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const bf162*>(R + (size_t)m * N + n));
            v0 += rv.x;
            v1 += rv.y;
        }
        if (EPI == EPI_BIAS_GELU) {
            v0 = 0.5f * v0 * (1.f + erff(v0 * 0.70710678118654752f));
            v1 = 0.5f * v1 * (1.f + erff(v1 * 0.70710678118654752f));
        }
        *reinterpret_cast<bf162*>(out + (size_t)m * N + n) = __floats2bfloat162_rn(v0, v1);
    }
}

// Attention core over one (group, head) per block. qkv is (M, 3C) bf16 with
// [q | k | v] each split into H heads of D; the group's N tokens sit at rows
// base + t * stride. K and V of the group stay in shared memory (row stride
// D + 2 so lanes reading different keys hit different banks); each warp owns
// one query row at a time: fp32 scores, max-subtracted fp32 softmax, P rounded
// to bf16, fp32 P.V, bf16 output.
template <int D>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                 int F, int J, int C, float scale, int temporal) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int LDK = D + 2;
    const int g = blockIdx.x, h = blockIdx.y;
    int N, base, stride;
    if (temporal) {
        const int b = g / J, j = g % J;
        N = F;
        base = b * F * J + j;
        stride = J;
    } else {
        N = J;
        base = g * J;
        stride = 1;
    }
    const int nwarps = ATTN_THREADS / 32;
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + N * LDK;
    float* Ps = reinterpret_cast<float*>(Vs + N * LDK);
    const size_t C3 = 3 * (size_t)C;

    for (int idx = threadIdx.x; idx < N * (D / 2); idx += ATTN_THREADS) {
        const int t = idx / (D / 2), c = (idx % (D / 2)) * 2;
        const bf16* row = qkv + (size_t)(base + t * stride) * C3 + h * D + c;
        *reinterpret_cast<bf162*>(Ks + t * LDK + c) =
            *reinterpret_cast<const bf162*>(row + C);
        *reinterpret_cast<bf162*>(Vs + t * LDK + c) =
            *reinterpret_cast<const bf162*>(row + 2 * C);
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* p = Ps + warp * N;
    for (int i = warp; i < N; i += nwarps) {
        const size_t qrow = (size_t)(base + i * stride);
        const bf16* qp = qkv + qrow * C3 + h * D;
        float q[D];
#pragma unroll
        for (int c = 0; c < D; c += 2) {
            const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(qp + c));
            q[c] = v.x;
            q[c + 1] = v.y;
        }
        float mx = __int_as_float(0xff800000);  // -inf
        for (int m = lane; m < N; m += 32) {
            const bf16* kr = Ks + m * LDK;
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < D; c += 2) {
                const float2 kv = __bfloat1622float2(*reinterpret_cast<const bf162*>(kr + c));
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
                const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(Vs + m * LDK + c));
                a0 += pm * v.x;
                a1 += pm * v.y;
            }
            *reinterpret_cast<bf162*>(out + qrow * C + h * D + c) = __floats2bfloat162_rn(a0, a1);
        }
        __syncwarp();
    }
}

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

template <bool LN, int EPI>
cudaError_t launch_gemm(const void* A, const void* W, const void* bias, const void* R,
                        const void* ln_w, const void* ln_b, void* out, int M, int N, int K,
                        cudaStream_t stream) {
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    gemm_kernel<LN, EPI><<<grid, GEMM_THREADS, 0, stream>>>(
        static_cast<const bf16*>(A), static_cast<const bf16*>(W),
        static_cast<const bf16*>(bias), static_cast<const bf16*>(R),
        static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
        static_cast<bf16*>(out), M, N, K);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_attention(const void* qkv, void* out, int B, int F, int J, int C,
                             float scale, int temporal, cudaStream_t stream) {
    const int N = temporal ? F : J;
    const size_t smem = 2 * (size_t)N * (D + 2) * sizeof(bf16)
                      + (size_t)(ATTN_THREADS / 32) * N * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(temporal ? B * J : B * F, C / D);
    attention_kernel<D><<<grid, ATTN_THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), F, J, C, scale, temporal);
    return cudaGetLastError();
}

}  // namespace

// One pair (other == nullptr) or gated pair on x (B, F, J, C) bf16. Scratch
// buffers come from the caller: qkv (M, 3C), attn (M, C), y (M, C),
// hid (M, hidden), and pair_out (M, C) when gated; all bf16. Returns 0 or the
// first CUDA error.
extern "C" int mbt_pair_block(
    const void* x, const void* other, void* out,
    void* qkv, void* attn, void* y, void* hid, void* pair_out,
    const void* ln1_w, const void* ln1_b, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* ln2_w, const void* ln2_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* wg, const void* bg,
    int B, int F, int J, int C, int H, int hidden, float scale, int temporal,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = B * F * J;
    const int D = C / H;
    const bool gated = other != nullptr;
    cudaError_t err;

    err = launch_gemm<true, EPI_BIAS>(x, wqkv, bqkv, nullptr, ln1_w, ln1_b, qkv,
                                      M, 3 * C, C, stream);
    if (err != cudaSuccess) return (int)err;
    if (D == 64)
        err = launch_attention<64>(qkv, attn, B, F, J, C, scale, temporal, stream);
    else if (D == 32)
        err = launch_attention<32>(qkv, attn, B, F, J, C, scale, temporal, stream);
    else
        err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<false, EPI_BIAS_RES>(attn, wproj, bproj, x, nullptr, nullptr, y,
                                           M, C, C, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<true, EPI_BIAS_GELU>(y, w1, b1, nullptr, ln2_w, ln2_b, hid,
                                           M, hidden, C, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<false, EPI_BIAS_RES>(hid, w2, b2, y, nullptr, nullptr,
                                           gated ? pair_out : out, M, C, hidden, stream);
    if (err != cudaSuccess) return (int)err;
    if (gated) {
        const int blocks = (M + GATE_THREADS / 32 - 1) / (GATE_THREADS / 32);
        gate_kernel<<<blocks, GATE_THREADS, 0, stream>>>(
            static_cast<const bf16*>(other), static_cast<const bf16*>(pair_out),
            static_cast<const bf16*>(wg), static_cast<const bf16*>(bg),
            static_cast<bf16*>(out), M, C);
        err = cudaGetLastError();
    }
    return (int)err;
}
