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
// its block-diagonal mask are not needed here. The GEMM and the attention core
// live in pair_common.cuh, which the backward (pair_bwd_kernels.cu) shares.
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

#include "pair_common.cuh"

namespace {

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
    const bool gated = other != nullptr;
    cudaError_t err;

    err = launch_gemm<NT, true, EPI_BIAS>(x, wqkv, bqkv, nullptr, ln1_w, ln1_b, nullptr,
                                          qkv, nullptr, M, 3 * C, C, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_attention_any(qkv, attn, B, F, J, C, H, scale, temporal, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<NT, false, EPI_BIAS_RES>(attn, wproj, bproj, x, nullptr, nullptr,
                                               nullptr, y, nullptr, M, C, C, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<NT, true, EPI_BIAS_GELU>(y, w1, b1, nullptr, ln2_w, ln2_b, nullptr,
                                               hid, nullptr, M, hidden, C, stream);
    if (err != cudaSuccess) return (int)err;
    err = launch_gemm<NT, false, EPI_BIAS_RES>(hid, w2, b2, y, nullptr, nullptr, nullptr,
                                               gated ? pair_out : out, nullptr, M, C,
                                               hidden, stream);
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
