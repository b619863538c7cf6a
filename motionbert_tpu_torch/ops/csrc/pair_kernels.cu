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
// cannot hold that, so the pair runs here as a chain of seven launches (eight
// when gated) over the flattened token rows (M = B*F*J, C), pair_chain.cuh's
// pair_chain, which the bf16 stream (stream_kernels.cu) runs twice:
//   1. ln_fwd_rows              h1   = bf16(LN1(x))                   a warp per row
//   2. hg_gemm<NT, BIAS>        qkv  = bf16(h1 @ Wqkv^T + bqkv)
//   3. attn_tc_fwd_kernel       attn = bf16(bf16(softmax(q k^T * scale)) v)
//   4. hg_gemm<NT, BIAS_RES>    y    = bf16(attn @ Wproj^T + bproj + x)
//   5. ln_fwd_rows              h2   = bf16(LN2(y))
//   6. hg_gemm<NT, BIAS_GELU>   hid  = bf16(GELU(h2 @ W1^T + b1))
//   7. hg_gemm<NT, BIAS_RES>    out  = bf16(hid @ W2^T + b2 + y)
//   8. gate                     (gated only) per-row 2-way softmax mix
// The rounding points are the TPU kernel's: h1, h2, qkv, P, the attention
// output, y and the hidden activation are bf16; every sum is fp32; LN
// statistics are fp32 with var = E[x^2] - mean^2 and eps 1e-6; GELU is the
// exact erf form. Spatial groups are the 17 joints of one frame, so the
// TPU's 8-frame tile and its block-diagonal mask are not needed here.
//
// Bound. At the flagship shape (C 512, hidden 1024, F 243) a pair does about
// 4.2 MFLOP per token in the four products and 0.5 MFLOP per token in temporal
// attention, against 2 KB of token input and output: far above the H100's
// ~295 FLOP/byte ridge, so the pair is bound by tensor-core operations
// (0.078 ms temporal, 0.071 spatial at (4, 243, 17, 512)). The four products
// run on hopper_gemm.cuh, the wgmma + TMA engine (128 x 128 tiles from a
// three-stage TMA ring, two consumer warpgroups, the bias, residual and GELU
// epilogues on the register fragments, persistent blocks two an SM); the
// core on attention_tc.cuh's mma.sync kernel (a group's q, k, v in shared
// memory, a warp's 16 query rows' scores against every key in registers);
// the LayerNorms as row passes, because a TMA load cannot normalise on its
// way in. What the chain does not do is keep its intermediates on chip: it
// writes h1, qkv, attn, y, h2 and hid to device memory and reads them back
// (~21 KB of reads and writes per token row), which keeps the products'
// operands in the TMA's reach and the launches simple. The engine reads x
// (proj's residual) and the weights through TMA boxes or vector loads, so
// the wrapper requires 16-byte-aligned x and weights.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include "pair_chain.cuh"

// One pair (other == nullptr) or gated pair on x (B, F, J, C) bf16. Scratch
// buffers come from the caller: qkv (M, 3C), attn (M, C), y (M, C),
// hid (M, hidden), and pair_out (M, C) when gated; all bf16. x and the
// weights and biases 16-byte aligned. Returns 0 or the first CUDA error
// (cudaErrorInvalidValue for an address the engine's TMA cannot take).
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
    const bool gated = other != nullptr;
    const PairParams p{ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2};
    cudaError_t err = pair_chain(x, gated ? pair_out : out, qkv, attn, y, hid, p, B, F, J, C,
                                 H, hidden, scale, temporal, stream);
    if (err != cudaSuccess) return (int)err;
    if (gated) err = launch_gate(other, pair_out, wg, bg, out, B * F * J, C, stream);
    return (int)err;
}
