// One DSTformer stream for NVIDIA Hopper (sm_90a): both attention+MLP pairs of
// a stream, in the order spatial -> temporal or temporal -> spatial, and in the
// gated variant the att_fuse gate against the twin stream, in bf16 or in the
// W8A8 tier. Built by motionbert_tpu_torch/ops/_build.py with nvcc and bound
// through a plain C interface (ctypes); see ops/fused_stream.py.
//
// Replaces the TPU kernel
//   motionbert_tpu/ops/fused_stream.py:_stream_pallas  (_stream_kernel; its public
//   functions fused_stream_block, fused_gated_stream_block and their _q8 twins)
// which computes, per clip of x (B, F, J, C):
//   mid = pair_1(x)                     rounded to bf16, as the pair path rounds it
//   out = pair_2(mid)                   or, gated, gate(other, pair_2(mid))
// with pair_k the bf16 pair of pair_kernels.cu or the W8A8 pair of
// pair_q8_kernels.cu, so the output is the B1 -> B1 (B1 -> B2) composition, or
// B9 -> B9, bit for bit.
//
// Design. The TPU kernel keeps the whole clip and both pairs' weights resident
// in VMEM, so the inter-pair activation never reaches HBM. On the H100 neither
// fits an SM: at the flagship shape the clip is 4.2 MB per (F, J*C) bf16 block
// and one pair's weights 4 MiB, against 227 KB of shared memory. So the stream
// runs both pairs' chains (pair_chain.cuh's pair_chain, pair_q8_common.cuh's
// q8_pair_chain) back to back on the caller's stream over one workspace: one
// set of chain scratch buffers serves both passes, the inter-pair activation
// lives in a workspace slot `mid` (never a tensor handed back to PyTorch), and
// in the gated variant pass 2 writes its pair output over `mid` (a pair's
// chain reads its input only before its last launch, which writes the
// output), so the stream needs one (M, C) buffer less than two pair calls.
// The launches, their kernels and their operands are the pair chains', which
// is what keeps the bits: the bf16 passes run the pair's products on
// hopper_gemm.cuh's wgmma + TMA engine, the W8A8 passes on its int8 variant
// (hopper_gemm_s8.cuh) between their quantisers, and both their core on
// attention_tc.cuh's tensor-core forward.
//
// Bound. The work is the two pairs' (plus the gate): at (4, 243, 17, 512),
// hidden 1024, about 0.149 ms of bf16 tensor-core operations for a temporal
// and a spatial pair, against ~0.013 ms for x, out and both pairs' weights:
// bound by operations, as each pair is. The stream saves only the inter-pair
// round trip through device memory (2 x 17 MB, ~10 us at 3.35 TB/s) and
// nothing of the pairs' own intermediates, so it runs at the pair chain's
// speed. Keeping the boundary on chip, or fusing across it, is later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include "pair_chain.cuh"
#include "pair_q8_common.cuh"

namespace {

PairParams pair_params(const void* const* p) {
    return PairParams{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
                      p[11]};
}

PairQ8Params pair_q8_params(const void* const* p) {
    return PairQ8Params{p[0], p[1], p[2],  p[3],  p[4],  p[5],  p[6],  p[7],
                        p[8], p[9], p[10], p[11], p[12], p[13], p[14], p[15]};
}

}  // namespace

// One stream (other == nullptr) or gated stream on x (B, F, J, C) bf16. p1 and
// p2: the 12 parameter pointers of pass 1 and pass 2 (PairParams order).
// first_temporal: 1 for the order temporal -> spatial, 0 for spatial ->
// temporal. Workspace from the caller: mid (M, C), qkv (M, 3C), attn (M, C),
// y (M, C), hid (M, hidden), all bf16. Returns 0 or the first CUDA error.
extern "C" int mbt_stream_block(
    const void* x, const void* other, void* out, void* mid,
    void* qkv, void* attn, void* y, void* hid,
    const void* const* p1, const void* const* p2, const void* wg, const void* bg,
    int B, int F, int J, int C, int H, int hidden, float scale, int first_temporal,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const bool gated = other != nullptr;
    cudaError_t err = pair_chain(x, mid, qkv, attn, y, hid, pair_params(p1), B, F, J, C, H,
                                 hidden, scale, first_temporal, stream);
    if (err != cudaSuccess) return (int)err;
    err = pair_chain(mid, gated ? mid : out, qkv, attn, y, hid, pair_params(p2), B, F, J, C,
                     H, hidden, scale, !first_temporal, stream);
    if (err != cudaSuccess) return (int)err;
    if (gated) err = launch_gate(other, mid, wg, bg, out, B * F * J, C, stream);
    return (int)err;
}

// The W8A8 stream: p1 and p2 hold the 16 pointers of each quantised pair
// (PairQ8Params order: the int8 weights and their fp32 scales from
// ops/pair_q8.py's quant_cols). Workspace: mid (M, C) bf16, a8 (M, max(C,
// hidden)) int8, ascale (M,) fp32, qkv (M, 3C), attn (M, C), y (M, C) bf16,
// act (M, hidden) fp32. Returns 0 or the first CUDA error.
extern "C" int mbt_stream_block_q8(
    const void* x, const void* other, void* out, void* mid,
    void* a8, void* ascale, void* qkv, void* attn, void* y, void* act,
    const void* const* p1, const void* const* p2, const void* wg, const void* bg,
    int B, int F, int J, int C, int H, int hidden, float scale, int first_temporal,
    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const bool gated = other != nullptr;
    cudaError_t err = q8_pair_chain(x, mid, a8, ascale, qkv, attn, y, act, pair_q8_params(p1),
                                    B, F, J, C, H, hidden, scale, first_temporal, stream);
    if (err != cudaSuccess) return (int)err;
    err = q8_pair_chain(mid, gated ? mid : out, a8, ascale, qkv, attn, y, act,
                        pair_q8_params(p2), B, F, J, C, H, hidden, scale, !first_temporal,
                        stream);
    if (err != cudaSuccess) return (int)err;
    if (gated) err = launch_gate(other, mid, wg, bg, out, B * F * J, C, stream);
    return (int)err;
}
