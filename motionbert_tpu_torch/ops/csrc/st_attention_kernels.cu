// The standalone spatio-temporal attention core for NVIDIA Hopper (sm_90a),
// bf16 with fp32 accumulation: softmax(q k^T * scale) v per head over the F
// frames of one joint ("temporal") or the J joints of one frame ("spatial"),
// on separate q, k and v in the (B, F, J, C) layout. Built by
// motionbert_tpu_torch/ops/_build.py with nvcc and bound through a plain C
// interface (ctypes); see ops/attention.py (st_attention, StAttention). The
// model runs it in the legacy attention modes (vanilla, series, parallel),
// where the projections stay outside the kernel.
//
// Replaces the TPU kernels
//   motionbert_tpu/ops/attention.py:_temporal_pallas  (_temporal_kernel)
//   motionbert_tpu/ops/attention.py:_spatial_pallas   (_spatial_kernel)
// reached through motionbert_tpu/ops/attention.py:_attention_fused. Their
// backward is analytic XLA there and plain PyTorch in the port.
//
// Design. This is the chains' tensor-core core (attention_tc.cuh's
// attn_tc_fwd_kernel, which the pairs B1/B2/B9, the block B4 and the pair
// and block backwards' recompute run) on its own: TcArgs takes three
// row-strided pointers, so the chains pass their packed qkv as (qkv, qkv +
// C, qkv + 2C, 3C) and this entry point separate q, k, v of row stride ld
// (C for contiguous tensors, 3C for slices of a packed projection). A block
// takes 8 / KT (group, head) items of 16 KT padded rows (KT key tiles of
// 16, a power of two from the group size: 16 for 243 frames, 2 for the 17
// joints of a frame), copies their q, k, v rows into shared memory with
// 16-byte cp.async, and its eight warps each take 16 query rows against
// every key with mma.sync m16n8k16 fed by ldmatrix: fp32 scores, a
// max-subtracted fp32 softmax held in registers, P normalised and then
// rounded to bf16, P.V in fp32, the output in bf16, as the TPU kernels
// round. So the TPU's 8-frame spatial tile, its block-diagonal same-frame
// mask and its masked tail tile are layout and have no counterpart.
//
// Bound. At (4, 243, 17, 512), 8 heads, the four (B, F, J, C) bf16 tensors
// are 67.7 MB, 0.020 ms at 3.35 TB/s, against 8.2 GFLOP (temporal) or 0.58
// GFLOP (spatial) of products: 0.0083 ms at the bf16 tensor-core peak, so
// both modes are bound by bytes. The core reads q, k and v once and writes
// the output once; its time goes to the softmax's elementwise work and to
// mma.sync latency at eight warps an SM (one 243-frame item a block), so it
// sits short of that bound (PERF.md, kernel B8). The 16-byte copies need
// 16-byte-aligned q, k, v and a row stride of a multiple of 8 elements.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include "attention_tc.cuh"

// q, k, v: B*F*J bf16 rows of row stride ld, C channels each (H heads of D =
// C / H, D 32 or 64), groups of 1..256 rows; out: B*F*J contiguous bf16 rows
// of C. Returns 0 or the first CUDA error.
extern "C" int mbt_st_attention(
    const void* q, const void* k, const void* v, int ld, void* out,
    int B, int F, int J, int C, int H, float scale, int temporal,
    void* stream_ptr) {
    TcArgs a{};
    a.q = q;
    a.k = k;
    a.v = v;
    a.ld = ld;
    a.out = out;
    a.ld_out = C;
    a.B = B, a.F = F, a.J = J, a.C = C, a.H = H;
    a.scale = scale;
    a.temporal = temporal;
    return (int)launch_attention_tc(a, false, static_cast<cudaStream_t>(stream_ptr));
}
