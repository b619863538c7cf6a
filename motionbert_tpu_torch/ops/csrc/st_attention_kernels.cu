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
// Design. This is the attention core of the pair and block chains
// (attention_kernel<D> in pair_common.cuh) on its own: the core takes three
// row-strided pointers, so the chains pass their packed qkv as (qkv, qkv + C,
// qkv + 2C, 3C) and this entry point separate q, k, v of row stride ld (C for
// contiguous tensors, 3C for slices of a packed projection). One block per
// (group, head): temporal groups are the F <= 243 frames of a joint, spatial
// groups the 17 joints of a frame, so the TPU's 8-frame spatial tile, its
// block-diagonal same-frame mask and its masked tail tile are layout and have
// no counterpart. K and V of the group sit in shared memory; a warp per query
// row takes fp32 scores and a max-subtracted fp32 softmax, rounds P to bf16,
// and accumulates P.V in fp32; the output is bf16, as the TPU kernels round.
//
// Bound. At (4, 243, 17, 512), 8 heads, the four (B, F, J, C) bf16 tensors
// are 67.7 MB, 0.020 ms at 3.35 TB/s, against 8.2 GFLOP (temporal) or 0.58
// GFLOP (spatial) of products: 0.0083 ms at the bf16 tensor-core peak, so
// both modes are bound by bytes. This first design computes on CUDA cores in
// fp32 and reads K and V once per (group, head) block but q one row per warp;
// it sits well short of that bound. A tensor-core core (mma.sync or wgmma on
// Q K^T and P V) is the lever, shared with the pair chains.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include "pair_common.cuh"

// q, k, v: B*F*J bf16 rows of row stride ld, C channels each (H heads of D =
// C / H, D 32 or 64); out: B*F*J contiguous bf16 rows of C. Returns 0 or the
// first CUDA error.
extern "C" int mbt_st_attention(
    const void* q, const void* k, const void* v, int ld, void* out,
    int B, int F, int J, int C, int H, float scale, int temporal,
    void* stream_ptr) {
    return (int)launch_st_attention_any(q, k, v, ld, out, B, F, J, C, H, scale, temporal,
                                        static_cast<cudaStream_t>(stream_ptr));
}
