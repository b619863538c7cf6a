// Backward of the fused DSTformer attention+MLP pair (and of the pair with the
// att_fuse gate) for NVIDIA Hopper (sm_90a), bf16 with fp32 accumulation.
// Built by motionbert_tpu_torch/ops/_build.py with nvcc and bound through a
// plain C interface (ctypes); see ops/fused_pair.py (FusedPair,
// FusedGatedPair).
//
// Replaces the TPU kernel
//   motionbert_tpu/ops/fused_pair.py:_pair_bwd_pallas (_pair_bwd_kernel / _pair_bwd_body)
// which, given x, the output gradient g and the weights (and `other` when
// gated), recomputes the pair's forward and returns dx (+ dother) and the 12
// (+ 2) parameter gradients.
//
// Design. The TPU kernel runs the whole pair per (batch block, tile) with the
// weights resident in VMEM and accumulates the parameter gradients across its
// sequential grid. Neither carries over: 227 KB of shared memory cannot hold
// the weights, and blocks run in no order. So the backward is a chain of
// launches over the flattened token rows (M = B*F*J), in the order of
// _pair_bwd_body and at its rounding points:
//   recompute   ln_fwd_rows (h1 = bf16(LN1 x), row stats) -> NT gemm (qkv)
//               -> attention -> NT gemm + x (yb) -> ln_fwd_rows (h2)
//               -> NT gemm with GELU epilogue (bf16 a and fp32 z)
//   gate        NT gemm + yb (out_b) -> gate_bwd_rows (dother, gmlp, dsg)
//   MLP         TN dW2 = gmlp^T a; NN dz = bf16(gmlp W2 * GELU'(z));
//               TN dW1 = dz^T h2; NN dh2 = dz W1 (fp32);
//               ln_bwd_rows: dyb = bf16(LN2-backward(dh2) + gmlp)
//   attention   NN dattn = bf16(dyb Wproj); TN dWproj = dyb^T attn;
//               attention_bwd (fp32 and bf16 dqkv); TN dWqkv = bf16(dqkv)^T h1;
//               NN dh1 = bf16(dqkv) Wqkv (fp32);
//               ln_bwd_rows: dx = bf16(LN1-backward(dh1) + dyb)
//   biases, LN parameters and the gate weights: column sums.
// Every reduction over M is deterministic: the weight-gradient GEMMs and the
// column sums cut M into fixed chunks, write fp32 partials and add them in
// chunk order (reduce_splits_kernel); there are no float atomics, so two runs
// give the same bits.
//
// Bound. With the recompute, a call does about 3x the forward's four products
// plus 3x its attention: ~232.6 GFLOP for a temporal pair at (4, 243, 17,
// 512), hidden 1024, against ~60 MB of inputs and outputs, so tensor-core
// operations bound it (0.235 ms at 989 TFLOP/s). This first design stays
// simple instead: the chain writes its intermediates (~30 KB per token row)
// to device memory, the GEMMs are the forward's WMMA tiles without a copy
// pipeline, and the attention backward runs in fp32 on CUDA cores (per
// (group, head): a query-major pass for the row statistics and dq, then a
// key-major pass for dk and dv, so that no fp32 dK/dV accumulators of a
// 243-frame group need shared memory). wgmma, TMA and tensor-core attention
// are later work. The row, column-sum, weight-gradient and attention-backward
// kernels live in pair_bwd_common.cuh, which block_kernels.cu shares.
//
// The entry point launches on the caller's stream, allocates nothing (the
// caller passes every buffer) and returns 0 or the first CUDA error.

#include "pair_bwd_common.cuh"

namespace {

// Buffer slots of mbt_pair_block_bwd's pointer array; ops/fused_pair.py
// lists the same names in the same order (BWD_SLOTS).
enum Slot {
    // inputs
    S_X, S_OTHER, S_G, S_LN1_W, S_LN1_B, S_WQKV, S_BQKV, S_WPROJ, S_BPROJ,
    S_LN2_W, S_LN2_B, S_W1, S_B1, S_W2, S_B2, S_WG, S_BG,
    // outputs
    S_DX, S_DOTHER, S_DLN1_W, S_DLN1_B, S_DWQKV, S_DBQKV, S_DWPROJ, S_DBPROJ,
    S_DLN2_W, S_DLN2_B, S_DW1, S_DB1, S_DW2, S_DB2, S_DWG, S_DBG,
    // scratch
    S_H1, S_ST1, S_QKV, S_ATTN, S_YB, S_H2, S_ST2, S_Z, S_A, S_OUTB, S_GMLP,
    S_DSG, S_DH, S_DYB, S_DQKV, S_DQKVB, S_WORK,
    S_COUNT
};

}  // namespace

extern "C" int mbt_pair_bwd_slot_count() { return S_COUNT; }

// Floats of fp32 workspace the weight-gradient and column-sum partials need.
extern "C" long long mbt_pair_bwd_work_floats(int C, int hidden) {
    const long long wmax = (long long)(3 * C > hidden ? 3 * C : hidden) * C;
    const long long cmax = (long long)(3 * C > hidden ? 3 * C : hidden);
    const long long a = TN_SPLITS * wmax, b = COL_SPLITS * cmax;
    return a > b ? a : b;
}

// Pair backward (p[S_OTHER] == nullptr) or gated pair backward on x
// (B, F, J, C) bf16 and the output gradient g. p holds S_COUNT device
// pointers in Slot order; scratch shapes (M = B*F*J rows): h1, attn, yb, h2,
// out_b, gmlp, dyb (M, C) bf16; qkv, dqkvb (M, 3C) bf16; a (M, hidden) bf16;
// z (M, hidden) fp32; dh (M, C) fp32; dqkv (M, 3C) fp32; st1, st2 (M, 2)
// fp32; dsg (M, 2) fp32; work mbt_pair_bwd_work_floats() fp32. Outputs:
// dx, dother bf16 (M, C); weight and bias gradients bf16; LayerNorm
// gradients fp32. Returns 0 or the first CUDA error.
extern "C" int mbt_pair_block_bwd(void* const* p, int B, int F, int J, int C, int H,
                                  int hidden, float scale, int temporal,
                                  void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = B * F * J;
    const bool gated = p[S_OTHER] != nullptr;
    const int row_blocks = (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
    float* work = static_cast<float*>(p[S_WORK]);
    // reused buffers: a is dead once dW2 is taken, h2 once dW1 is
    void* dz = p[S_A];
    void* dattn = p[S_H2];

    // ---- forward recompute ----
    ln_fwd_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(
        static_cast<const bf16*>(p[S_X]), static_cast<const float*>(p[S_LN1_W]),
        static_cast<const float*>(p[S_LN1_B]), static_cast<bf16*>(p[S_H1]),
        static_cast<float2*>(p[S_ST1]), M, C);
    CHECK(cudaGetLastError());
    CHECK((launch_gemm<NT, false, EPI_BIAS>(p[S_H1], p[S_WQKV], p[S_BQKV], nullptr, nullptr,
                                            nullptr, nullptr, p[S_QKV], nullptr, M, 3 * C,
                                            C, stream)));
    CHECK(launch_attention_any(p[S_QKV], p[S_ATTN], B, F, J, C, H, scale, temporal, stream));
    CHECK((launch_gemm<NT, false, EPI_BIAS_RES>(p[S_ATTN], p[S_WPROJ], p[S_BPROJ], p[S_X],
                                                nullptr, nullptr, nullptr, p[S_YB], nullptr,
                                                M, C, C, stream)));
    ln_fwd_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(
        static_cast<const bf16*>(p[S_YB]), static_cast<const float*>(p[S_LN2_W]),
        static_cast<const float*>(p[S_LN2_B]), static_cast<bf16*>(p[S_H2]),
        static_cast<float2*>(p[S_ST2]), M, C);
    CHECK(cudaGetLastError());
    CHECK((launch_gemm<NT, false, EPI_BIAS_GELU_Z>(p[S_H2], p[S_W1], p[S_B1], nullptr,
                                                   nullptr, nullptr, nullptr, p[S_A],
                                                   p[S_Z], M, hidden, C, stream)));

    // ---- att_fuse gate backward ----
    const void* gm = p[S_G];
    if (gated) {
        CHECK((launch_gemm<NT, false, EPI_BIAS_RES>(p[S_A], p[S_W2], p[S_B2], p[S_YB],
                                                    nullptr, nullptr, nullptr, p[S_OUTB],
                                                    nullptr, M, C, hidden, stream)));
        gate_bwd_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(
            static_cast<const bf16*>(p[S_OTHER]), static_cast<const bf16*>(p[S_OUTB]),
            static_cast<const bf16*>(p[S_G]), static_cast<const bf16*>(p[S_WG]),
            static_cast<const bf16*>(p[S_BG]), static_cast<bf16*>(p[S_DOTHER]),
            static_cast<bf16*>(p[S_GMLP]), static_cast<float*>(p[S_DSG]), M, C);
        CHECK(cudaGetLastError());
        gm = p[S_GMLP];
        const float* dsg = static_cast<const float*>(p[S_DSG]);
        bf16* dwg = static_cast<bf16*>(p[S_DWG]);
        for (int k = 0; k < 2; ++k) {
            CHECK(column_sum<COL_GATE>(p[S_OTHER], nullptr, nullptr, dsg + k, M, C, work,
                                       dwg + (size_t)k * 2 * C, true, stream));
            CHECK(column_sum<COL_GATE>(p[S_OUTB], nullptr, nullptr, dsg + k, M, C, work,
                                       dwg + (size_t)k * 2 * C + C, true, stream));
        }
        CHECK(column_sum<COL_F32>(dsg, nullptr, nullptr, nullptr, M, 2, work, p[S_DBG],
                                  true, stream));
    }

    // ---- MLP backward ----
    CHECK(weight_grad(gm, p[S_A], M, C, hidden, work, p[S_DW2], stream));
    CHECK(column_sum<COL_BF16>(gm, nullptr, nullptr, nullptr, M, C, work, p[S_DB2], true,
                               stream));
    CHECK((launch_gemm<NN, false, EPI_DGELU>(gm, p[S_W2], nullptr, nullptr, nullptr, nullptr,
                                             p[S_Z], dz, nullptr, M, hidden, C, stream)));
    CHECK(weight_grad(dz, p[S_H2], M, hidden, C, work, p[S_DW1], stream));
    CHECK(column_sum<COL_BF16>(dz, nullptr, nullptr, nullptr, M, hidden, work, p[S_DB1],
                               true, stream));
    CHECK((launch_gemm<NN, false, EPI_F32>(dz, p[S_W1], nullptr, nullptr, nullptr, nullptr,
                                           nullptr, p[S_DH], nullptr, M, C, hidden,
                                           stream)));
    CHECK(column_sum<COL_F32>(p[S_DH], nullptr, nullptr, nullptr, M, C, work, p[S_DLN2_B],
                              false, stream));
    CHECK(column_sum<COL_LN_W>(p[S_DH], p[S_YB], p[S_ST2], nullptr, M, C, work, p[S_DLN2_W],
                               false, stream));
    ln_bwd_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(
        static_cast<const float*>(p[S_DH]), static_cast<const bf16*>(p[S_YB]),
        static_cast<const float2*>(p[S_ST2]), static_cast<const float*>(p[S_LN2_W]),
        static_cast<const bf16*>(gm), static_cast<bf16*>(p[S_DYB]), M, C);
    CHECK(cudaGetLastError());

    // ---- attention backward ----
    CHECK((launch_gemm<NN, false, EPI_BF16>(p[S_DYB], p[S_WPROJ], nullptr, nullptr, nullptr,
                                            nullptr, nullptr, dattn, nullptr, M, C, C,
                                            stream)));
    CHECK(weight_grad(p[S_DYB], p[S_ATTN], M, C, C, work, p[S_DWPROJ], stream));
    CHECK(column_sum<COL_BF16>(p[S_DYB], nullptr, nullptr, nullptr, M, C, work, p[S_DBPROJ],
                               true, stream));
    CHECK(launch_attention_bwd_any(p[S_QKV], dattn, p[S_DQKV], p[S_DQKVB], B, F, J, C, H,
                                   scale, temporal, stream));
    CHECK(weight_grad(p[S_DQKVB], p[S_H1], M, 3 * C, C, work, p[S_DWQKV], stream));
    CHECK(column_sum<COL_F32>(p[S_DQKV], nullptr, nullptr, nullptr, M, 3 * C, work,
                              p[S_DBQKV], true, stream));
    CHECK((launch_gemm<NN, false, EPI_F32>(p[S_DQKVB], p[S_WQKV], nullptr, nullptr, nullptr,
                                           nullptr, nullptr, p[S_DH], nullptr, M, C, 3 * C,
                                           stream)));
    CHECK(column_sum<COL_F32>(p[S_DH], nullptr, nullptr, nullptr, M, C, work, p[S_DLN1_B],
                              false, stream));
    CHECK(column_sum<COL_LN_W>(p[S_DH], p[S_X], p[S_ST1], nullptr, M, C, work, p[S_DLN1_W],
                               false, stream));
    ln_bwd_rows_kernel<<<row_blocks, ROW_THREADS, 0, stream>>>(
        static_cast<const float*>(p[S_DH]), static_cast<const bf16*>(p[S_X]),
        static_cast<const float2*>(p[S_ST1]), static_cast<const float*>(p[S_LN1_W]),
        static_cast<const bf16*>(p[S_DYB]), static_cast<bf16*>(p[S_DX]), M, C);
    return (int)cudaGetLastError();
}
