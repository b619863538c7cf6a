// The standalone DSTformer sub-blocks, forward and backward, for NVIDIA Hopper
// (sm_90a), bf16 with fp32 accumulation: the attention block
//   out = [x +] proj(attn(qkv([LN] x)))
// and the MLP block
//   out = [x +] fc2(GELU(fc1([LN] x)))
// which the model runs instead of the fused pair when dropout or drop-path is
// live in training. Built by motionbert_tpu_torch/ops/_build.py with nvcc and
// bound through a plain C interface (ctypes); see ops/attention.py
// (FusedAttentionBlock) and ops/fused_mlp.py (FusedMlpBlock).
//
// Replaces the TPU kernels
//   motionbert_tpu/ops/attention.py:_fused_block_pallas      (_fused_block_kernel)
//   motionbert_tpu/ops/attention.py:_fused_block_bwd_pallas  (_fused_block_bwd_kernel)
//   motionbert_tpu/ops/fused_mlp.py:_fused_mlp_pallas        (_fused_mlp_kernel)
//   motionbert_tpu/ops/fused_mlp.py:_fused_mlp_bwd_pallas    (_fused_mlp_bwd_kernel)
//
// Design. The TPU kernels keep a block's weights (2 MiB in bf16 at the
// flagship widths) resident in VMEM, run one program per (batch block, tile)
// and accumulate the parameter gradients across a sequential grid. 227 KB of
// shared memory cannot hold the weights and thread blocks run in no order, so
// each entry point is a chain of launches over the flattened token rows
// (M = B*F*J for attention, any row count for the MLP), from the templates the
// pair kernels use (pair_common.cuh, pair_bwd_common.cuh), at the TPU
// kernels' rounding points:
//   attention forward   NT gemm [LN prologue] (qkv, bf16) -> attention
//                       -> NT gemm + bias [+ x]
//   attention backward  [ln_fwd_rows (h, row stats)] -> NT gemm (qkv)
//                       -> attention; NN dattn = bf16(g Wproj);
//                       TN dWproj = g^T attn; attention_bwd (fp32 and bf16
//                       dqkv); TN dWqkv = bf16(dqkv)^T h; dbqkv from the fp32
//                       dqkv; NN dh = bf16(dqkv) Wqkv;
//                       with LN: ln_bwd_rows dx = bf16(LN-backward(dh) [+ g]),
//                       without: dx = bf16(dh [+ g]) in the GEMM's epilogue
//   MLP forward         NT gemm [LN prologue] + GELU (bf16) -> NT gemm + bias [+ x]
//   MLP backward        [ln_fwd_rows] -> NT gemm + GELU (bf16 a, fp32 z);
//                       TN dW2 = g^T a; NN dz = bf16(g W2 * GELU'(z));
//                       TN dW1 = dz^T h; db1 from the rounded dz;
//                       NN dh = dz W1; dx as for attention
// Spatial groups are the 17 joints of one frame; the TPU's 8-frame tile, its
// same-frame mask and its zeroed tail rows are layout and have no counterpart.
// GELU is the exact erff form (the TPU kernel approximates erf with a
// polynomial, |error| <= 1.5e-7, because its compiler has none). Every
// reduction over the rows goes through fixed chunks and a second pass, without
// atomics, so two runs give the same bits.
//
// Bound. At (4, 243, 17, 512), 8 heads, hidden 1024, the attention block does
// 42.9 GFLOP (temporal) and the MLP block 34.7 GFLOP against ~36 MB of inputs
// and outputs: tensor-core operations bound both. As with the pair, this
// first design writes its intermediates to device memory and its GEMMs are
// WMMA tiles without a copy pipeline; it sits well short of that bound.
//
// Every entry point launches on the caller's stream, allocates nothing (the
// caller passes every buffer) and returns 0 or the first CUDA error.

#include "pair_bwd_common.cuh"

namespace {

// Pointer slots of mbt_attention_block_bwd; ops/attention.py lists the same
// names in the same order (ATTN_BWD_SLOTS).
enum AttnSlot {
    // inputs
    A_X, A_G, A_LN_W, A_LN_B, A_WQKV, A_BQKV, A_WPROJ,
    // outputs
    A_DX, A_DLN_W, A_DLN_B, A_DWQKV, A_DBQKV, A_DWPROJ, A_DBPROJ,
    // scratch
    A_H, A_ST, A_QKV, A_ATTN, A_DATTN, A_DQKV, A_DQKVB, A_DH, A_WORK,
    A_COUNT
};

// Pointer slots of mbt_mlp_block_bwd; ops/fused_mlp.py lists the same names
// in the same order (MLP_BWD_SLOTS).
enum MlpSlot {
    // inputs
    M_X, M_G, M_LN_W, M_LN_B, M_W1, M_B1, M_W2,
    // outputs
    M_DX, M_DLN_W, M_DLN_B, M_DW1, M_DB1, M_DW2, M_DB2,
    // scratch
    M_H, M_ST, M_Z, M_A, M_DZ, M_DH, M_WORK,
    M_COUNT
};

// dx from dh = dY W (NN product of dY (M, N) bf16 with the nn.Linear weight
// W (N, C)). With LN: fp32 dh, the LayerNorm parameter gradients, then the
// row backward [+ g]. Without: the product's epilogue writes bf16(dh [+ g]).
cudaError_t input_grad(const void* dY, const void* W, int M, int C, int N, bool use_ln,
                       bool residual, const void* x, const void* g, const void* stats,
                       const void* ln_w, void* dh, float* work, void* dln_w, void* dln_b,
                       void* dx, cudaStream_t stream) {
    cudaError_t err;
    if (!use_ln) {
        if (residual)
            return launch_gemm<NN, false, EPI_RES>(dY, W, nullptr, g, nullptr, nullptr,
                                                   nullptr, dx, nullptr, M, C, N, stream);
        return launch_gemm<NN, false, EPI_BF16>(dY, W, nullptr, nullptr, nullptr, nullptr,
                                                nullptr, dx, nullptr, M, C, N, stream);
    }
    err = launch_gemm<NN, false, EPI_F32>(dY, W, nullptr, nullptr, nullptr, nullptr, nullptr,
                                          dh, nullptr, M, C, N, stream);
    if (err != cudaSuccess) return err;
    err = column_sum<COL_F32>(dh, nullptr, nullptr, nullptr, M, C, work, dln_b, false, stream);
    if (err != cudaSuccess) return err;
    err = column_sum<COL_LN_W>(dh, x, stats, nullptr, M, C, work, dln_w, false, stream);
    if (err != cudaSuccess) return err;
    return launch_ln_bwd_rows(dh, x, stats, ln_w, residual ? g : nullptr, dx, M, C, stream);
}

}  // namespace

extern "C" int mbt_attention_bwd_slot_count() { return A_COUNT; }
extern "C" int mbt_mlp_bwd_slot_count() { return M_COUNT; }

// Floats of fp32 workspace the partials of a (rows, cols) weight gradient and
// of a column sum over `rows` columns need.
extern "C" long long mbt_block_work_floats(int rows, int cols) {
    const long long a = (long long)TN_SPLITS * rows * cols, b = (long long)COL_SPLITS * rows;
    return a > b ? a : b;
}

// Attention block on x (B, F, J, C) bf16. Scratch from the caller: qkv
// (M, 3C) and attn (M, C), bf16. ln_w / ln_b (fp32) are read only with use_ln.
extern "C" int mbt_attention_block(
    const void* x, void* out, void* qkv, void* attn, const void* ln_w, const void* ln_b,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    int B, int F, int J, int C, int H, float scale, int temporal, int use_ln,
    int residual, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = B * F * J;
    if (use_ln)
        CHECK((launch_gemm<NT, true, EPI_BIAS>(x, wqkv, bqkv, nullptr, ln_w, ln_b, nullptr,
                                               qkv, nullptr, M, 3 * C, C, stream)));
    else
        CHECK((launch_gemm<NT, false, EPI_BIAS>(x, wqkv, bqkv, nullptr, nullptr, nullptr,
                                                nullptr, qkv, nullptr, M, 3 * C, C, stream)));
    CHECK(launch_attention_any(qkv, attn, B, F, J, C, H, scale, temporal, stream));
    if (residual)
        CHECK((launch_gemm<NT, false, EPI_BIAS_RES>(attn, wproj, bproj, x, nullptr, nullptr,
                                                    nullptr, out, nullptr, M, C, C, stream)));
    else
        CHECK((launch_gemm<NT, false, EPI_BIAS>(attn, wproj, bproj, nullptr, nullptr, nullptr,
                                                nullptr, out, nullptr, M, C, C, stream)));
    return 0;
}

// Attention block backward on x (B, F, J, C) bf16 and the output gradient g.
// p holds A_COUNT device pointers in AttnSlot order; scratch shapes (M rows):
// h, attn, dattn (M, C) bf16; qkv, dqkvb (M, 3C) bf16; dqkv (M, 3C) fp32;
// st (M, 2) fp32; dh (M, C) fp32; work mbt_block_work_floats(3C, C). h, st, dh
// and the dln outputs are used only with use_ln. Outputs: dx bf16; weight and
// bias gradients bf16; LayerNorm gradients fp32.
extern "C" int mbt_attention_block_bwd(void* const* p, int B, int F, int J, int C, int H,
                                       float scale, int temporal, int use_ln, int residual,
                                       void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = B * F * J;
    float* work = static_cast<float*>(p[A_WORK]);

    // ---- forward recompute ----
    const void* h = p[A_X];
    if (use_ln) {
        CHECK(launch_ln_fwd_rows(p[A_X], p[A_LN_W], p[A_LN_B], p[A_H], p[A_ST], M, C, stream));
        h = p[A_H];
    }
    CHECK((launch_gemm<NT, false, EPI_BIAS>(h, p[A_WQKV], p[A_BQKV], nullptr, nullptr, nullptr,
                                            nullptr, p[A_QKV], nullptr, M, 3 * C, C, stream)));
    CHECK(launch_attention_any(p[A_QKV], p[A_ATTN], B, F, J, C, H, scale, temporal, stream));

    // ---- output projection backward ----
    CHECK((launch_gemm<NN, false, EPI_BF16>(p[A_G], p[A_WPROJ], nullptr, nullptr, nullptr,
                                            nullptr, nullptr, p[A_DATTN], nullptr, M, C, C,
                                            stream)));
    CHECK(weight_grad(p[A_G], p[A_ATTN], M, C, C, work, p[A_DWPROJ], stream));
    CHECK(column_sum<COL_BF16>(p[A_G], nullptr, nullptr, nullptr, M, C, work, p[A_DBPROJ],
                               true, stream));

    // ---- attention core and qkv projection backward ----
    CHECK(launch_attention_bwd_any(p[A_QKV], p[A_DATTN], p[A_DQKV], p[A_DQKVB], B, F, J, C, H,
                                   scale, temporal, stream));
    CHECK(weight_grad(p[A_DQKVB], h, M, 3 * C, C, work, p[A_DWQKV], stream));
    CHECK(column_sum<COL_F32>(p[A_DQKV], nullptr, nullptr, nullptr, M, 3 * C, work,
                              p[A_DBQKV], true, stream));
    CHECK(input_grad(p[A_DQKVB], p[A_WQKV], M, C, 3 * C, use_ln != 0, residual != 0, p[A_X],
                     p[A_G], p[A_ST], p[A_LN_W], p[A_DH], work, p[A_DLN_W], p[A_DLN_B],
                     p[A_DX], stream));
    return 0;
}

// MLP block on x (M, C) bf16. Scratch from the caller: hid (M, hidden) bf16.
extern "C" int mbt_mlp_block(
    const void* x, void* out, void* hid, const void* ln_w, const void* ln_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    int M, int C, int hidden, int use_ln, int residual, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (use_ln)
        CHECK((launch_gemm<NT, true, EPI_BIAS_GELU>(x, w1, b1, nullptr, ln_w, ln_b, nullptr,
                                                    hid, nullptr, M, hidden, C, stream)));
    else
        CHECK((launch_gemm<NT, false, EPI_BIAS_GELU>(x, w1, b1, nullptr, nullptr, nullptr,
                                                     nullptr, hid, nullptr, M, hidden, C,
                                                     stream)));
    if (residual)
        CHECK((launch_gemm<NT, false, EPI_BIAS_RES>(hid, w2, b2, x, nullptr, nullptr, nullptr,
                                                    out, nullptr, M, C, hidden, stream)));
    else
        CHECK((launch_gemm<NT, false, EPI_BIAS>(hid, w2, b2, nullptr, nullptr, nullptr,
                                                nullptr, out, nullptr, M, C, hidden, stream)));
    return 0;
}

// MLP block backward on x (M, C) bf16 and the output gradient g. p holds
// M_COUNT device pointers in MlpSlot order; scratch shapes: h (M, C) bf16;
// st (M, 2) fp32; z (M, hidden) fp32; a, dz (M, hidden) bf16; dh (M, C) fp32;
// work mbt_block_work_floats(hidden, C). h, st, dh and the dln outputs are
// used only with use_ln.
extern "C" int mbt_mlp_block_bwd(void* const* p, int M, int C, int hidden, int use_ln,
                                 int residual, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    float* work = static_cast<float*>(p[M_WORK]);

    // ---- forward recompute ----
    const void* h = p[M_X];
    if (use_ln) {
        CHECK(launch_ln_fwd_rows(p[M_X], p[M_LN_W], p[M_LN_B], p[M_H], p[M_ST], M, C, stream));
        h = p[M_H];
    }
    CHECK((launch_gemm<NT, false, EPI_BIAS_GELU_Z>(h, p[M_W1], p[M_B1], nullptr, nullptr,
                                                   nullptr, nullptr, p[M_A], p[M_Z], M, hidden,
                                                   C, stream)));

    // ---- fc2 backward ----
    CHECK(weight_grad(p[M_G], p[M_A], M, C, hidden, work, p[M_DW2], stream));
    CHECK(column_sum<COL_BF16>(p[M_G], nullptr, nullptr, nullptr, M, C, work, p[M_DB2], true,
                               stream));
    CHECK((launch_gemm<NN, false, EPI_DGELU>(p[M_G], p[M_W2], nullptr, nullptr, nullptr,
                                             nullptr, p[M_Z], p[M_DZ], nullptr, M, hidden, C,
                                             stream)));

    // ---- fc1 backward ----
    CHECK(weight_grad(p[M_DZ], h, M, hidden, C, work, p[M_DW1], stream));
    CHECK(column_sum<COL_BF16>(p[M_DZ], nullptr, nullptr, nullptr, M, hidden, work, p[M_DB1],
                               true, stream));
    CHECK(input_grad(p[M_DZ], p[M_W1], M, C, hidden, use_ln != 0, residual != 0, p[M_X],
                     p[M_G], p[M_ST], p[M_LN_W], p[M_DH], work, p[M_DLN_W], p[M_DLN_B],
                     p[M_DX], stream));
    return 0;
}
