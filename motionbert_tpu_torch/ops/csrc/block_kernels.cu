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
// (M = B*F*J for attention, any row count for the MLP), at the TPU kernels'
// rounding points. Every product runs on hopper_gemm.cuh, the wgmma + TMA
// engine (128 x 128 tiles from a three-stage TMA ring, two blocks an SM, the
// epilogues from the register fragments; the weight gradients in its fixed
// HG_TN_SPLITS row chunks and an in-order second pass), the attention core,
// forward and backward, on attention_tc.cuh's mma.sync tensor-core kernels,
// and the LayerNorm (use_ln) as row passes before the first product:
//   attention forward   [ln_fwd_rows (h, into the attn scratch)] -> NT qkv
//                       + bias (bf16) -> core -> NT proj + bias [+ x]
//   attention backward  [ln_fwd_rows (h, row stats)] -> NT qkv -> core;
//                       NN dattn = bf16(g Wproj); TN dWproj = g^T attn;
//                       core backward (fp32 and bf16 dqkv); TN dWqkv =
//                       bf16(dqkv)^T h; dbqkv from the fp32 dqkv; then dx
//                       as below with dY = bf16(dqkv), W = Wqkv
//   MLP forward         [ln_fwd_rows] -> NT fc1 + GELU (bf16) -> NT fc2 + bias [+ x]
//   MLP backward        [ln_fwd_rows] -> NT fc1 + GELU (bf16 a, fp32 z);
//                       TN dW2 = g^T a; NN dz = bf16(g W2 * GELU'(z));
//                       TN dW1 = dz^T h; db1 from the rounded dz; then dx
//                       with dY = dz, W = W1
//   dx                  with LN: NN dh = dY W (fp32), the LayerNorm
//                       parameter gradients, ln_bwd_rows dx = bf16(LN-
//                       backward(dh) [+ g]); without: NN dx = bf16(dY W [+ g])
//                       in the product's epilogue
// Spatial groups are the 17 joints of one frame; the TPU's 8-frame tile, its
// same-frame mask and its zeroed tail rows are layout and have no counterpart.
// GELU is the exact erff form (the TPU kernel approximates erf with a
// polynomial, |error| <= 1.5e-7, because its compiler has none). The core
// normalises P by the row sum's fp32 reciprocal (attention_tc.cuh), one fp32
// rounding from the JAX kernels' division. Every reduction over the rows goes
// through fixed chunks and a second pass, without atomics, and every output
// is written once, so two runs give the same bits.
//
// Bound. At (4, 243, 17, 512), 8 heads, hidden 1024, the attention block does
// 42.9 GFLOP (temporal) and the MLP block 34.7 GFLOP against ~36 MB of inputs
// and outputs; the backwards 120.0 and 86.6 GFLOP, the recompute counted (the
// first product three times, the output product twice, the core three times):
// tensor-core operations bound all four. What stays on CUDA cores is the row
// passes (LayerNorm forward and backward) and the column sums (the biases and
// the LayerNorm parameters), which pair_bwd_common.cuh shares with the pair
// backward; the chains still write their intermediates (qkv, attn, dattn,
// dqkv; h, z, a, dz) to device memory.
//
// Every entry point launches on the caller's stream, allocates nothing (the
// caller passes every buffer) and returns 0 or the first CUDA error.

#include <cstring>

#include "attention_tc.cuh"
#include "hopper_gemm.cuh"

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

// out = bf16(A W^T + bias [+ R]) (M, N): the NT product of a block's last
// layer, with the residual R unless it is null.
cudaError_t nt_out(const void* A, const void* W, const void* bias, const void* R, void* out,
                   int M, int N, int K, cudaStream_t stream) {
    if (R != nullptr)
        return hg_gemm<NT, EPI_BIAS_RES>(A, W, bias, R, nullptr, out, nullptr, M, N, K, stream);
    return hg_gemm<NT, EPI_BIAS>(A, W, bias, nullptr, nullptr, out, nullptr, M, N, K, stream);
}

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
            return hg_gemm<NN, EPI_RES>(dY, W, nullptr, g, nullptr, dx, nullptr, M, C, N, stream);
        return hg_gemm<NN, EPI_BF16>(dY, W, nullptr, nullptr, nullptr, dx, nullptr, M, C, N,
                                     stream);
    }
    err = hg_gemm<NN, EPI_F32>(dY, W, nullptr, nullptr, nullptr, dh, nullptr, M, C, N, stream);
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
    const long long a = (long long)HG_TN_SPLITS * rows * cols, b = (long long)COL_SPLITS * rows;
    return a > b ? a : b;
}

// Attention block on x (B, F, J, C) bf16. Scratch from the caller: qkv
// (M, 3C) and attn (M, C), bf16. ln_w / ln_b (fp32) are read only with use_ln;
// then attn holds LN's rows h until the core overwrites them (the qkv product
// has read them by then), and no row statistics are kept. 3 + use_ln
// launches. The engine reads x and the weights through TMA and the biases and
// the residual with vector loads: all must sit at 16-byte-aligned addresses,
// which ops/attention.py checks (hg_gemm refuses a misaligned A or W with
// cudaErrorInvalidValue; a misaligned bias or residual would fault).
extern "C" int mbt_attention_block(
    const void* x, void* out, void* qkv, void* attn, const void* ln_w, const void* ln_b,
    const void* wqkv, const void* bqkv, const void* wproj, const void* bproj,
    int B, int F, int J, int C, int H, float scale, int temporal, int use_ln,
    int residual, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = B * F * J;
    const void* h = x;
    if (use_ln) {
        CHECK(launch_ln_fwd_rows(x, ln_w, ln_b, attn, nullptr, M, C, stream));
        h = attn;
    }
    CHECK((hg_gemm<NT, EPI_BIAS>(h, wqkv, bqkv, nullptr, nullptr, qkv, nullptr, M, 3 * C, C,
                                 stream)));
    TcArgs core = tc_packed_args(qkv, B, F, J, C, H, scale, temporal);
    core.out = attn;
    core.ld_out = C;
    CHECK(launch_attention_tc(core, false, stream));
    CHECK(nt_out(attn, wproj, bproj, residual ? x : nullptr, out, M, C, C, stream));
    return 0;
}

// Attention block backward on x (B, F, J, C) bf16 and the output gradient g.
// p holds A_COUNT device pointers in AttnSlot order; scratch shapes (M rows):
// h, attn, dattn (M, C) bf16; qkv, dqkvb (M, 3C) bf16; dqkv (M, 3C) fp32;
// st (M, 2) fp32; dh (M, C) fp32; work mbt_block_work_floats(3C, C). h, st, dh
// and the dln outputs are used only with use_ln. Outputs: dx bf16; weight and
// bias gradients bf16; LayerNorm gradients fp32. x, g, the weights and the
// biases at 16-byte-aligned addresses, as for the forward.
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
    CHECK((hg_gemm<NT, EPI_BIAS>(h, p[A_WQKV], p[A_BQKV], nullptr, nullptr, p[A_QKV], nullptr,
                                 M, 3 * C, C, stream)));
    TcArgs core = tc_packed_args(p[A_QKV], B, F, J, C, H, scale, temporal);
    core.out = p[A_ATTN];
    core.ld_out = C;
    CHECK(launch_attention_tc(core, false, stream));

    // ---- output projection backward ----
    CHECK((hg_gemm<NN, EPI_BF16>(p[A_G], p[A_WPROJ], nullptr, nullptr, nullptr, p[A_DATTN],
                                 nullptr, M, C, C, stream)));
    CHECK(hg_weight_grad(p[A_G], p[A_ATTN], M, C, C, work, p[A_DWPROJ], stream));
    CHECK(column_sum<COL_BF16>(p[A_G], nullptr, nullptr, nullptr, M, C, work, p[A_DBPROJ],
                               true, stream));

    // ---- attention core and qkv projection backward ----
    float* dqkv = static_cast<float*>(p[A_DQKV]);
    bf16* dqkvb = static_cast<bf16*>(p[A_DQKVB]);
    core.g = p[A_DATTN];
    core.ld_g = C;
    core.dqf = dqkv, core.dkf = dqkv + C, core.dvf = dqkv + 2 * C;
    core.dqb = dqkvb, core.dkb = dqkvb + C, core.dvb = dqkvb + 2 * C;
    core.ld_out = 3 * C;
    CHECK(launch_attention_tc(core, true, stream));
    CHECK(hg_weight_grad(dqkvb, h, M, 3 * C, C, work, p[A_DWQKV], stream));
    CHECK(column_sum<COL_F32>(dqkv, nullptr, nullptr, nullptr, M, 3 * C, work, p[A_DBQKV],
                              true, stream));
    CHECK(input_grad(dqkvb, p[A_WQKV], M, C, 3 * C, use_ln != 0, residual != 0, p[A_X],
                     p[A_G], p[A_ST], p[A_LN_W], p[A_DH], work, p[A_DLN_W], p[A_DLN_B],
                     p[A_DX], stream));
    return 0;
}

// MLP block on x (M, C) bf16. Scratch from the caller: hid (M, hidden) bf16,
// followed with use_ln by h (M, C) bf16 and the row statistics (M, 2) fp32:
// M * (hidden + C + 4) bf16 elements in all (ops/fused_mlp.py's _launch).
extern "C" int mbt_mlp_block(
    const void* x, void* out, void* hid, const void* ln_w, const void* ln_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    int M, int C, int hidden, int use_ln, int residual, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const void* h = x;
    if (use_ln) {
        bf16* hb = static_cast<bf16*>(hid) + (size_t)M * hidden;
        CHECK(launch_ln_fwd_rows(x, ln_w, ln_b, hb, hb + (size_t)M * C, M, C, stream));
        h = hb;
    }
    CHECK((hg_gemm<NT, EPI_BIAS_GELU>(h, w1, b1, nullptr, nullptr, hid, nullptr, M, hidden, C,
                                      stream)));
    CHECK(nt_out(hid, w2, b2, residual ? x : nullptr, out, M, C, hidden, stream));
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
    CHECK((hg_gemm<NT, EPI_BIAS_GELU_Z>(h, p[M_W1], p[M_B1], nullptr, nullptr, p[M_A], p[M_Z],
                                        M, hidden, C, stream)));

    // ---- fc2 backward ----
    CHECK(hg_weight_grad(p[M_G], p[M_A], M, C, hidden, work, p[M_DW2], stream));
    CHECK(column_sum<COL_BF16>(p[M_G], nullptr, nullptr, nullptr, M, C, work, p[M_DB2], true,
                               stream));
    CHECK((hg_gemm<NN, EPI_DGELU>(p[M_G], p[M_W2], nullptr, nullptr, p[M_Z], p[M_DZ], nullptr,
                                  M, hidden, C, stream)));

    // ---- fc1 backward ----
    CHECK(hg_weight_grad(p[M_DZ], h, M, hidden, C, work, p[M_DW1], stream));
    CHECK(column_sum<COL_BF16>(p[M_DZ], nullptr, nullptr, nullptr, M, hidden, work, p[M_DB1],
                               true, stream));
    CHECK(input_grad(p[M_DZ], p[M_W1], M, C, hidden, use_ln != 0, residual != 0, p[M_X],
                     p[M_G], p[M_ST], p[M_LN_W], p[M_DH], work, p[M_DLN_W], p[M_DLN_B],
                     p[M_DX], stream));
    return 0;
}

// ---------------------------------------------------------------------------
// the engine alone, for its tests: one hg_gemm launch of the (layout,
// epilogue) pairs the MLP chains use, with hg_gemm's arguments. TN (EPI_PARTIAL)
// writes HG_TN_SPLITS partial tiles of mbt_hgemm_split_rows(M) token rows
// each. Any other pair returns cudaErrorInvalidValue.
// ---------------------------------------------------------------------------

// The constants ops/fused_mlp.py names (its ENGINE_* tables) by its names:
// the Layout and Epilogue values, the k-step and the TN chunk count; -1 for
// any other name. The wrapper holds its tables against these.
extern "C" int mbt_hgemm_constant(const char* name) {
    static const struct { const char* name; int value; } table[] = {
        {"NT", NT}, {"NN", NN}, {"TN", TN},
        {"bias", EPI_BIAS}, {"bias_res", EPI_BIAS_RES}, {"bias_gelu", EPI_BIAS_GELU},
        {"bias_gelu_z", EPI_BIAS_GELU_Z}, {"f32", EPI_F32}, {"bf16", EPI_BF16},
        {"dgelu", EPI_DGELU}, {"partial", EPI_PARTIAL}, {"res", EPI_RES},
        {"BK", HG_BK}, {"TN_SPLITS", HG_TN_SPLITS}};
    for (const auto& entry : table)
        if (strcmp(entry.name, name) == 0) return entry.value;
    return -1;
}

extern "C" int mbt_hgemm_split_rows(int M) { return hg_split_rows(M); }

extern "C" int mbt_hgemm_test(int layout, int epi, const void* A, const void* W,
                              const void* bias, const void* R, const void* Z, void* out,
                              void* out_z, int M, int N, int K, void* stream_ptr) {
    cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    const int key = layout * 16 + epi;
#define HG_CASE(L, E) \
    case L * 16 + E: return (int)hg_gemm<L, E>(A, W, bias, R, Z, out, out_z, M, N, K, s);
    switch (key) {
        HG_CASE(NT, EPI_BIAS)
        HG_CASE(NT, EPI_BIAS_RES)
        HG_CASE(NT, EPI_BIAS_GELU)
        HG_CASE(NT, EPI_BIAS_GELU_Z)
        HG_CASE(NN, EPI_DGELU)
        HG_CASE(NN, EPI_F32)
        HG_CASE(NN, EPI_BF16)
        HG_CASE(NN, EPI_RES)
        HG_CASE(TN, EPI_PARTIAL)
        default: return (int)cudaErrorInvalidValue;
    }
#undef HG_CASE
}
