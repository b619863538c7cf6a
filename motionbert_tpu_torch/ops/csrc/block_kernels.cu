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
//   dx                  with LN: NN dh = dY W (fp32), then launch_ln_bwd:
//                       dx = bf16(LN-backward(dh) [+ g]) and the LayerNorm
//                       parameter gradients in one pass, and their chunk
//                       sums; without: NN dx = bf16(dY W [+ g]) in the
//                       product's epilogue
// Spatial groups are the 17 joints of one frame; the TPU's 8-frame tile, its
// same-frame mask and its zeroed tail rows are layout and have no counterpart.
// GELU is the exact erff form (the TPU kernel approximates erf with a
// polynomial, |error| <= 1.5e-7, because its compiler has none). The core
// normalises P by the row sum's fp32 reciprocal (attention_tc.cuh), one fp32
// rounding from the JAX kernels' division. Every reduction over the rows goes
// through fixed chunks and a second pass, without atomics, and every output
// is written once, so two runs give the same bits. (The one atomic of the
// port's kernels is elsewhere: B9_tp's row maxima, folded into their buffer
// with atomicMax by the attention core's and the s8 engine's epilogues,
// pair_q8_kernels.cu; a maximum does not depend on the order, so its bits
// repeat too. The chains here pass a null amax and take no atomic.)
//
// Bound. At (4, 243, 17, 512), 8 heads, hidden 1024, the attention block does
// 42.9 GFLOP (temporal) and the MLP block 34.7 GFLOP against ~36 MB of inputs
// and outputs; the backwards 120.0 and 86.6 GFLOP, the recompute counted (the
// first product three times, the output product twice, the core three times):
// tensor-core operations bound all four. What stays on CUDA cores is the row
// passes (LayerNorm forward, and the backward with the LayerNorm parameter
// sums) and the bias column sums, which pair_bwd_common.cuh shares with the
// pair backward; the chains still write their intermediates (qkv, attn,
// dattn, dqkv; h, z, a, dz) to device memory.
//
// Tensor-parallel modes (parallel/tensor.py). Under tensor parallelism over T
// model ranks each rank holds a head group's rows of qkv, Wqkv_r (3 Ci, C)
// with Ci = C / T, and the matching columns of proj, Wproj_r (C, Ci), and a
// hidden slice of the MLP: W1_r (hid_r, C), W2_r (C, hid_r). The TP modes
// run the same chains on those shards, always with the LayerNorm, and stop
// where the ranks' parts must be summed:
//   B4_tp  NT qkv + bias (M, 3 Ci) with the LayerNorm inside the product
//          (hg_ln_gemm: hopper_gemm.cuh's hg_ln_kernel normalises a block's
//          rows of x in shared memory, no h in device memory) -> core on
//          the Hl = H / T local heads (on 243-frame groups the split
//          forward, attention_tc.cuh's attn_tc_fwd_query_kernel, 64-row
//          query slices of 4 warps, two blocks an SM; else the one-launch
//          kernel) -> NT proj into fp32 (EPI_F32): the partial product, no
//          bias, no residual. Where C is wider than hg_ln_kernel takes, the
//          first product is ln_fwd_rows then NT, as the whole-width chains
//          run it (ln_product)
//   B6_tp  ln_fwd_rows -> NT fc1 + GELU -> NT fc2 into fp32
//   B5_tp  ln_fwd_rows (h, row stats) -> NT qkv -> NN dattn = bf16(g
//          Wproj_r) -> core backward with attn (attention_tc.cuh: on
//          243-frame groups the split query-major and key-major launches,
//          else the one-launch kernel; attn = bf16(bf16(P) v) from the P
//          pass 1 holds, so no forward core runs) -> dbqkv from the fp32
//          dqkv -> TN dWqkv and dWproj in one round and one in-order pass
//          (hg_weight_grad2) -> NN dh = dqkv Wqkv_r (EPI_F32); no dbproj
//   B7_tp  ln_fwd_rows -> NT fc1 + GELU (bf16 a, fp32 z) -> {TN dW2 = g^T
//          a, NN dz = bf16(g W2_r * GELU'(z))} in one launch -> db1 -> {TN
//          dW1 = dz^T h, NN dh = dz W1_r} in one launch -> one in-order
//          pass over both partial sets (reduce_partials); no db2. Each
//          column sum runs right after its source is written, while the
//          L2 holds some of it
//          (hopper_gemm.cuh's hg_gemm_pair: a shard's TN round is 64 to 192
//          blocks of the 264 the grid holds, and the NN product beside it
//          fills the rest)
//   ln_bwd from the summed dh: launch_ln_bwd, dx = bf16(LN-backward(dh) +
//          g) with dln_w and dln_b, input_grad's call
// The caller all-reduces the fp32 partials and dh over the model ranks and
// adds the output bias and the residual, in fp32, before the one rounding
// (x + proj and x + fc2 round where B1 rounds). At T = 1 each mode is the
// non-TP chain's arithmetic: the same bits, each tile and each core row
// computed as the non-TP chain's launches compute it.
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

// Pointer slots of mbt_attention_block_tp_bwd (ops/attention.py's
// ATTN_TP_BWD_SLOTS) and of mbt_mlp_block_tp_bwd (ops/fused_mlp.py's
// MLP_TP_BWD_SLOTS).
enum AttnTpSlot {
    // inputs
    AT_X, AT_G, AT_LN_W, AT_LN_B, AT_WQKV, AT_BQKV, AT_WPROJ,
    // outputs
    AT_DWQKV, AT_DBQKV, AT_DWPROJ, AT_DH, AT_ST,
    // scratch
    AT_H, AT_QKV, AT_ATTN, AT_DATTN, AT_DQKV, AT_DQKVB, AT_CORE_ST, AT_WORK,
    AT_COUNT
};

enum MlpTpSlot {
    // inputs
    MT_X, MT_G, MT_LN_W, MT_LN_B, MT_W1, MT_B1, MT_W2,
    // outputs
    MT_DW1, MT_DB1, MT_DW2, MT_DH, MT_ST,
    // scratch
    MT_H, MT_Z, MT_A, MT_DZ, MT_WORK,
    MT_COUNT
};

// The backward core with attn (B5_tp's): dq, dk and dv as launch_attention_tc's
// backward writes them, and attn = bf16(bf16(P) v), the forward core's bits,
// to a.out with row stride a.ld_out_attn. split: the query-major and
// key-major launches (key tiles 8 or 16; a.stats holds 3 N floats an item);
// else the one-launch kernel. grid: see tc_launch_bwd_attn. Returns
// cudaErrorInvalidValue on a shape the core does not take.
cudaError_t launch_attention_tc_bwd_attn(const TcArgs& a, bool split, cudaStream_t stream,
                                         int* grid = nullptr) {
    if (a.H < 1 || a.C % a.H) return cudaErrorInvalidValue;
    const int D = a.C / a.H;
    if (D == 64) return tc_launch_bwd_attn_d<64>(a, split, stream, grid);
    if (D == 32) return tc_launch_bwd_attn_d<32>(a, split, stream, grid);
    return cudaErrorInvalidValue;
}

// Whether B5_tp's chain splits the core backward on groups of N rows: where
// the one-launch kernel is one 256-key item a block (243 frames).
inline bool tc_split_backward(int N) { return tc_key_tiles(N) == TC_MAX_KEYS / TC_KEY_TILE; }

// ---- the LayerNorm inside the qkv product: hopper_gemm.cuh's hg_ln_kernel ----

// out (M, N) = bf16(LN(x)) W^T + bias: ln_fwd_rows -> hg_gemm<NT, EPI_BIAS>'s
// bits in one launch (bf16 out). x (M, C) bf16, ln_w / ln_b (C) fp32, W
// (N, C) bf16; N a multiple of 64, lng_takes(C); x, W and out 16-byte
// aligned. Returns cudaErrorInvalidValue on any other shape.
cudaError_t hg_ln_gemm(const void* x, const void* ln_w, const void* ln_b, const void* W,
                       const void* bias, void* out, int M, int N, int C, cudaStream_t stream) {
    if (!lng_takes(C) || N < HG_BK || N % HG_BK || M < 1) return cudaErrorInvalidValue;
    CUtensorMap tx, tw, to;
    if (!tensor_map_2d(&tx, x, C, M, LNG_ROWS_A_WARP) || !tensor_map_2d(&tw, W, C, N, HG_BN) ||
        !tensor_map_2d(&to, out, N, M, LNG_OUT_ROWS))
        return cudaErrorInvalidValue;
    int dev = 0;
    const cudaError_t err = hg_opt_in<hg_ln_kernel<EPI_BIAS>>(lng_smem_bytes(LNG_MAX_C), dev);
    if (err != cudaSuccess) return err;
    const int blocks = (M + LNG_BM - 1) / LNG_BM;
    hg_ln_kernel<EPI_BIAS><<<blocks, LNG_THREADS, lng_smem_bytes(C), stream>>>(
        tx, tw, to, static_cast<const bf16*>(bias), static_cast<const float*>(ln_w),
        static_cast<const float*>(ln_b), M, N, C);
    return cudaGetLastError();
}

// B4_tp's forward core: with split the split forward (attention_tc.cuh's
// attn_tc_fwd_query_kernel, groups of 65..256 rows), else the one-launch
// kernel; both give its bits. grid: see tc_launch_fwd. Returns
// cudaErrorInvalidValue on a shape the core does not take.
cudaError_t launch_attention_tc_sliced(const TcArgs& a, bool split, cudaStream_t stream,
                                       int* grid = nullptr) {
    if (a.H < 1 || a.C % a.H) return cudaErrorInvalidValue;
    const int D = a.C / a.H;
    if (D == 64) return tc_launch_fwd_d<64>(a, split, stream, grid);
    if (D == 32) return tc_launch_fwd_d<32>(a, split, stream, grid);
    return cudaErrorInvalidValue;
}

// Whether B4_tp's chain splits the forward core on groups of N rows: where
// the one-launch kernel is one item a block (key tiles 8 and 16).
inline bool tc_split_forward(int N) { return tc_splits(tc_key_tiles(N)); }

// out (M, N) = bf16(LN(x)) W^T + bias, B4_tp's qkv product: the LayerNorm
// inside the product (hg_ln_gemm) where it takes rows of C, else
// ln_fwd_rows into h (M, C) and the engine's NT product. The rule is on C
// alone (lng_takes: whole k-blocks, C <= LNG_MAX_C); the two routes give
// the same bits.
cudaError_t ln_product(const void* x, const void* ln_w, const void* ln_b, const void* W,
                       const void* bias, void* out, void* h, int M, int N, int C,
                       cudaStream_t stream) {
    if (lng_takes(C)) return hg_ln_gemm(x, ln_w, ln_b, W, bias, out, M, N, C, stream);
    const cudaError_t err = launch_ln_fwd_rows(x, ln_w, ln_b, h, nullptr, M, C, stream);
    if (err != cudaSuccess) return err;
    return hg_gemm<NT, EPI_BIAS>(h, W, bias, nullptr, nullptr, out, nullptr, M, N, C, stream);
}

// out0[i] (i < n0) and out1[i - n0] (n0 <= i < n0 + n1), bf16: the sum over
// the HG_TN_SPLITS chunks, in chunk order, of part[k (n0 + n1) + i], two
// weight gradients' partials side by side (hg_partials). A thread an
// element, as reduce_splits_kernel adds one gradient's: its bits.
__global__ void __launch_bounds__(COL_THREADS)
reduce_partials_kernel(const float* __restrict__ part, int n0, int n1,
                       bf16* __restrict__ out0, bf16* __restrict__ out1) {
    const int n = n0 + n1;
    const int i = blockIdx.x * COL_THREADS + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < HG_TN_SPLITS; ++k) s += part[(size_t)k * n + i];
    const bf16 v = __float2bfloat16(s);
    if (i < n0)
        out0[i] = v;
    else
        out1[i - n0] = v;
}

// The in-order second pass over two weight gradients' partials side by side
// (reduce_partials_kernel): one launch for both.
cudaError_t reduce_partials(const float* work, int n0, int n1, void* out0, void* out1,
                            cudaStream_t stream) {
    reduce_partials_kernel<<<(n0 + n1 + COL_THREADS - 1) / COL_THREADS, COL_THREADS, 0,
                             stream>>>(work, n0, n1, static_cast<bf16*>(out0),
                                       static_cast<bf16*>(out1));
    return cudaGetLastError();
}

// Two weight gradients as hg_weight_grad computes each, dW0 (rows0, cols0)
// from dY0 and A0 and dW1 (rows1, cols1) from dY1 and A1 over the same M
// rows: both TN products in one launch (hg_gemm_pair) and one in-order pass
// (reduce_partials). work holds HG_TN_SPLITS * (rows0 cols0 + rows1 cols1)
// floats.
cudaError_t hg_weight_grad2(const void* dY0, const void* A0, int rows0, int cols0, void* out0,
                            const void* dY1, const void* A1, int rows1, int cols1, void* out1,
                            int M, float* work, cudaStream_t stream) {
    const int n0 = rows0 * cols0, n1 = rows1 * cols1;
    HgProduct<TN, EPI_PARTIAL> p0, p1;
    cudaError_t err = hg_partials(p0, dY0, A0, M, rows0, cols0, work, 0, (size_t)n0 + n1);
    if (err == cudaSuccess)
        err = hg_partials(p1, dY1, A1, M, rows1, cols1, work, n0, (size_t)n0 + n1);
    if (err == cudaSuccess) err = hg_gemm_pair(p0, p1, stream);
    if (err != cudaSuccess) return err;
    return reduce_partials(work, n0, n1, out0, out1, stream);
}

// out = bf16(A W^T + bias [+ R]) (M, N): the NT product of a block's last
// layer, with the residual R unless it is null.
cudaError_t nt_out(const void* A, const void* W, const void* bias, const void* R, void* out,
                   int M, int N, int K, cudaStream_t stream) {
    if (R != nullptr)
        return hg_gemm<NT, EPI_BIAS_RES>(A, W, bias, R, nullptr, out, nullptr, M, N, K, stream);
    return hg_gemm<NT, EPI_BIAS>(A, W, bias, nullptr, nullptr, out, nullptr, M, N, K, stream);
}

// dx from dh = dY W (NN product of dY (M, N) bf16 with the nn.Linear weight
// W (N, C)). With LN: fp32 dh, then the LayerNorm backward [+ g] with its
// parameter gradients. Without: the product's epilogue writes bf16(dh [+ g]).
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
    return launch_ln_bwd(dh, x, stats, ln_w, residual ? g : nullptr, dx, dln_w, dln_b, work, M,
                         C, stream);
}

}  // namespace

extern "C" int mbt_attention_bwd_slot_count() { return A_COUNT; }
extern "C" int mbt_mlp_bwd_slot_count() { return M_COUNT; }
extern "C" int mbt_attention_tp_bwd_slot_count() { return AT_COUNT; }
extern "C" int mbt_mlp_tp_bwd_slot_count() { return MT_COUNT; }

// Floats of fp32 workspace the partials of a (rows, cols) weight gradient, of
// a column sum over `rows` columns and of the LayerNorm backward over `cols`
// columns need (rows 0: the LayerNorm backward alone, mbt_ln_bwd). Two
// gradients whose partials share the workspace (hg_weight_grad2,
// reduce_partials) and have cols columns each pass their rows summed.
extern "C" long long mbt_block_work_floats(int rows, int cols) {
    const long long a = (long long)HG_TN_SPLITS * rows * cols, b = (long long)COL_SPLITS * rows,
                    c = (long long)LN_SPLITS * 2 * cols;
    return a > b ? (a > c ? a : c) : (b > c ? b : c);
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
    CHECK(column_sum<COL_BF16>(p[A_G], nullptr, M, C, work, p[A_DBPROJ], true, stream));

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
    CHECK(column_sum<COL_F32>(dqkv, nullptr, M, 3 * C, work, p[A_DBQKV], true, stream));
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
    CHECK(column_sum<COL_BF16>(p[M_G], nullptr, M, C, work, p[M_DB2], true, stream));
    CHECK((hg_gemm<NN, EPI_DGELU>(p[M_G], p[M_W2], nullptr, nullptr, p[M_Z], p[M_DZ], nullptr,
                                  M, hidden, C, stream)));

    // ---- fc1 backward ----
    CHECK(hg_weight_grad(p[M_DZ], h, M, hidden, C, work, p[M_DW1], stream));
    CHECK(column_sum<COL_BF16>(p[M_DZ], nullptr, M, hidden, work, p[M_DB1], true, stream));
    CHECK(input_grad(p[M_DZ], p[M_W1], M, C, hidden, use_ln != 0, residual != 0, p[M_X],
                     p[M_G], p[M_ST], p[M_LN_W], p[M_DH], work, p[M_DLN_W], p[M_DLN_B],
                     p[M_DX], stream));
    return 0;
}

// ---------------------------------------------------------------------------
// tensor-parallel modes (see the note at the top)
// ---------------------------------------------------------------------------

// B4_tp on x (B, F, J, C) bf16: out (M, C) fp32 = attention over the Hl local
// heads of LN(x), projected through Wproj_r (C, Ci), without bias or
// residual. Scratch: qkv (M, 3 Ci) and attn (mbt_attention_block_tp_scratch
// bf16 elements: (M, Ci), or where the LayerNorm is a row pass (M, max(C,
// Ci)), the LayerNorm rows until the core overwrites their first Ci columns).
// 3 device records: the LayerNorm inside the qkv product, the core (split on
// 243-frame groups), proj. Alignment as for mbt_attention_block.
extern "C" int mbt_attention_block_tp(
    const void* x, void* out, void* qkv, void* attn, const void* ln_w, const void* ln_b,
    const void* wqkv, const void* bqkv, const void* wproj, int B, int F, int J, int C,
    int Ci, int Hl, float scale, int temporal, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = B * F * J;
    CHECK(ln_product(x, ln_w, ln_b, wqkv, bqkv, qkv, attn, M, 3 * Ci, C, stream));
    TcArgs core = tc_packed_args(qkv, B, F, J, Ci, Hl, scale, temporal);
    core.out = attn;
    core.ld_out = Ci;
    CHECK(launch_attention_tc_sliced(core, tc_split_forward(temporal ? F : J), stream));
    CHECK((hg_gemm<NT, EPI_F32>(attn, wproj, nullptr, nullptr, nullptr, out, nullptr, M, C, Ci,
                                stream)));
    return 0;
}

// bf16 elements of mbt_attention_block_tp's attn scratch at M token rows.
extern "C" long long mbt_attention_block_tp_scratch(int M, int C, int Ci) {
    return (long long)M * (lng_takes(C) ? Ci : (C > Ci ? C : Ci));
}

// B5_tp: B4_tp's gradients for the (replicated) output gradient g (M, C)
// bf16. p holds AT_COUNT device pointers in AttnTpSlot order. Outputs:
// dWqkv_r (3 Ci, C), dbqkv_r (3 Ci), dWproj_r (C, Ci) bf16; dh (M, C) fp32,
// this rank's part of the gradient at the LayerNorm's output; st (M, 2) fp32,
// the LayerNorm's row statistics (mean, rstd) for mbt_ln_bwd. Scratch: h
// (M, C), attn, dattn (M, Ci), qkv, dqkvb (M, 3 Ci) bf16; dqkv (M, 3 Ci)
// fp32; core_st (3 Hl M) fp32, the split core's row statistics; work
// mbt_block_work_floats(4 Ci, C). The core's backward writes attn (no
// forward core launch), and dWqkv and dWproj run in one round: 10 device
// records on 243-frame groups (the core's two halves), else 9 (a weight
// gradient pair and a column sum are two each).
extern "C" int mbt_attention_block_tp_bwd(void* const* p, int B, int F, int J, int C, int Ci,
                                          int Hl, float scale, int temporal,
                                          void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int M = B * F * J;
    float* work = static_cast<float*>(p[AT_WORK]);

    // ---- forward recompute up to qkv ----
    CHECK(launch_ln_fwd_rows(p[AT_X], p[AT_LN_W], p[AT_LN_B], p[AT_H], p[AT_ST], M, C,
                             stream));
    CHECK((hg_gemm<NT, EPI_BIAS>(p[AT_H], p[AT_WQKV], p[AT_BQKV], nullptr, nullptr,
                                 p[AT_QKV], nullptr, M, 3 * Ci, C, stream)));

    // ---- output projection backward (no bias: the caller sums g) ----
    CHECK((hg_gemm<NN, EPI_BF16>(p[AT_G], p[AT_WPROJ], nullptr, nullptr, nullptr, p[AT_DATTN],
                                 nullptr, M, Ci, C, stream)));

    // ---- attention core backward, attn with it ----
    float* dqkv = static_cast<float*>(p[AT_DQKV]);
    bf16* dqkvb = static_cast<bf16*>(p[AT_DQKVB]);
    TcArgs core = tc_packed_args(p[AT_QKV], B, F, J, Ci, Hl, scale, temporal);
    core.g = p[AT_DATTN];
    core.ld_g = Ci;
    core.dqf = dqkv, core.dkf = dqkv + Ci, core.dvf = dqkv + 2 * Ci;
    core.dqb = dqkvb, core.dkb = dqkvb + Ci, core.dvb = dqkvb + 2 * Ci;
    core.ld_out = 3 * Ci;
    core.out = p[AT_ATTN];
    core.ld_out_attn = Ci;
    core.stats = static_cast<float*>(p[AT_CORE_ST]);
    CHECK(launch_attention_tc_bwd_attn(core, tc_split_backward(temporal ? F : J), stream));
    CHECK(column_sum<COL_F32>(dqkv, nullptr, M, 3 * Ci, work, p[AT_DBQKV], true, stream));

    // ---- weight gradients in one round, then the qkv projection backward ----
    CHECK(hg_weight_grad2(dqkvb, p[AT_H], 3 * Ci, C, p[AT_DWQKV], p[AT_G], p[AT_ATTN], C, Ci,
                          p[AT_DWPROJ], M, work, stream));
    CHECK((hg_gemm<NN, EPI_F32>(dqkvb, p[AT_WQKV], nullptr, nullptr, nullptr, p[AT_DH],
                                nullptr, M, C, 3 * Ci, stream)));
    return 0;
}

// B6_tp on x (M, C) bf16: out (M, C) fp32 = GELU(LN(x) W1_r^T + b1_r) W2_r^T
// without bias or residual. Scratch: hid (M, hid_r) bf16 followed by h
// (M, C) bf16: M * (hid_r + C) elements. 3 device records. The LayerNorm
// stays a row pass here: inside fc1 (hg_ln_kernel with the GELU epilogue)
// it took 0.0534 ms on the H100 at 16524 rows, C 512 and a hidden slice of
// 512, against 0.0153 + 0.0357 for ln_fwd_rows and fc1 (chip_smoke.py
// --phases tp --baseline), and one kernel with hid in shared memory gained
// under 1 %.
extern "C" int mbt_mlp_block_tp(
    const void* x, void* out, void* hid, const void* ln_w, const void* ln_b, const void* w1,
    const void* b1, const void* w2, int M, int C, int hidden, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    bf16* h = static_cast<bf16*>(hid) + (size_t)M * hidden;
    CHECK(launch_ln_fwd_rows(x, ln_w, ln_b, h, nullptr, M, C, stream));
    CHECK((hg_gemm<NT, EPI_BIAS_GELU>(h, w1, b1, nullptr, nullptr, hid, nullptr, M, hidden, C,
                                      stream)));
    CHECK((hg_gemm<NT, EPI_F32>(hid, w2, nullptr, nullptr, nullptr, out, nullptr, M, C, hidden,
                                stream)));
    return 0;
}

// B7_tp: B6_tp's gradients for the output gradient g (M, C) bf16. p holds
// MT_COUNT device pointers in MlpTpSlot order. Outputs: dW1_r (hid_r, C),
// db1_r (hid_r), dW2_r (C, hid_r) bf16; dh (M, C) fp32 and st (M, 2) fp32 as
// for B5_tp. Scratch: h (M, C) bf16; z (M, hid_r) fp32; a, dz (M, hid_r)
// bf16; work mbt_block_work_floats(2 hid_r, C). Each weight gradient's TN
// round shares its launch with the NN product that reads the same operand
// (dW2 with dz, both from g; dW1 with dh, both from dz), and one in-order
// pass adds both gradients' partials. 7 device records.
extern "C" int mbt_mlp_block_tp_bwd(void* const* p, int M, int C, int hidden,
                                    void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    float* work = static_cast<float*>(p[MT_WORK]);
    const int n2 = C * hidden, n1 = hidden * C;

    // ---- forward recompute ----
    CHECK(launch_ln_fwd_rows(p[MT_X], p[MT_LN_W], p[MT_LN_B], p[MT_H], p[MT_ST], M, C,
                             stream));
    CHECK((hg_gemm<NT, EPI_BIAS_GELU_Z>(p[MT_H], p[MT_W1], p[MT_B1], nullptr, nullptr, p[MT_A],
                                        p[MT_Z], M, hidden, C, stream)));

    // ---- fc2 backward (no bias: the caller sums g): dW2 = g^T a beside dz ----
    HgProduct<TN, EPI_PARTIAL> dw2, dw1;
    HgProduct<NN, EPI_DGELU> dz;
    HgProduct<NN, EPI_F32> dh;
    CHECK(hg_partials(dw2, p[MT_G], p[MT_A], M, C, hidden, work, 0, (size_t)n2 + n1));
    CHECK(hg_product(dz, p[MT_G], p[MT_W2], nullptr, nullptr, p[MT_Z], p[MT_DZ], nullptr, M,
                     hidden, C));
    CHECK((hg_gemm_pair<TN, EPI_PARTIAL, NN, EPI_DGELU>(dw2, dz, stream)));
    // db1 while dz sits in the L2; its COL_SPLITS x hidden chunk partials
    // in chunk 0's slot of dW1's partials (hidden x C floats, C >= 64), which
    // the next launch writes
    CHECK(column_sum<COL_BF16>(p[MT_DZ], nullptr, M, hidden, work + n2, p[MT_DB1], true,
                               stream));

    // ---- fc1 backward: dW1 = dz^T h beside dh = dz W1 ----
    CHECK(hg_partials(dw1, p[MT_DZ], p[MT_H], M, hidden, C, work, n2, (size_t)n2 + n1));
    CHECK(hg_product(dh, p[MT_DZ], p[MT_W1], nullptr, nullptr, nullptr, p[MT_DH], nullptr, M,
                     C, hidden));
    CHECK((hg_gemm_pair<TN, EPI_PARTIAL, NN, EPI_F32>(dw1, dh, stream)));
    CHECK(reduce_partials(work, n2, n1, p[MT_DW2], p[MT_DW1], stream));
    return 0;
}

// The LayerNorm backward of a TP half from the summed fp32 dh (M, C), x
// (M, C) bf16, the row statistics st (M, 2) and ln_w (C,) fp32, with the
// residual gradient g (M, C) bf16: dln_b = sum_m dh, dln_w = sum_m dh * xhat
// (fp32), dx = bf16(LN-backward(dh) + g); g == nullptr (a half without the
// residual, the dropout path's branch) leaves it out: dx = bf16(LN-backward(
// dh)), as B5 writes it without the residual. work: mbt_block_work_floats(0,
// C) floats. 2 device records: pair_bwd_common.cuh's launch_ln_bwd, the one
// pass and the in-order sum of its chunk partials.
extern "C" int mbt_ln_bwd(const void* dh, const void* x, const void* st, const void* ln_w,
                          const void* g, void* dx, void* dln_w, void* dln_b, float* work,
                          int M, int C, void* stream_ptr) {
    CHECK(launch_ln_bwd(dh, x, st, ln_w, g, dx, dln_w, dln_b, work, M, C,
                        static_cast<cudaStream_t>(stream_ptr)));
    return 0;
}

// The column-sum constants ops/attention.py names (COLSUM_CONSTANTS) by its
// names: the chunk counts, the load batch, the LayerNorm backward's slice
// and the ColMode values; -1 for any other name.
extern "C" int mbt_colsum_constant(const char* name) {
    static const struct { const char* name; int value; } table[] = {
        {"splits", COL_SPLITS}, {"batch", COL_BATCH}, {"ln_splits", LN_SPLITS},
        {"ln_slice", LN_SLICE}, {"bf16", COL_BF16}, {"f32", COL_F32}, {"gate", COL_GATE}};
    for (const auto& entry : table)
        if (strcmp(entry.name, name) == 0) return entry.value;
    return -1;
}

// One bias column sum alone, for its tests: out (N) = column_sum<mode> of the
// (M, N) source src (bf16, or fp32 for COL_F32), w the (M, 2) fp32 row
// weights of COL_GATE (column 0 read); work COL_SPLITS * N floats. Any other
// mode returns cudaErrorInvalidValue.
extern "C" int mbt_colsum_test(int mode, const void* src, const void* w, int M, int N,
                               float* work, void* out, int out_bf16, void* stream_ptr) {
    cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    const float* wf = static_cast<const float*>(w);
    switch (mode) {
        case COL_BF16: return (int)column_sum<COL_BF16>(src, wf, M, N, work, out, out_bf16, s);
        case COL_F32: return (int)column_sum<COL_F32>(src, wf, M, N, work, out, out_bf16, s);
        case COL_GATE: return (int)column_sum<COL_GATE>(src, wf, M, N, work, out, out_bf16, s);
        default: return (int)cudaErrorInvalidValue;
    }
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

// Two products in one launch of the engine (hg_gemm_pair), for its tests:
// (layout, epilogue) l0/e0 and l1/e1 of the pairs the TP chains group, each
// with hg_gemm's arguments in p0 / p1 = {A, W, bias, R, Z, out, out_z} and
// its (M, N, K), and hg_gemm_pair's lead (0: its rule). A TN product writes
// its HG_TN_SPLITS partials alone, as hg_gemm's does. Any other pair
// returns cudaErrorInvalidValue.
extern "C" int mbt_hgemm_pair_test(int l0, int e0, void* const* p0, int M0, int N0, int K0,
                                   int l1, int e1, void* const* p1, int M1, int N1, int K1,
                                   int lead, void* stream_ptr) {
    cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    if (l0 != TN || e0 != EPI_PARTIAL) return (int)cudaErrorInvalidValue;
    HgProduct<TN, EPI_PARTIAL> a;
    CHECK(hg_product(a, p0[0], p0[1], p0[2], p0[3], p0[4], p0[5], p0[6], M0, N0, K0));
#define HG_PAIR_CASE(L, E)                                                                  \
    if (l1 == L && e1 == E) {                                                               \
        HgProduct<L, E> b;                                                                  \
        CHECK(hg_product(b, p1[0], p1[1], p1[2], p1[3], p1[4], p1[5], p1[6], M1, N1, K1)); \
        return (int)hg_gemm_pair(a, b, s, lead);                                            \
    }
    HG_PAIR_CASE(TN, EPI_PARTIAL)
    HG_PAIR_CASE(NN, EPI_DGELU)
    HG_PAIR_CASE(NN, EPI_F32)
#undef HG_PAIR_CASE
    return (int)cudaErrorInvalidValue;
}

// B5_tp's core backward alone, for its tests, on separate q, k, v and the
// output gradient g (B*F*J rows of C, H heads): dq, dk, dv in fp32 (the
// pointers may be null) and bf16, and attn, all (B*F*J, C);
// stats 3 H B*F*J floats. split: the query-major and key-major launches
// (groups of 129..256 or 65..128 rows), else the one-launch kernel with
// attn.
extern "C" int mbt_attn_core_bwd_attn_test(const void* q, const void* k, const void* v,
                                           const void* g, void* dqf, void* dkf, void* dvf,
                                           void* dqb, void* dkb, void* dvb, void* attn,
                                           float* stats, int B, int F, int J, int C, int H,
                                           float scale, int temporal, int split,
                                           void* stream_ptr) {
    TcArgs a{};
    a.q = q, a.k = k, a.v = v, a.g = g;
    a.dqf = dqf, a.dkf = dkf, a.dvf = dvf, a.dqb = dqb, a.dkb = dkb, a.dvb = dvb;
    a.out = attn, a.stats = stats;
    a.ld = C, a.ld_g = C, a.ld_out = C, a.ld_out_attn = C;
    a.B = B, a.F = F, a.J = J, a.C = C, a.H = H;
    a.scale = scale;
    a.temporal = temporal;
    return (int)launch_attention_tc_bwd_attn(a, split != 0,
                                             static_cast<cudaStream_t>(stream_ptr));
}

// The core backward's launches in B5_tp's chain at these shapes, launching
// nothing: out[0] the launch count, then (blocks, blocks an SM holds) of
// each launch; out[5] the device's SMs.
extern "C" int mbt_attn_tp_bwd_core_grid(int B, int F, int J, int C, int H, int temporal,
                                         int* out) {
    TcArgs a{};
    a.B = B, a.F = F, a.J = J, a.C = C, a.H = H;
    a.temporal = temporal;
    out[0] = out[1] = out[2] = out[3] = out[4] = 0;
    CHECK(launch_attention_tc_bwd_attn(a, tc_split_backward(temporal ? F : J), nullptr, out));
    int dev = 0;
    CHECK(cudaGetDevice(&dev));
    CHECK(cudaDeviceGetAttribute(&out[5], cudaDevAttrMultiProcessorCount, dev));
    return 0;
}

// The LayerNorm inside a product alone, for its tests: out (M, N) =
// bf16(LN(x)) W^T + bias; fused: one launch of hg_ln_gemm
// (cudaErrorInvalidValue where lng_takes(C) does not hold), else
// ln_fwd_rows into h (M, C) and hg_gemm<NT, EPI_BIAS>.
extern "C" int mbt_ln_gemm_test(const void* x, const void* ln_w, const void* ln_b, const void* W,
                                const void* bias, void* out, void* h, int M, int N, int C,
                                int fused, void* stream_ptr) {
    cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
    if (fused) return (int)hg_ln_gemm(x, ln_w, ln_b, W, bias, out, M, N, C, s);
    CHECK(launch_ln_fwd_rows(x, ln_w, ln_b, h, nullptr, M, C, s));
    return (int)hg_gemm<NT, EPI_BIAS>(h, W, bias, nullptr, nullptr, out, nullptr, M, N, C, s);
}

// The LayerNorm-in-product constants ops/fused_mlp.py names (LN_PRODUCT):
// the widest row, the M tile, the weight ring; -1 for any other name.
extern "C" int mbt_ln_gemm_constant(const char* name) {
    static const struct { const char* name; int value; } table[] = {
        {"max_c", LNG_MAX_C}, {"bm", LNG_BM}, {"stages", LNG_STAGES}};
    for (const auto& entry : table)
        if (strcmp(entry.name, name) == 0) return entry.value;
    return -1;
}

// B4_tp's forward core alone, for its tests, on separate q, k, v (B*F*J rows
// of C, H heads): out (B*F*J, C) = attn; split: the split forward (groups of
// 65..256 rows), else the one-launch kernel.
extern "C" int mbt_attn_core_fwd_test(const void* q, const void* k, const void* v, void* out,
                                      int B, int F, int J, int C, int H, float scale,
                                      int temporal, int split, void* stream_ptr) {
    TcArgs a{};
    a.q = q, a.k = k, a.v = v, a.out = out;
    a.ld = C, a.ld_out = C;
    a.B = B, a.F = F, a.J = J, a.C = C, a.H = H;
    a.scale = scale;
    a.temporal = temporal;
    return (int)launch_attention_tc_sliced(a, split != 0, static_cast<cudaStream_t>(stream_ptr));
}

// The forward core's launch in B4_tp's chain at these shapes, launching
// nothing: out[0] the launch count (1), out[1] its blocks, out[2] the blocks
// an SM holds of it, out[3] the device's SMs.
extern "C" int mbt_attn_tp_fwd_core_grid(int B, int F, int J, int C, int H, int temporal,
                                         int* out) {
    TcArgs a{};
    a.B = B, a.F = F, a.J = J, a.C = C, a.H = H;
    a.temporal = temporal;
    out[0] = out[1] = out[2] = 0;
    CHECK(launch_attention_tc_sliced(a, tc_split_forward(temporal ? F : J), nullptr, out));
    int dev = 0;
    CHECK(cudaGetDevice(&dev));
    CHECK(cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev));
    return 0;
}
