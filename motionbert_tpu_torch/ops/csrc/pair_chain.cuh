// The bf16 forward chain of one DSTformer attention+MLP pair (pair_chain),
// which the pair and gated pair (pair_kernels.cu) and the bf16 stream
// (stream_kernels.cu, both passes) run: every product on hopper_gemm.cuh,
// the wgmma + TMA engine, the attention core on attention_tc.cuh's
// tensor-core forward (attn_tc_fwd_kernel), the two LayerNorms as row passes
// (pair_bwd_common.cuh's ln_fwd_rows_kernel). The pair backward
// (pair_bwd_kernels.cu) recomputes the same forward with the same launches,
// so the forward's P comes from the same tc_scores / tc_softmax as the
// backward's.
//
// It sits in a header of its own because hopper_gemm.cuh includes
// pair_bwd_common.cuh, which includes pair_common.cuh: the chain needs the
// engine, so pair_common.cuh cannot hold it.
//
// Everything is in an anonymous namespace, like the other headers.

#pragma once

#include "attention_tc.cuh"
#include "hopper_gemm.cuh"

namespace {

// The 12 parameters of one pair, in the order of ops/fused_pair.py's
// PAIR_PARAMS: LayerNorm parameters fp32, the rest bf16, weights (out, in).
struct PairParams {
    const void *ln1_w, *ln1_b, *wqkv, *bqkv, *wproj, *bproj,
               *ln2_w, *ln2_b, *w1, *b1, *w2, *b2;
};

// One pair's chain of seven launches (pair_kernels.cu's note): out = pair(x)
// on M = B*F*J token rows, with scratch qkv (M, 3C), attn (M, C), y (M, C)
// and hid (M, hidden), all bf16. attn holds LN1's rows h1 until the core
// overwrites them (qkv has read them by then), and LN2's rows h2 once proj
// has read the core's output; no LayerNorm statistics are written. x is read
// by the first and fourth launch only, so out may alias x's buffer once they
// have run: the stream chain (stream_kernels.cu) reads its inter-pair
// activation from the buffer that pass 2's last GEMM writes. The engine
// reads x's rows as proj's residual and the weights through TMA: they must
// sit at 16-byte-aligned addresses (hg_gemm returns cudaErrorInvalidValue
// otherwise).
cudaError_t pair_chain(const void* x, void* out, void* qkv, void* attn, void* y, void* hid,
                       const PairParams& p, int B, int F, int J, int C, int H, int hidden,
                       float scale, int temporal, cudaStream_t stream) {
    const int M = B * F * J;
    cudaError_t err;
    err = launch_ln_fwd_rows(x, p.ln1_w, p.ln1_b, attn, nullptr, M, C, stream);
    if (err != cudaSuccess) return err;
    err = hg_gemm<NT, EPI_BIAS>(attn, p.wqkv, p.bqkv, nullptr, nullptr, qkv, nullptr, M, 3 * C,
                                C, stream);
    if (err != cudaSuccess) return err;
    TcArgs core = tc_packed_args(qkv, B, F, J, C, H, scale, temporal);
    core.out = attn;
    core.ld_out = C;
    err = launch_attention_tc(core, false, stream);
    if (err != cudaSuccess) return err;
    err = hg_gemm<NT, EPI_BIAS_RES>(attn, p.wproj, p.bproj, x, nullptr, y, nullptr, M, C, C,
                                    stream);
    if (err != cudaSuccess) return err;
    err = launch_ln_fwd_rows(y, p.ln2_w, p.ln2_b, attn, nullptr, M, C, stream);
    if (err != cudaSuccess) return err;
    err = hg_gemm<NT, EPI_BIAS_GELU>(attn, p.w1, p.b1, nullptr, nullptr, hid, nullptr, M,
                                     hidden, C, stream);
    if (err != cudaSuccess) return err;
    return hg_gemm<NT, EPI_BIAS_RES>(hid, p.w2, p.b2, y, nullptr, out, nullptr, M, C, hidden,
                                     stream);
}

}  // namespace
