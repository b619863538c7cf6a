// Device code the engine's chains share (pair_chain.cuh, the forward pairs;
// pair_bwd_kernels.cu, the pair backward; block_kernels.cu, the standalone
// attention and MLP blocks): LayerNorm forward-with-statistics, the LayerNorm
// backward with its parameter sums (ln_bwd_fused_kernel), the att_fuse gate
// backward, the bias column sums (colsum_chunks_kernel), the in-order pass
// that adds the chunk partials of both (chunk_sum_kernel), and the in-order
// pass that adds the weight gradients' fixed-chunk partials (reduce_splits;
// the partials come from hopper_gemm.cuh's TN products). bf16 with fp32
// accumulation, for NVIDIA Hopper (sm_90a); built on pair_common.cuh.
//
// Every reduction over the token rows cuts them into fixed chunks, writes
// fp32 partials and adds them in chunk order: no float atomics, so two runs
// give the same bits.

#pragma once

#include "pair_common.cuh"

namespace {

constexpr int COL_THREADS = 256;   // reduce_splits: one thread per output
constexpr int COL_SPLITS = 64;     // fixed row chunks of a bias column sum
constexpr int COL_BATCH = 32;      // rows (partials) a column-sum (chunk_sum) thread
                                   // loads before it adds
constexpr int COLSUM_THREADS = 128;  // colsum_chunks_kernel blocks: 256 columns
constexpr int SUM_THREADS = 32;    // chunk_sum_kernel blocks: a warp, 32 columns
constexpr int LN_SPLITS = 256;     // fixed row chunks of the LayerNorm parameter sums
constexpr int LN_SLICE = 512;      // columns a LayerNorm-backward block keeps sums of
constexpr int LN_PAIRS = LN_SLICE / 64;   // column pairs of a slice a lane owns

// fp32 LayerNorm statistics of the row (var = E[x^2] - mean^2) and the bf16
// normalised row h = bf16(((x - mean) * rstd) * w + b), the arithmetic of the
// JAX kernels' LayerNorm. The statistics (mean, rstd) go to stats unless it
// is null (the forward chains, pair_chain.cuh's and the attention block's,
// keep none).
__global__ void __launch_bounds__(ROW_THREADS)
ln_fwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, bf16* __restrict__ h,
                   float2* __restrict__ stats, int M, int C) {
    const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const bf16* xr = x + (size_t)row * C;
    float s = 0.f, ss = 0.f;
    for (int k = lane * 2; k < C; k += 64) {
        const float2 v = load_bf162(xr + k);
        s += v.x + v.y;
        ss += v.x * v.x + v.y * v.y;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / C;
    const float var = ss / C - mean * mean;
    const float rstd = rsqrtf(var + LN_EPS);
    if (lane == 0 && stats != nullptr) stats[row] = make_float2(mean, rstd);
    bf16* hr = h + (size_t)row * C;
    for (int k = lane * 2; k < C; k += 64) {
        const float2 v = load_bf162(xr + k);
        const float h0 = ((v.x - mean) * rstd) * w[k] + b[k];
        const float h1 = ((v.y - mean) * rstd) * w[k + 1] + b[k + 1];
        *reinterpret_cast<bf162*>(hr + k) = __floats2bfloat162_rn(h0, h1);
    }
}

__device__ __forceinline__ bf162 bf162_zero() { return __floats2bfloat162_rn(0.f, 0.f); }

// The LayerNorm backward with its parameter sums, one pass over the rows:
// out = bf16(rstd * (dy - mean(dy) - xhat * mean(dy * xhat)) + resid),
// dy = dh * w, xhat = (x - mean) * rstd; dh fp32; x, resid, out bf16;
// resid == nullptr adds nothing. Beside each row's out it sums, per column,
// dh * xhat (the scale's gradient) and dh (the bias's) into the fp32 partial
// row part[y, 0:C) and part[y, C:2C) of its row chunk y.
//
// Replaces the TPU function _ln_bwd_rows (motionbert_tpu/ops/attention.py:416)
// inside the TPU kernels of B3, B5 and B7, which accumulates both sums across
// its sequential grid while it forms the rows. Bound: it must read dh (fp32), x
// and resid (bf16) once and write out once, 10 bytes an element against ~15
// fp32 operations; at (16524, 512) 84.6 MB, 0.0253 ms at 3.35 TB/s: bound by
// bytes. Design: block (s, y) owns the fixed row chunk y of LN_SPLITS and the
// column slice s of LN_SLICE (one slice for C <= LN_SLICE). A warp takes the
// chunk's rows in turn (m0 + warp, + 8, ...), forms each row's means from the
// whole row with the row passes' lane map (column pairs lane * 2 + 64 i, float2
// loads, warp_sum; out does not depend on the slicing), writes out and adds
// each of its lane's columns to two running sums in registers. With one slice
// the row's dh, x and resid are loaded once, into registers, every load of the
// row in flight before the first sum; a wider row loads its slice again (from
// L1). At the end of the chunk the warps' sums meet in shared memory. So dh and
// x are read once (separate column sums and a row pass would read them three
// and two times), and LN_SPLITS blocks of ROW_THREADS keep two blocks, 16 warps,
// on each SM at M = 16524-34816. The fixed order of a column's sum: a warp adds
// its rows in row order; the block adds its 8 warps' sums in warp order;
// chunk_sum_kernel adds the LN_SPLITS chunk sums in chunk order. LN_SPLITS is a
// constant, so the bits do not depend on the card.
__global__ void __launch_bounds__(ROW_THREADS, 2)
ln_bwd_fused_kernel(const float* __restrict__ dh, const bf16* __restrict__ x,
                    const float2* __restrict__ stats, const float* __restrict__ w,
                    const bf16* __restrict__ resid, bf16* __restrict__ out, int M, int C,
                    int chunk, float* __restrict__ part) {
    __shared__ float2 red[ROW_THREADS / 32][LN_SLICE / 2];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c0 = blockIdx.x * LN_SLICE;
    const bool whole = C <= LN_SLICE;
    const int m0 = blockIdx.y * chunk, m1 = min(M, m0 + chunk);
    float2 sw[LN_PAIRS], sb[LN_PAIRS];
#pragma unroll
    for (int i = 0; i < LN_PAIRS; ++i) sw[i] = sb[i] = make_float2(0.f, 0.f);
    for (int row = m0 + warp; row < m1; row += ROW_THREADS / 32) {
        const float2 st = stats[row];
        const float* dr = dh + (size_t)row * C;
        const bf16* xr = x + (size_t)row * C;
        const bf16* rr = resid ? resid + (size_t)row * C : nullptr;
        float2 d[LN_PAIRS];
        bf162 v[LN_PAIRS], r[LN_PAIRS];   // x and resid as loaded
        float s1 = 0.f, s2 = 0.f;
        for (int base = 0; base < C; base += LN_SLICE) {
#pragma unroll
            for (int i = 0; i < LN_PAIRS; ++i) {
                const int k = base + lane * 2 + 64 * i;
                if (k < C) {
                    d[i] = *reinterpret_cast<const float2*>(dr + k);
                    v[i] = *reinterpret_cast<const bf162*>(xr + k);
                    r[i] = (whole && rr) ? *reinterpret_cast<const bf162*>(rr + k) : bf162_zero();
                }
            }
#pragma unroll
            for (int i = 0; i < LN_PAIRS; ++i) {
                const int k = base + lane * 2 + 64 * i;
                if (k < C) {
                    const float2 xv = __bfloat1622float2(v[i]);
                    const float dy0 = d[i].x * w[k], dy1 = d[i].y * w[k + 1];
                    s1 += dy0 + dy1;
                    s2 += dy0 * ((xv.x - st.x) * st.y) + dy1 * ((xv.y - st.x) * st.y);
                }
            }
        }
        const float m1r = warp_sum(s1) / C;
        const float m2r = warp_sum(s2) / C;
        bf16* orow = out + (size_t)row * C;
#pragma unroll
        for (int i = 0; i < LN_PAIRS; ++i) {
            const int k = c0 + lane * 2 + 64 * i;
            if (k < C) {
                if (!whole) {
                    d[i] = *reinterpret_cast<const float2*>(dr + k);
                    v[i] = *reinterpret_cast<const bf162*>(xr + k);
                    r[i] = rr ? *reinterpret_cast<const bf162*>(rr + k) : bf162_zero();
                }
                const float2 xv = __bfloat1622float2(v[i]), rv = __bfloat1622float2(r[i]);
                const float xh0 = (xv.x - st.x) * st.y, xh1 = (xv.y - st.x) * st.y;
                const float o0 = st.y * (d[i].x * w[k] - m1r - xh0 * m2r) + rv.x;
                const float o1 = st.y * (d[i].y * w[k + 1] - m1r - xh1 * m2r) + rv.y;
                *reinterpret_cast<bf162*>(orow + k) = __floats2bfloat162_rn(o0, o1);
                sw[i].x += d[i].x * xh0;
                sw[i].y += d[i].y * xh1;
                sb[i].x += d[i].x;
                sb[i].y += d[i].y;
            }
        }
    }
    // the warps' sums, added in warp order: the scale's, then the bias's
    float* prow = part + (size_t)blockIdx.y * 2 * C;
    for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < LN_PAIRS; ++i) red[warp][lane + 32 * i] = half ? sb[i] : sw[i];
        __syncthreads();
        for (int j = threadIdx.x; j < LN_SLICE / 2; j += ROW_THREADS) {
            const int k = c0 + 2 * j;
            if (k < C) {
                float2 s = make_float2(0.f, 0.f);
#pragma unroll
                for (int wp = 0; wp < ROW_THREADS / 32; ++wp) {
                    s.x += red[wp][j].x;
                    s.y += red[wp][j].y;
                }
                *reinterpret_cast<float2*>(prow + half * C + k) = s;
            }
        }
        __syncthreads();
    }
}

// att_fuse gate backward, one warp per token row (_pair_bwd_body's gated
// branch): fp32 logits s_k = other.wg[k, :C] + out_b.wg[k, C:] + bg[k] and
// softmax alpha; dal_k = g.{other, out_b}; dsg = alpha * (dal - dal.alpha) in
// fp32 (kept for dbg and dwg), rounded to bf16 for the products;
// dother = bf16(g * a0 + dsgb.wg[:, :C]), gmlp = bf16(g * a1 + dsgb.wg[:, C:]).
__global__ void __launch_bounds__(ROW_THREADS)
gate_bwd_rows_kernel(const bf16* __restrict__ other, const bf16* __restrict__ outb,
                     const bf16* __restrict__ g, const bf16* __restrict__ wg,
                     const bf16* __restrict__ bg, bf16* __restrict__ dother,
                     bf16* __restrict__ gmlp, float* __restrict__ dsg, int M, int C) {
    const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const size_t off = (size_t)row * C;
    const bf16* w0 = wg;
    const bf16* w1 = wg + 2 * C;
    float s0a = 0.f, s1a = 0.f, s0b = 0.f, s1b = 0.f, d0 = 0.f, d1 = 0.f;
    for (int c = lane * 2; c < C; c += 64) {
        const float2 ov = load_bf162(other + off + c);
        const float2 uv = load_bf162(outb + off + c);
        const float2 gv = load_bf162(g + off + c);
        const float2 w0a = load_bf162(w0 + c), w1a = load_bf162(w1 + c);
        const float2 w0b = load_bf162(w0 + C + c), w1b = load_bf162(w1 + C + c);
        s0a += ov.x * w0a.x + ov.y * w0a.y;
        s1a += ov.x * w1a.x + ov.y * w1a.y;
        s0b += uv.x * w0b.x + uv.y * w0b.y;
        s1b += uv.x * w1b.x + uv.y * w1b.y;
        d0 += gv.x * ov.x + gv.y * ov.y;
        d1 += gv.x * uv.x + gv.y * uv.y;
    }
    s0a = warp_sum(s0a);
    s1a = warp_sum(s1a);
    s0b = warp_sum(s0b);
    s1b = warp_sum(s1b);
    d0 = warp_sum(d0);
    d1 = warp_sum(d1);
    const float sg0 = s0a + s0b + __bfloat162float(bg[0]);
    const float sg1 = s1a + s1b + __bfloat162float(bg[1]);
    const float mx = fmaxf(sg0, sg1);
    const float e0 = expf(sg0 - mx), e1 = expf(sg1 - mx);
    const float a0 = e0 / (e0 + e1), a1 = e1 / (e0 + e1);
    const float t = d0 * a0 + d1 * a1;
    const float ds0 = a0 * (d0 - t), ds1 = a1 * (d1 - t);
    if (lane == 0) *reinterpret_cast<float2*>(dsg + 2 * (size_t)row) = make_float2(ds0, ds1);
    const float b0 = round_bf16(ds0), b1 = round_bf16(ds1);
    for (int c = lane * 2; c < C; c += 64) {
        const float2 gv = load_bf162(g + off + c);
        const float2 w0a = load_bf162(w0 + c), w1a = load_bf162(w1 + c);
        const float2 w0b = load_bf162(w0 + C + c), w1b = load_bf162(w1 + C + c);
        *reinterpret_cast<bf162*>(dother + off + c) = __floats2bfloat162_rn(
            gv.x * a0 + (b0 * w0a.x + b1 * w1a.x), gv.y * a0 + (b0 * w0a.y + b1 * w1a.y));
        *reinterpret_cast<bf162*>(gmlp + off + c) = __floats2bfloat162_rn(
            gv.x * a1 + (b0 * w0b.x + b1 * w1b.x), gv.y * a1 + (b0 * w0b.y + b1 * w1b.y));
    }
}

enum ColMode {
    COL_BF16 = 0,   // sum_m src[m, c], src bf16
    COL_F32 = 1,    // sum_m src[m, c], src fp32
    COL_GATE = 2    // sum_m bf16(w[m, 0]) * src[m, c], src bf16, w fp32 with row stride 2
};

// Columns c, c + 1 of src's row m, as fp32.
template <int MODE>
__device__ __forceinline__ float2 col_pair(const void* src, size_t o) {
    if (MODE == COL_F32) return *reinterpret_cast<const float2*>(static_cast<const float*>(src) + o);
    return load_bf162(static_cast<const bf16*>(src) + o);
}

// The bias column sums' first pass: the fixed row chunk y = blockIdx.y of
// COL_SPLITS, rows [y * chunk, y * chunk + chunk), of columns c and c + 1 of
// an (M, N) source, N even; the fp32 partials go to part[y, c:c + 2]. Each
// column is a serial sum over the chunk's rows in row order (the bits do not
// depend on the batching below). A thread a column with one dependent load a
// row would be bound by latency (at N = 512, 64 x 2 blocks, about one an
// SM); here a thread loads COL_BATCH rows of its two columns (a bf162 or a
// float2 each) before it adds them in order, so a warp keeps 32 loads of 128
// or 256 bytes in flight, ~2-13 MB across the card at the chains' widths.
template <int MODE>
__global__ void __launch_bounds__(COLSUM_THREADS)
colsum_chunks_kernel(const void* __restrict__ src, const float* __restrict__ w, int M, int N,
                     int chunk, float* __restrict__ part) {
    const int c = 2 * (blockIdx.x * COLSUM_THREADS + threadIdx.x);
    if (c >= N) return;
    const int m0 = blockIdx.y * chunk, m1 = min(M, m0 + chunk);
    float s0 = 0.f, s1 = 0.f;
    int m = m0;
    for (; m + COL_BATCH <= m1; m += COL_BATCH) {
        float2 v[COL_BATCH];
        float g[COL_BATCH];
#pragma unroll
        for (int j = 0; j < COL_BATCH; ++j) {
            v[j] = col_pair<MODE>(src, (size_t)(m + j) * N + c);
            if (MODE == COL_GATE) g[j] = round_bf16(w[2 * (size_t)(m + j)]);
        }
#pragma unroll
        for (int j = 0; j < COL_BATCH; ++j) {
            if (MODE == COL_GATE) {
                s0 += g[j] * v[j].x;
                s1 += g[j] * v[j].y;
            } else {
                s0 += v[j].x;
                s1 += v[j].y;
            }
        }
    }
    for (; m < m1; ++m) {
        const float2 v = col_pair<MODE>(src, (size_t)m * N + c);
        if (MODE == COL_GATE) {
            const float g = round_bf16(w[2 * (size_t)m]);
            s0 += g * v.x;
            s1 += g * v.y;
        } else {
            s0 += v.x;
            s1 += v.y;
        }
    }
    *reinterpret_cast<float2*>(part + (size_t)blockIdx.y * N + c) = make_float2(s0, s1);
}

// The column sums' second pass: out[i] = the sum over chunks k in order of
// part[k, i] (0 <= i < n), as bf16 or fp32, to lo[i] for i < n_lo and to
// hi[i - n_lo] above (the LayerNorm backward's two gradients from one
// partial row). A thread loads COL_BATCH partials before it adds them in
// order: the bits of reduce_splits, without its dependent loads. A block is
// one warp, so that the LayerNorm backward's 1024 sums at C = 512 spread over
// 32 SMs.
__global__ void __launch_bounds__(SUM_THREADS)
chunk_sum_kernel(const float* __restrict__ part, int splits, int n, int n_lo,
                 void* __restrict__ lo, void* __restrict__ hi, int out_bf16) {
    const int i = blockIdx.x * SUM_THREADS + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    int k = 0;
    for (; k + COL_BATCH <= splits; k += COL_BATCH) {
        float v[COL_BATCH];
#pragma unroll
        for (int j = 0; j < COL_BATCH; ++j) v[j] = part[(size_t)(k + j) * n + i];
#pragma unroll
        for (int j = 0; j < COL_BATCH; ++j) s += v[j];
    }
    for (; k < splits; ++k) s += part[(size_t)k * n + i];
    void* out = i < n_lo ? lo : hi;
    const int o = i < n_lo ? i : i - n_lo;
    if (out_bf16)
        static_cast<bf16*>(out)[o] = __float2bfloat16(s);
    else
        static_cast<float*>(out)[o] = s;
}

cudaError_t chunk_sum(const float* part, int splits, int n, int n_lo, void* lo, void* hi,
                      bool out_bf16, cudaStream_t stream) {
    chunk_sum_kernel<<<(n + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, stream>>>(
        part, splits, n, n_lo, lo, hi, out_bf16 ? 1 : 0);
    return cudaGetLastError();
}

// out[i] = sum over s in order of part[s, i], as bf16 or fp32: the second
// pass of hg_weight_grad (hopper_gemm.cuh).
__global__ void __launch_bounds__(COL_THREADS)
reduce_splits_kernel(const float* __restrict__ part, int splits, int n,
                     void* __restrict__ out, int out_bf16) {
    const int i = blockIdx.x * COL_THREADS + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
    if (out_bf16)
        static_cast<bf16*>(out)[i] = __float2bfloat16(s);
    else
        static_cast<float*>(out)[i] = s;
}

cudaError_t reduce_splits(const float* part, int splits, int n, void* out, bool out_bf16,
                          cudaStream_t stream) {
    reduce_splits_kernel<<<(n + COL_THREADS - 1) / COL_THREADS, COL_THREADS, 0, stream>>>(
        part, splits, n, out, out_bf16 ? 1 : 0);
    return cudaGetLastError();
}

// out (N) = the column sums of an (M, N) source (MODE; w is read by COL_GATE
// only), N even: COL_SPLITS chunk partials in work (COL_SPLITS * N floats),
// then chunk_sum. Two launches.
template <int MODE>
cudaError_t column_sum(const void* src, const float* w, int M, int N, float* work, void* out,
                       bool out_bf16, cudaStream_t stream) {
    if (N % 2) return cudaErrorInvalidValue;
    const int chunk = (M + COL_SPLITS - 1) / COL_SPLITS;
    const dim3 grid((N / 2 + COLSUM_THREADS - 1) / COLSUM_THREADS, COL_SPLITS);
    colsum_chunks_kernel<MODE><<<grid, COLSUM_THREADS, 0, stream>>>(src, w, M, N, chunk, work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return chunk_sum(work, COL_SPLITS, N, N, out, nullptr, out_bf16, stream);
}

cudaError_t launch_ln_fwd_rows(const void* x, const void* w, const void* b, void* h,
                               void* stats, int M, int C, cudaStream_t stream) {
    const int blocks = (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
    ln_fwd_rows_kernel<<<blocks, ROW_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<bf16*>(h), static_cast<float2*>(stats),
        M, C);
    return cudaGetLastError();
}

// The LayerNorm backward of (M, C) rows, C even: out = bf16(LN-backward(dh)
// [+ resid]), dln_w = sum_m dh * xhat and dln_b = sum_m dh (fp32) through
// LN_SPLITS chunk partials in work (LN_SPLITS * 2C floats) and chunk_sum.
// Two launches.
cudaError_t launch_ln_bwd(const void* dh, const void* x, const void* stats, const void* w,
                          const void* resid, void* out, void* dln_w, void* dln_b, float* work,
                          int M, int C, cudaStream_t stream) {
    if (C % 2) return cudaErrorInvalidValue;
    const int chunk = (M + LN_SPLITS - 1) / LN_SPLITS;
    const dim3 grid((C + LN_SLICE - 1) / LN_SLICE, LN_SPLITS);
    ln_bwd_fused_kernel<<<grid, ROW_THREADS, 0, stream>>>(
        static_cast<const float*>(dh), static_cast<const bf16*>(x),
        static_cast<const float2*>(stats), static_cast<const float*>(w),
        static_cast<const bf16*>(resid), static_cast<bf16*>(out), M, C, chunk, work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return chunk_sum(work, LN_SPLITS, 2 * C, C, dln_w, dln_b, false, stream);
}

#define CHECK(expr)                                  \
    do {                                             \
        const cudaError_t err_ = (expr);             \
        if (err_ != cudaSuccess) return (int)err_;   \
    } while (0)

}  // namespace
