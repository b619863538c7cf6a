// Device code the backward chains share (pair_bwd_kernels.cu, the pair
// backward, and block_kernels.cu, the standalone attention and MLP blocks):
// LayerNorm forward-with-statistics and backward over token rows, the
// att_fuse gate backward, the attention core's backward, deterministic column
// sums and the weight-gradient GEMM with its split reduction. bf16 with fp32
// accumulation, for NVIDIA Hopper (sm_90a); built on pair_common.cuh.
//
// Every reduction over the token rows cuts them into fixed chunks, writes
// fp32 partials and adds them in chunk order: no float atomics, so two runs
// give the same bits.

#pragma once

#include "pair_common.cuh"

namespace {

constexpr int ROW_THREADS = 256;   // one warp per token row
constexpr int COL_THREADS = 256;   // one thread per column
constexpr int COL_SPLITS = 64;     // fixed row chunks of a column sum
constexpr int TN_SPLITS = 8;       // fixed row chunks of a weight gradient

// fp32 LayerNorm statistics of the row (var = E[x^2] - mean^2) and the bf16
// normalised row h = bf16(((x - mean) * rstd) * w + b); the same arithmetic as
// the GEMM's LayerNorm prologue.
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
    if (lane == 0) stats[row] = make_float2(mean, rstd);
    bf16* hr = h + (size_t)row * C;
    for (int k = lane * 2; k < C; k += 64) {
        const float2 v = load_bf162(xr + k);
        const float h0 = ((v.x - mean) * rstd) * w[k] + b[k];
        const float h1 = ((v.y - mean) * rstd) * w[k + 1] + b[k + 1];
        *reinterpret_cast<bf162*>(hr + k) = __floats2bfloat162_rn(h0, h1);
    }
}

// LayerNorm backward of one row plus the residual gradient:
// out = bf16(rstd * (dy - mean(dy) - xhat * mean(dy * xhat)) + resid),
// dy = dh * w, xhat = (x - mean) * rstd. dh fp32; x, resid, out bf16;
// resid == nullptr adds nothing.
__global__ void __launch_bounds__(ROW_THREADS)
ln_bwd_rows_kernel(const float* __restrict__ dh, const bf16* __restrict__ x,
                   const float2* __restrict__ stats, const float* __restrict__ w,
                   const bf16* __restrict__ resid, bf16* __restrict__ out,
                   int M, int C) {
    const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const float2 st = stats[row];
    const float* dr = dh + (size_t)row * C;
    const bf16* xr = x + (size_t)row * C;
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane * 2; k < C; k += 64) {
        const float2 d = *reinterpret_cast<const float2*>(dr + k);
        const float2 v = load_bf162(xr + k);
        const float dy0 = d.x * w[k], dy1 = d.y * w[k + 1];
        s1 += dy0 + dy1;
        s2 += dy0 * ((v.x - st.x) * st.y) + dy1 * ((v.y - st.x) * st.y);
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
    bf16* orow = out + (size_t)row * C;
    for (int k = lane * 2; k < C; k += 64) {
        const float2 d = *reinterpret_cast<const float2*>(dr + k);
        const float2 v = load_bf162(xr + k);
        const float2 r = resid ? load_bf162(resid + (size_t)row * C + k)
                               : make_float2(0.f, 0.f);
        const float o0 = st.y * (d.x * w[k] - m1 - ((v.x - st.x) * st.y) * m2) + r.x;
        const float o1 = st.y * (d.y * w[k + 1] - m1 - ((v.y - st.x) * st.y) * m2) + r.y;
        *reinterpret_cast<bf162*>(orow + k) = __floats2bfloat162_rn(o0, o1);
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

// Attention backward over one (group, head) per block, in fp32 on CUDA cores,
// at _pair_bwd_body's rounding points: fp32 P, dv = bf16(P)^T dO,
// dp = dO v^T, ds = bf16(P * (dp - rowsum(dp * P)) * scale), dq = ds k,
// dk = ds^T q. q, k, v and dO (= bf16 dattn) of the group sit in shared memory.
// Pass 1, a warp per query row i: the row's scores, max, sum and D_i =
// rowsum(dp * P) (kept in shared memory), then dq_i. Pass 2, a warp per key
// row j: recomputes P[:, j] and ds[:, j] from the kept statistics (lanes over
// the query rows), then dk_j and dv_j (lanes over channels). Writes dqkv in
// fp32 (for dbqkv) and in bf16 (for dWqkv and dh1).
template <int D>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dattn,
                     float* __restrict__ dqkv, bf16* __restrict__ dqkvb,
                     int F, int J, int C, float scale, int temporal) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int LDK = D + 2;
    const int h = blockIdx.y;
    int N, base, stride;
    attention_group(blockIdx.x, F, J, temporal, &N, &base, &stride);
    const int nwarps = ATTN_THREADS / 32;
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Ks = Qs + N * LDK;
    bf16* Vs = Ks + N * LDK;
    bf16* Gs = Vs + N * LDK;
    float* row_max = reinterpret_cast<float*>(Gs + N * LDK);
    float* row_sum = row_max + N;
    float* row_d = row_sum + N;
    float* bufs = row_d + N;
    const size_t C3 = 3 * (size_t)C;

    for (int idx = threadIdx.x; idx < N * (D / 2); idx += ATTN_THREADS) {
        const int t = idx / (D / 2), c = (idx % (D / 2)) * 2;
        const size_t tok = (size_t)(base + t * stride);
        const bf16* row = qkv + tok * C3 + h * D + c;
        *reinterpret_cast<bf162*>(Qs + t * LDK + c) = *reinterpret_cast<const bf162*>(row);
        *reinterpret_cast<bf162*>(Ks + t * LDK + c) = *reinterpret_cast<const bf162*>(row + C);
        *reinterpret_cast<bf162*>(Vs + t * LDK + c) = *reinterpret_cast<const bf162*>(row + 2 * C);
        *reinterpret_cast<bf162*>(Gs + t * LDK + c) =
            *reinterpret_cast<const bf162*>(dattn + tok * C + h * D + c);
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* pa = bufs + warp * 2 * N;
    float* pb = pa + N;
    float r[D];

    // pass 1: query rows
    for (int i = warp; i < N; i += nwarps) {
#pragma unroll
        for (int c = 0; c < D; c += 2) {
            const float2 v = load_bf162(Qs + i * LDK + c);
            r[c] = v.x;
            r[c + 1] = v.y;
        }
        float mx = __int_as_float(0xff800000);  // -inf
        for (int m = lane; m < N; m += 32) {
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < D; c += 2) {
                const float2 kv = load_bf162(Ks + m * LDK + c);
                s += r[c] * kv.x + r[c + 1] * kv.y;
            }
            s *= scale;
            pa[m] = s;
            mx = fmaxf(mx, s);
        }
        mx = warp_max(mx);
        float sum = 0.f;
        for (int m = lane; m < N; m += 32) {
            const float e = expf(pa[m] - mx);
            pa[m] = e;
            sum += e;
        }
        sum = warp_sum(sum);
#pragma unroll
        for (int c = 0; c < D; c += 2) {
            const float2 v = load_bf162(Gs + i * LDK + c);
            r[c] = v.x;
            r[c + 1] = v.y;
        }
        float dsum = 0.f;
        for (int m = lane; m < N; m += 32) {
            const float p = pa[m] / sum;
            float dp = 0.f;
#pragma unroll
            for (int c = 0; c < D; c += 2) {
                const float2 vv = load_bf162(Vs + m * LDK + c);
                dp += r[c] * vv.x + r[c + 1] * vv.y;
            }
            pa[m] = p;
            pb[m] = dp;
            dsum += dp * p;
        }
        const float di = warp_sum(dsum);
        for (int m = lane; m < N; m += 32)
            pb[m] = round_bf16((pa[m] * (pb[m] - di)) * scale);
        if (lane == 0) {
            row_max[i] = mx;
            row_sum[i] = sum;
            row_d[i] = di;
        }
        __syncwarp();
        const size_t tok = (size_t)(base + i * stride);
        for (int c = lane * 2; c < D; c += 64) {
            float a0 = 0.f, a1 = 0.f;
            for (int m = 0; m < N; ++m) {
                const float ds = pb[m];
                const float2 kv = load_bf162(Ks + m * LDK + c);
                a0 += ds * kv.x;
                a1 += ds * kv.y;
            }
            const size_t o = tok * C3 + h * D + c;
            *reinterpret_cast<float2*>(dqkv + o) = make_float2(a0, a1);
            *reinterpret_cast<bf162*>(dqkvb + o) = __floats2bfloat162_rn(a0, a1);
        }
        __syncwarp();
    }
    __syncthreads();

    // pass 2: key rows
    for (int j = warp; j < N; j += nwarps) {
#pragma unroll
        for (int c = 0; c < D; c += 2) {
            const float2 v = load_bf162(Ks + j * LDK + c);
            r[c] = v.x;
            r[c + 1] = v.y;
        }
        for (int i = lane; i < N; i += 32) {
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < D; c += 2) {
                const float2 qv = load_bf162(Qs + i * LDK + c);
                s += qv.x * r[c] + qv.y * r[c + 1];
            }
            s *= scale;
            const float p = expf(s - row_max[i]) / row_sum[i];
            pa[i] = round_bf16(p);
            pb[i] = p;
        }
#pragma unroll
        for (int c = 0; c < D; c += 2) {
            const float2 v = load_bf162(Vs + j * LDK + c);
            r[c] = v.x;
            r[c + 1] = v.y;
        }
        for (int i = lane; i < N; i += 32) {
            float dp = 0.f;
#pragma unroll
            for (int c = 0; c < D; c += 2) {
                const float2 gv = load_bf162(Gs + i * LDK + c);
                dp += gv.x * r[c] + gv.y * r[c + 1];
            }
            pb[i] = round_bf16((pb[i] * (dp - row_d[i])) * scale);
        }
        __syncwarp();
        const size_t tok = (size_t)(base + j * stride);
        for (int c = lane * 2; c < D; c += 64) {
            float dk0 = 0.f, dk1 = 0.f, dv0 = 0.f, dv1 = 0.f;
            for (int i = 0; i < N; ++i) {
                const float pv = pa[i], ds = pb[i];
                const float2 qv = load_bf162(Qs + i * LDK + c);
                const float2 gv = load_bf162(Gs + i * LDK + c);
                dk0 += ds * qv.x;
                dk1 += ds * qv.y;
                dv0 += pv * gv.x;
                dv1 += pv * gv.y;
            }
            const size_t ok = tok * C3 + C + h * D + c;
            const size_t ov = tok * C3 + 2 * C + h * D + c;
            *reinterpret_cast<float2*>(dqkv + ok) = make_float2(dk0, dk1);
            *reinterpret_cast<bf162*>(dqkvb + ok) = __floats2bfloat162_rn(dk0, dk1);
            *reinterpret_cast<float2*>(dqkv + ov) = make_float2(dv0, dv1);
            *reinterpret_cast<bf162*>(dqkvb + ov) = __floats2bfloat162_rn(dv0, dv1);
        }
        __syncwarp();
    }
}

enum ColMode {
    COL_BF16 = 0,   // sum_m src[m, c], src bf16
    COL_F32 = 1,    // sum_m src[m, c], src fp32
    COL_LN_W = 2,   // sum_m dh[m, c] * xhat[m, c] (src = dh fp32, x bf16, row stats)
    COL_GATE = 3    // sum_m bf16(w[m, 0]) * src[m, c], src bf16, w fp32 with row stride 2
};

// One fixed chunk of rows [y * chunk, y * chunk + chunk) of a column sum,
// a thread per column; the fp32 partial goes to part[y, c].
template <int MODE>
__global__ void __launch_bounds__(COL_THREADS)
colsum_kernel(const void* __restrict__ src, const bf16* __restrict__ x,
              const float2* __restrict__ stats, const float* __restrict__ w,
              int M, int N, int chunk, float* __restrict__ part) {
    const int c = blockIdx.x * COL_THREADS + threadIdx.x;
    if (c >= N) return;
    const int m0 = blockIdx.y * chunk, m1 = min(M, m0 + chunk);
    float s = 0.f;
    for (int m = m0; m < m1; ++m) {
        const size_t o = (size_t)m * N + c;
        if (MODE == COL_BF16) {
            s += __bfloat162float(static_cast<const bf16*>(src)[o]);
        } else if (MODE == COL_F32) {
            s += static_cast<const float*>(src)[o];
        } else if (MODE == COL_LN_W) {
            const float2 st = stats[m];
            s += static_cast<const float*>(src)[o] * ((__bfloat162float(x[o]) - st.x) * st.y);
        } else {
            s += round_bf16(w[2 * (size_t)m]) * __bfloat162float(static_cast<const bf16*>(src)[o]);
        }
    }
    part[(size_t)blockIdx.y * N + c] = s;
}

// out[i] = sum over s in order of part[s, i], as bf16 or fp32.
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

template <int MODE>
cudaError_t column_sum(const void* src, const void* x, const void* stats, const float* w,
                       int M, int N, float* work, void* out, bool out_bf16,
                       cudaStream_t stream) {
    const int chunk = (M + COL_SPLITS - 1) / COL_SPLITS;
    const dim3 grid((N + COL_THREADS - 1) / COL_THREADS, COL_SPLITS);
    colsum_kernel<MODE><<<grid, COL_THREADS, 0, stream>>>(
        src, static_cast<const bf16*>(x), static_cast<const float2*>(stats), w, M, N, chunk,
        work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return reduce_splits(work, COL_SPLITS, N, out, out_bf16, stream);
}

// dW (rows, cols) bf16 = sum_m dY[m, :rows]^T A[m, :cols], through fp32 partials
cudaError_t weight_grad(const void* dY, const void* A, int M, int rows, int cols,
                        float* work, void* out, cudaStream_t stream) {
    cudaError_t err = launch_gemm<TN, false, EPI_PARTIAL>(
        dY, A, nullptr, nullptr, nullptr, nullptr, nullptr, work, nullptr, M, rows, cols,
        stream, TN_SPLITS);
    if (err != cudaSuccess) return err;
    return reduce_splits(work, TN_SPLITS, rows * cols, out, true, stream);
}

template <int D>
cudaError_t launch_attention_bwd(const void* qkv, const void* dattn, void* dqkv, void* dqkvb,
                                 int B, int F, int J, int C, float scale, int temporal,
                                 cudaStream_t stream) {
    const int N = temporal ? F : J;
    const size_t smem = 4 * (size_t)N * (D + 2) * sizeof(bf16)
                      + 3 * (size_t)N * sizeof(float)
                      + (size_t)(ATTN_THREADS / 32) * 2 * N * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(temporal ? B * J : B * F, C / D);
    attention_bwd_kernel<D><<<grid, ATTN_THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dattn),
        static_cast<float*>(dqkv), static_cast<bf16*>(dqkvb), F, J, C, scale, temporal);
    return cudaGetLastError();
}

cudaError_t launch_attention_bwd_any(const void* qkv, const void* dattn, void* dqkv,
                                     void* dqkvb, int B, int F, int J, int C, int H,
                                     float scale, int temporal, cudaStream_t stream) {
    const int D = C / H;
    if (D == 64)
        return launch_attention_bwd<64>(qkv, dattn, dqkv, dqkvb, B, F, J, C, scale,
                                        temporal, stream);
    if (D == 32)
        return launch_attention_bwd<32>(qkv, dattn, dqkv, dqkvb, B, F, J, C, scale,
                                        temporal, stream);
    return cudaErrorInvalidValue;
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

cudaError_t launch_ln_bwd_rows(const void* dh, const void* x, const void* stats,
                               const void* w, const void* resid, void* out, int M, int C,
                               cudaStream_t stream) {
    const int blocks = (M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
    ln_bwd_rows_kernel<<<blocks, ROW_THREADS, 0, stream>>>(
        static_cast<const float*>(dh), static_cast<const bf16*>(x),
        static_cast<const float2*>(stats), static_cast<const float*>(w),
        static_cast<const bf16*>(resid), static_cast<bf16*>(out), M, C);
    return cudaGetLastError();
}

#define CHECK(expr)                                  \
    do {                                             \
        const cudaError_t err_ = (expr);             \
        if (err_ != cudaSuccess) return (int)err_;   \
    } while (0)

}  // namespace
