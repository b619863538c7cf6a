// The attention core on tensor cores, forward and backward, for NVIDIA
// Hopper (sm_90a): bf16 operands and fp32 accumulation through
// mma.sync.m16n8k16 fed by ldmatrix. The forward pairs (pair_chain.cuh), the
// W8A8 pair (pair_q8_common.cuh), the attention block's forward
// (block_kernels.cu) and the standalone core (st_attention_kernels.cu) run
// the forward; the pair backward (pair_bwd_kernels.cu) and the attention
// block's backward (block_kernels.cu) run both, the forward in their
// recompute and the backward for dq, dk and dv. They replace the attention
// part of the TPU kernels motionbert_tpu/ops/fused_pair.py:_pair_pallas,
// _pair_bwd_pallas (_pair_bwd_body's per-head recompute of P and its
// attention backward), motionbert_tpu/ops/pair_q8.py:_q8_launch and
// motionbert_tpu/ops/attention.py:_fused_block_pallas,
// _fused_block_bwd_pallas, and the TPU cores _temporal_pallas and
// _spatial_pallas whole.
//
// Rounding points, those of the JAX kernels' _pair_bwd_body
// (motionbert_tpu/ops/fused_pair.py) and _fused_block_bwd_kernel
// (motionbert_tpu/ops/attention.py), and in the forward those of the plain
// core (ops/attention.py's st_attention_plain) and the TPU cores of B1 and
// B8:
//   S = (q . k) * scale in fp32; P = exp(S - rowmax) / rowsum in fp32
//   (as exp(S - rowmax) times the row's fp32 reciprocal: one fp32 rounding
//   apart, and far cheaper than a division per element);
//   forward  attn = bf16(bf16(P) v)
//   backward dv = bf16(P)^T dO; dP = dO v^T; D = rowsum(dP * P);
//            dS = bf16((P * (dP - D)) * scale); dq = dS k; dk = dS^T q;
//            dq, dk, dv written in fp32 and in bf16.
// Every product takes bf16 operands and sums in fp32, so the MMA takes them
// exactly. P is normalised before it is rounded, so there is no online
// softmax: a warp keeps its 16 query rows' scores against every key of the
// group in registers (2 KT n-tiles of 8 keys: 128 fp32 a lane at 256 keys)
// and takes the row statistics from them. D is rowsum(dP * P) as the
// reference sums it, not FlashAttention's rowsum(dO * O), which would move a
// rounding point. The forward and the backward compute S with the same
// code (tc_scores), so the backward's P is the forward's, bit for bit.
//
// Design. A block takes ITEMS (group, head) items, 16 * KT padded rows each
// (KT key tiles of 16, a power of two from the group size: 1 for the
// mesh's 16 frames, 2 for the 17 joints, 16 for 243 frames), and copies
// their q, k, v (and dO) rows, which are strided in the token rows, into
// shared memory with 16-byte cp.async, rows past the group zero-filled. Its
// eight warps take 16-row tiles: ITEMS * KT = 8 tiles, or 16 for a 243-frame
// group (one item a block). A key past the group scores -inf (P = 0); a
// query row past it is never written. The backward runs two passes, each
// output written once by one warp, no atomics, so the bits repeat:
//   query-major  S and P in registers, the row max and the reciprocal of
//                the row sum; dP a 16-key chunk at a time, D = rowsum(dP *
//                P); then dP again, dS and dq += dS k; the row statistics to
//                shared memory
//   key-major    per 16-query chunk: S^T = k q^T, P^T from the statistics,
//                dv += bf16(P^T) dO, dP^T = v dO^T, dS^T, dk += dS^T q
// Shared rows are D + 8 bf16 long (144 bytes at D 64), so the eight row
// addresses of an ldmatrix land on distinct banks. A 243-frame group's four
// matrices at D 64 take 147 KB (one block an SM); KT <= 8 takes 74 KB.
//
// Bound. At (4, 243, 17, 512), 8 heads, the forward reads q, k, v (51 MB)
// and writes the output (17 MB), 0.020 ms at 3.35 TB/s, against 8.2 GFLOP
// (temporal; 0.6 spatial), 0.008 ms at 989 TFLOP/s: bytes bound it. The
// backward reads four (M, C) bf16 tensors and writes three in fp32 and in
// bf16 (220 MB, 0.066 ms), against twice the forward's operations. Neither
// is near: the time goes to the softmax's elementwise work (an exp per
// score, in both passes) and to mma.sync latency at eight warps an SM
// (PERF.md).
//
// Everything is in an anonymous namespace, like the other headers.

#pragma once

#include "pair_common.cuh"

namespace {

constexpr int TC_THREADS = 256;          // eight warps
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int TC_KEY_TILE = 16;          // an MMA's k-step, and a warp's rows
constexpr int TC_MAX_KEYS = 256;         // 16 key tiles: a 243-frame group
constexpr int TC_PAD = 8;                // bf16 padding of a shared row

// Rows, items and strides of a block's shared tiles at head dim D with KT
// key tiles.
template <int D, int KT>
struct TcShape {
    static constexpr int NP = KT * TC_KEY_TILE;
    static constexpr int ITEMS = KT >= TC_WARPS ? 1 : TC_WARPS / KT;
    static constexpr int LD = D + TC_PAD;
    static constexpr int ROW_BYTES = LD * 2;
    static constexpr int MAT_BYTES = NP * ROW_BYTES;
};

__device__ __forceinline__ uint32_t tc_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void tc_ldsm(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void tc_ldsm_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, fp32 accumulator
__device__ __forceinline__ void tc_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tc_pack(float lo, float hi) {
    const bf162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of a k16 step from two accumulator n-tiles (columns 0-7 and
// 8-15 of a 16 x 16 block), rounded to bf16.
__device__ __forceinline__ void tc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                        const float (&hi)[4]) {
    a[0] = tc_pack(lo[0], lo[1]);
    a[1] = tc_pack(lo[2], lo[3]);
    a[2] = tc_pack(hi[0], hi[1]);
    a[3] = tc_pack(hi[2], hi[3]);
}

// ldmatrix row addresses of this lane (ROW_BYTES apart) for:
// an A operand, 16 rows x 16 columns at (r0, c0) of a row-major tile
__device__ __forceinline__ uint32_t tc_a_addr(uint32_t tile, int row_bytes, int r0, int c0,
                                              int lane) {
    return tile + (r0 + (lane & 15)) * row_bytes + (c0 + (lane >> 4) * 8) * 2;
}
// B operands of two n-tiles (n0..n0+15) at k-step k0 from a tile stored
// [n][k] (non-transposed ldmatrix): regs 0-1 the first n-tile, 2-3 the second
__device__ __forceinline__ uint32_t tc_bnk_addr(uint32_t tile, int row_bytes, int n0, int k0,
                                                int lane) {
    return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * row_bytes
         + (k0 + ((lane >> 3) & 1) * 8) * 2;
}
// the same from a tile stored [k][n] (transposed ldmatrix)
__device__ __forceinline__ uint32_t tc_bkn_addr(uint32_t tile, int row_bytes, int k0, int n0,
                                                int lane) {
    return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_bytes
         + (n0 + (lane >> 4) * 8) * 2;
}

// Copy the block's items' rows of MATS row-strided bf16 matrices (q, k, v
// with row stride ld, then g with row stride ld_g; head h at column h * D)
// into shared memory as [item][matrix][row][LD], zero past the group's N
// rows and past the last item. Returns N.
template <int D, int KT, int MATS>
__device__ __forceinline__ int tc_load(bf16* sm, const bf16* q, const bf16* k, const bf16* v,
                                       const bf16* g, int ld, int ld_g, int F, int J, int H,
                                       int temporal, int n_items) {
    using S = TcShape<D, KT>;
    constexpr int CHUNKS = D / 8;     // 16-byte chunks of a row
    const int N = temporal ? F : J;
    const int total = S::ITEMS * MATS * S::NP * CHUNKS;
    for (int c = threadIdx.x; c < total; c += TC_THREADS) {
        const int chunk = c % CHUNKS;
        const int row = (c / CHUNKS) % S::NP;
        const int mat = (c / (CHUNKS * S::NP)) % MATS;
        const int it = c / (CHUNKS * S::NP * MATS);
        const int gi = blockIdx.x * S::ITEMS + it;
        const bool valid = gi < n_items && row < N;
        const bf16* p = mat == 0 ? q : mat == 1 ? k : mat == 2 ? v : g;
        if (valid) {
            int n, base, stride;
            attention_group(gi / H, F, J, temporal, &n, &base, &stride);
            p += (size_t)(base + row * stride) * (mat == 3 ? ld_g : ld) + (gi % H) * D
               + chunk * 8;
        }
        bf16* dst = sm + ((size_t)(it * MATS + mat) * S::NP + row) * S::LD + chunk * 8;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(tc_addr(dst)), "l"(p), "r"(valid ? 16 : 0) : "memory");
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    return N;
}

// S = (q . k) * scale of the warp's 16 query rows [r0, r0 + 16) against every
// key, -inf past N: s[nt][0..1] is row r0 + g, keys 8 nt + 2 t + (0, 1);
// s[nt][2..3] row r0 + g + 8 (g = lane / 4, t = lane % 4).
template <int D, int KT>
__device__ __forceinline__ void tc_scores(float (&s)[2 * KT][4], uint32_t qs, uint32_t ks,
                                          int r0, int N, float scale) {
    using S = TcShape<D, KT>;
    const int lane = threadIdx.x & 31;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        tc_ldsm(qa[kk], tc_a_addr(qs, S::ROW_BYTES, r0, kk * 16, lane));
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * kt][e] = s[2 * kt + 1][e] = 0.f;
        if (kt * TC_KEY_TILE < N) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t b[4];
                tc_ldsm(b, tc_bnk_addr(ks, S::ROW_BYTES, kt * 16, kk * 16, lane));
                tc_mma(s[2 * kt], qa[kk], b[0], b[1]);
                tc_mma(s[2 * kt + 1], qa[kk], b[2], b[3]);
            }
        }
    }
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            s[nt][e] = nt * 8 + t2 + (e & 1) < N ? s[nt][e] * scale
                                                 : __int_as_float(0xff800000);
}

// In place: P = exp(S - rowmax) * (1 / rowsum) in fp32; mx and inv (the
// reciprocal of the row sum) of rows g, g + 8.
template <int KT>
__device__ __forceinline__ void tc_softmax(float (&s)[2 * KT][4], float (&mx)[2],
                                           float (&inv)[2]) {
    float sum[2];
    mx[0] = mx[1] = __int_as_float(0xff800000);
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        sum[r] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
            sum[e >> 1] += s[nt][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        inv[r] = 1.f / sum[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= inv[e >> 1];
}

// dP of the warp's 16 query rows against keys [16 kt, 16 kt + 16):
// dO (A fragments ga) . v^T
template <int D, int KT>
__device__ __forceinline__ void tc_dp_chunk(float (&dp)[2][4], const uint32_t (&ga)[D / 16][4],
                                            uint32_t vs, int kt) {
    using S = TcShape<D, KT>;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[0][e] = dp[1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        tc_ldsm(b, tc_bnk_addr(vs, S::ROW_BYTES, kt * 16, kk * 16, lane));
        tc_mma(dp[0], ga[kk], b[0], b[1]);
        tc_mma(dp[1], ga[kk], b[2], b[3]);
    }
}

// acc[16 x D] += a[16 x 16] . tile rows [k0, k0 + 16) (stored [k][n], D wide)
template <int D, int KT>
__device__ __forceinline__ void tc_mma_rows(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                            uint32_t tile, int k0) {
    using S = TcShape<D, KT>;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        tc_ldsm_t(b, tc_bkn_addr(tile, S::ROW_BYTES, k0, dn * 16, lane));
        tc_mma(acc[2 * dn], a, b[0], b[1]);
        tc_mma(acc[2 * dn + 1], a, b[2], b[3]);
    }
}

// A warp's 16 x D accumulator to the token rows of its tile (rows < N only):
// bf16 to outb, and fp32 to outf when it is not null; row stride ld.
template <int D>
__device__ __forceinline__ void tc_store(const float (&acc)[D / 8][4], float* outf, bf16* outb,
                                         int ld, int col, int r0, int N, int base, int stride) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = r0 + (lane >> 2) + half * 8;
        if (row >= N) continue;
        const size_t o = (size_t)(base + row * stride) * ld + col + 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
            const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
            if (outf != nullptr)
                *reinterpret_cast<float2*>(outf + o + nt * 8) = make_float2(v0, v1);
            *reinterpret_cast<bf162*>(outb + o + nt * 8) = __floats2bfloat162_rn(v0, v1);
        }
    }
}

// The forward core: out = bf16(bf16(P) v) of (group, head) items
// [blockIdx.x * ITEMS, + ITEMS). q, k, v row stride ld, out row stride
// ld_out, head h at column h * D of each.
template <int D, int KT>
__global__ void __launch_bounds__(TC_THREADS, KT >= 8 ? 1 : 2)
attn_tc_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, int ld, bf16* __restrict__ out, int ld_out,
                   int F, int J, int H, float scale, int temporal, int n_items) {
    using S = TcShape<D, KT>;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    bf16* sm = reinterpret_cast<bf16*>(tc_smem);
    const int N = tc_load<D, KT, 3>(sm, q, k, v, nullptr, ld, 0, F, J, H, temporal, n_items);
    const int warp = threadIdx.x >> 5;
    const uint32_t base_addr = tc_addr(sm);
    for (int tile = warp; tile < S::ITEMS * KT; tile += TC_WARPS) {
        const int it = tile / KT, r0 = (tile % KT) * TC_KEY_TILE;
        const int gi = blockIdx.x * S::ITEMS + it;
        if (gi >= n_items || r0 >= N) continue;
        const uint32_t qs = base_addr + it * 3 * S::MAT_BYTES;
        const uint32_t ks = qs + S::MAT_BYTES, vs = ks + S::MAT_BYTES;
        float o[D / 8][4];
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
        float s[2 * KT][4];
        tc_scores<D, KT>(s, qs, ks, r0, N, scale);
        float mx[2], inv[2];
        tc_softmax<KT>(s, mx, inv);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
            if (kt * TC_KEY_TILE >= N) continue;
            uint32_t pa[4];
            tc_to_a(pa, s[2 * kt], s[2 * kt + 1]);
            tc_mma_rows<D, KT>(o, pa, vs, kt * 16);
        }
        int n, base, stride;
        attention_group(gi / H, F, J, temporal, &n, &base, &stride);
        tc_store<D>(o, nullptr, out, ld_out, (gi % H) * D, r0, N, base, stride);
    }
}

// The backward core of (group, head) items [blockIdx.x * ITEMS, + ITEMS):
// q, k, v row stride ld, dO row stride ld_g; dq, dk, dv in bf16 (dqb, dkb,
// dvb) and, where dqf, dkf, dvf are not null, fp32; row stride ld_out; head
// h at column h * D.
template <int D, int KT>
__global__ void __launch_bounds__(TC_THREADS, KT >= 8 ? 1 : 2)
attn_tc_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, int ld, const bf16* __restrict__ g, int ld_g,
                   float* __restrict__ dqf, float* __restrict__ dkf, float* __restrict__ dvf,
                   bf16* __restrict__ dqb, bf16* __restrict__ dkb, bf16* __restrict__ dvb,
                   int ld_out, int F, int J, int H, float scale, int temporal, int n_items) {
    using S = TcShape<D, KT>;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    bf16* sm = reinterpret_cast<bf16*>(tc_smem);
    float* stats = reinterpret_cast<float*>(tc_smem + (size_t)S::ITEMS * 4 * S::MAT_BYTES);
    const int N = tc_load<D, KT, 4>(sm, q, k, v, g, ld, ld_g, F, J, H, temporal, n_items);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t2 = 2 * (lane & 3);
    const uint32_t base_addr = tc_addr(sm);

    // pass 1, query-major: P, D and dq of the warp's 16 query rows
    for (int tile = warp; tile < S::ITEMS * KT; tile += TC_WARPS) {
        const int it = tile / KT, r0 = (tile % KT) * TC_KEY_TILE;
        const int gi = blockIdx.x * S::ITEMS + it;
        if (gi >= n_items || r0 >= N) continue;
        const uint32_t qs = base_addr + it * 4 * S::MAT_BYTES;
        const uint32_t ks = qs + S::MAT_BYTES, vs = ks + S::MAT_BYTES, gs = vs + S::MAT_BYTES;
        float* row_mx = stats + it * 3 * S::NP;
        float* row_inv = row_mx + S::NP;
        float* row_d = row_inv + S::NP;
        float p[2 * KT][4];
        tc_scores<D, KT>(p, qs, ks, r0, N, scale);
        float mx[2], inv[2];
        tc_softmax<KT>(p, mx, inv);
        uint32_t ga[D / 16][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            tc_ldsm(ga[kk], tc_a_addr(gs, S::ROW_BYTES, r0, kk * 16, lane));
        float dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
            if (kt * TC_KEY_TILE >= N) continue;
            float dp[2][4];
            tc_dp_chunk<D, KT>(dp, ga, vs, kt);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[h][e] * p[2 * kt + h][e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
            dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
        }
        if ((lane & 3) == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int row = r0 + (lane >> 2) + 8 * r;
                row_mx[row] = mx[r];
                row_inv[row] = inv[r];
                row_d[row] = dsum[r];
            }
        }
        float dq[D / 8][4];
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
            if (kt * TC_KEY_TILE >= N) continue;
            float dp[2][4];
            tc_dp_chunk<D, KT>(dp, ga, vs, kt);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dp[h][e] = (p[2 * kt + h][e] * (dp[h][e] - dsum[e >> 1])) * scale;
            uint32_t da[4];
            tc_to_a(da, dp[0], dp[1]);
            tc_mma_rows<D, KT>(dq, da, ks, kt * 16);
        }
        int n, base, stride;
        attention_group(gi / H, F, J, temporal, &n, &base, &stride);
        tc_store<D>(dq, dqf, dqb, ld_out, (gi % H) * D, r0, N, base, stride);
    }
    __syncthreads();

    // pass 2, key-major: dk and dv of the warp's 16 key rows
    for (int tile = warp; tile < S::ITEMS * KT; tile += TC_WARPS) {
        const int it = tile / KT, j0 = (tile % KT) * TC_KEY_TILE;
        const int gi = blockIdx.x * S::ITEMS + it;
        if (gi >= n_items || j0 >= N) continue;
        const uint32_t qs = base_addr + it * 4 * S::MAT_BYTES;
        const uint32_t ks = qs + S::MAT_BYTES, vs = ks + S::MAT_BYTES, gs = vs + S::MAT_BYTES;
        const float* row_mx = stats + it * 3 * S::NP;
        const float* row_inv = row_mx + S::NP;
        const float* row_d = row_inv + S::NP;
        uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            tc_ldsm(ka[kk], tc_a_addr(ks, S::ROW_BYTES, j0, kk * 16, lane));
            tc_ldsm(va[kk], tc_a_addr(vs, S::ROW_BYTES, j0, kk * 16, lane));
        }
        float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
        for (int qt = 0; qt * TC_KEY_TILE < N; ++qt) {
            // S^T and dP^T of the 16 keys against queries [16 qt, 16 qt + 16)
            float st[2][4], dpt[2][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) st[0][e] = st[1][e] = dpt[0][e] = dpt[1][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                uint32_t b[4];
                tc_ldsm(b, tc_bnk_addr(qs, S::ROW_BYTES, qt * 16, kk * 16, lane));
                tc_mma(st[0], ka[kk], b[0], b[1]);
                tc_mma(st[1], ka[kk], b[2], b[3]);
                tc_ldsm(b, tc_bnk_addr(gs, S::ROW_BYTES, qt * 16, kk * 16, lane));
                tc_mma(dpt[0], va[kk], b[0], b[1]);
                tc_mma(dpt[1], va[kk], b[2], b[3]);
            }
            // element e of n-tile h: key j0 + g (+ 8 for e >= 2), query
            // i = 16 qt + 8 h + 2 t + (e & 1)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = qt * 16 + 8 * h + t2;
                const float2 m2 = *reinterpret_cast<const float2*>(row_mx + i);
                const float2 s2 = *reinterpret_cast<const float2*>(row_inv + i);
                const float2 d2 = *reinterpret_cast<const float2*>(row_d + i);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool odd = e & 1;
                    const bool live = i + odd < N;
                    const float pv = live ? expf(st[h][e] * scale - (odd ? m2.y : m2.x))
                                                * (odd ? s2.y : s2.x)
                                          : 0.f;
                    st[h][e] = pv;
                    dpt[h][e] = live ? (pv * (dpt[h][e] - (odd ? d2.y : d2.x))) * scale : 0.f;
                }
            }
            uint32_t pa[4], da[4];
            tc_to_a(pa, st[0], st[1]);
            tc_to_a(da, dpt[0], dpt[1]);
            tc_mma_rows<D, KT>(dv, pa, gs, qt * 16);
            tc_mma_rows<D, KT>(dk, da, qs, qt * 16);
        }
        int n, base, stride;
        attention_group(gi / H, F, J, temporal, &n, &base, &stride);
        const int col = (gi % H) * D;
        tc_store<D>(dk, dkf, dkb, ld_out, col, j0, N, base, stride);
        tc_store<D>(dv, dvf, dvb, ld_out, col, j0, N, base, stride);
    }
}

// Key tiles of a group of N rows, a power of two; 0 when N is outside
// [1, TC_MAX_KEYS].
inline int tc_key_tiles(int N) {
    if (N < 1 || N > TC_MAX_KEYS) return 0;
    int kt = 1;
    while (kt * TC_KEY_TILE < N) kt *= 2;
    return kt;
}

// Shared bytes of a block: MATS matrices of its items, and the backward's
// row statistics.
template <int D, int KT>
size_t tc_smem_bytes(bool backward) {
    using S = TcShape<D, KT>;
    return (size_t)S::ITEMS * ((backward ? 4 : 3) * S::MAT_BYTES
                               + (backward ? 3 * S::NP * sizeof(float) : 0));
}

// Pointers and shapes of one core launch: q, k, v with row stride ld; the
// forward's out, or the backward's dO (g, row stride ld_g) and its outputs
// (the fp32 ones may be null), with row stride ld_out.
struct TcArgs {
    const void *q, *k, *v, *g;
    void *out, *dqf, *dkf, *dvf, *dqb, *dkb, *dvb;
    int ld, ld_g, ld_out, B, F, J, C, H;
    float scale;
    int temporal;
};

// The arguments of a core launch on one packed (M, 3C) qkv ([q | k | v] per
// token row): q, k and v with row stride 3C and the shapes. The caller sets
// the outputs.
TcArgs tc_packed_args(const void* qkv, int B, int F, int J, int C, int H, float scale,
                      int temporal) {
    const bf16* q = static_cast<const bf16*>(qkv);
    TcArgs a{};
    a.q = q;
    a.k = q + C;
    a.v = q + 2 * C;
    a.ld = 3 * C;
    a.B = B, a.F = F, a.J = J, a.C = C, a.H = H;
    a.scale = scale;
    a.temporal = temporal;
    return a;
}

template <int D, int KT>
cudaError_t tc_launch(const TcArgs& a, bool backward, cudaStream_t stream) {
    using S = TcShape<D, KT>;
    const size_t smem = tc_smem_bytes<D, KT>(backward);
    const int n_items = (a.temporal ? a.B * a.J : a.B * a.F) * a.H;
    const int blocks = (n_items + S::ITEMS - 1) / S::ITEMS;
    const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
               *v = static_cast<const bf16*>(a.v);
    cudaError_t err;
    if (backward) {
        err = cudaFuncSetAttribute(attn_tc_bwd_kernel<D, KT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        attn_tc_bwd_kernel<D, KT><<<blocks, TC_THREADS, smem, stream>>>(
            q, k, v, a.ld, static_cast<const bf16*>(a.g), a.ld_g, static_cast<float*>(a.dqf),
            static_cast<float*>(a.dkf), static_cast<float*>(a.dvf), static_cast<bf16*>(a.dqb),
            static_cast<bf16*>(a.dkb), static_cast<bf16*>(a.dvb), a.ld_out, a.F, a.J, a.H,
            a.scale, a.temporal, n_items);
    } else {
        err = cudaFuncSetAttribute(attn_tc_fwd_kernel<D, KT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        attn_tc_fwd_kernel<D, KT><<<blocks, TC_THREADS, smem, stream>>>(
            q, k, v, a.ld, static_cast<bf16*>(a.out), a.ld_out, a.F, a.J, a.H, a.scale,
            a.temporal, n_items);
    }
    return cudaGetLastError();
}

template <int D>
cudaError_t tc_launch_d(const TcArgs& a, bool backward, cudaStream_t stream) {
    switch (tc_key_tiles(a.temporal ? a.F : a.J)) {
        case 1: return tc_launch<D, 1>(a, backward, stream);
        case 2: return tc_launch<D, 2>(a, backward, stream);
        case 4: return tc_launch<D, 4>(a, backward, stream);
        case 8: return tc_launch<D, 8>(a, backward, stream);
        case 16: return tc_launch<D, 16>(a, backward, stream);
        default: return cudaErrorInvalidValue;
    }
}

// One launch of the forward (backward == false) or backward core; head dim
// C / H of 32 or 64, groups of 1..TC_MAX_KEYS rows. Returns
// cudaErrorInvalidValue on any other shape.
cudaError_t launch_attention_tc(const TcArgs& a, bool backward, cudaStream_t stream) {
    if (a.H < 1 || a.C % a.H) return cudaErrorInvalidValue;
    const int D = a.C / a.H;
    if (D == 64) return tc_launch_d<64>(a, backward, stream);
    if (D == 32) return tc_launch_d<32>(a, backward, stream);
    return cudaErrorInvalidValue;
}

}  // namespace
