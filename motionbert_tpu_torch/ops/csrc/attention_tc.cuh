// The attention core on tensor cores, forward and backward, for NVIDIA
// Hopper (sm_90a): bf16 operands and fp32 accumulation through
// mma.sync.m16n8k16 fed by ldmatrix. The forward pairs (pair_chain.cuh), the
// W8A8 pair (pair_q8_common.cuh), the attention block's forward
// (block_kernels.cu) and the standalone core (st_attention_kernels.cu) run
// the forward; the pair backward (pair_bwd_kernels.cu) and the attention
// block's backward (block_kernels.cu) run both, the forward in their
// recompute and the backward for dq, dk and dv (the block's backward on
// shards, B5_tp, takes attn from its backward instead). They replace the
// attention part of the TPU kernels motionbert_tpu/ops/fused_pair.py:_pair_pallas,
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
// attn from the backward (the attention block on shards, B5_tp: ATTN, and
// the split halves below). The backward's pass 1 already holds P in
// registers and v in shared memory, so it writes attn = bf16(bf16(P) v)
// with the forward's loop over 16-key chunks, order and rounding (tc_pv),
// before dq reuses the accumulator's registers: the forward core's bits,
// and no forward launch to make them. ptxas (sm_90a, CUDA 12.8): the flag
// adds no register and no spill where the flag-off kernel spills (the
// spatial <64, 2>: 128 registers, 20 bytes of spill stores either way;
// <64, 4>: 36 bytes with it, 44 without).
//
// The split backward (KT 8 and 16, where the one-launch kernel is one item
// a block: a 243-frame item's block holds 8 warps at 255 registers and 147
// KB, one an SM, so at 4 local heads and batch 4 its 272 blocks run 3 waves
// on 132 SMs for 2.06 waves of work). Its two passes become two launches
// over (item, slice) blocks of TC_SLICE_WARPS warps, each warp one 16-row
// tile as in the one-launch kernel and with its loops (the same helpers,
// tc_bwd_p, tc_bwd_dq and tc_bwd_kv), so every value is that kernel's:
//   query-major  (attn_tc_bwd_query_kernel) the item's k and v whole and a
//                slice of TC_SLICE_ROWS q and dO rows: dq, attn and each
//                row's max, reciprocal sum and D to a global buffer of
//                3 N floats an item
//   key-major    (attn_tc_bwd_key_kernel) q and dO whole, a slice of k and
//                v rows and the item's row statistics: dk and dv
// At D 64 and KT 16 a block is 4 warps with 92 KB (query-major, 255
// registers a thread) or 95 KB (key-major, 161 registers) of shared memory:
// two blocks an SM (the runtime's occupancy, chip_smoke's core_grid), the
// same 8 warps an SM as the one-launch kernel, now with one block's copies
// beside the other's products. At batch 4 the grid is 272 items x 4 slices
// = 1088 blocks at 4 local heads (4.12 waves of 264) and 2176 at 8 (8.24
// waves): a warp takes 5 tiles where the one-launch kernel gave it 6 (3
// waves of 2). 243 frames make 16 tiles an item and 17 joints make the
// item count a multiple of 17, so no slice width gives whole waves at batch
// 4: 64-row slices give the least tail at the occupancy the query-major
// half's registers allow (8 warps an SM; a 96-row key-major slice would
// run 816 blocks in 3.09 waves).
//
// The split forward (attn_tc_fwd_query_kernel, B4_tp's core on the same
// groups) is the query-major half without dO and dq: the item's k and v
// whole, a 64-row q slice, a warp a 16-row tile with the one-launch
// forward's helpers and store, so out keeps its bits; q and k land in a
// first cp.async group and v in a second, under the scores and the softmax.
// 83 KB at D 64 and KT 16: two blocks an SM, 1088 blocks at 4 local heads
// and batch 4.
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
constexpr int TC_SLICE_WARPS = 4;        // a split-backward block's warps
constexpr int TC_SLICE_THREADS = TC_SLICE_WARPS * 32;
constexpr int TC_SLICE_ROWS = TC_SLICE_WARPS * TC_KEY_TILE;  // its rows of one side

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

// The split backward's slices of an item and the shared bytes of its two
// halves: one side's matrices whole, the other's slice, and for the
// key-major half the item's row statistics.
template <int D, int KT>
struct TcSplit {
    using S = TcShape<D, KT>;
    static constexpr int SLICES = S::NP / TC_SLICE_ROWS;
    static constexpr int SLICE_BYTES = TC_SLICE_ROWS * S::ROW_BYTES;
    static constexpr size_t QUERY_SMEM = 2 * (size_t)S::MAT_BYTES + 2 * SLICE_BYTES;
    static constexpr size_t KEY_SMEM = QUERY_SMEM + 3 * S::NP * sizeof(float);
    static constexpr size_t FWD_SMEM = 2 * (size_t)S::MAT_BYTES + SLICE_BYTES;
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

// Copy rows [row0, row0 + ROWS) of one item's row-strided bf16 matrix (token
// rows base + r * stride, row stride ld, the head's D columns from col) into
// shared memory at dst as [row][LD], zero from the group's N-th row on; the
// caller waits for the copies.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void tc_load_rows(bf16* dst, const bf16* src, int ld, int row0,
                                             int N, int base, int stride, int col) {
    constexpr int CHUNKS = D / 8, LD = D + TC_PAD;
    for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
        const int chunk = c % CHUNKS, row = c / CHUNKS;
        const int r = row0 + row;
        const bool valid = r < N;
        const bf16* p = valid ? src + (size_t)(base + r * stride) * ld + col + chunk * 8 : src;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(tc_addr(dst + row * LD + chunk * 8)), "l"(p),
                        "r"(valid ? 16 : 0) : "memory");
    }
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
// bf16 to outb, and fp32 to outf when it is not null; row stride ld. Where
// amax is not null (the W8A8 pair on shards), each row's max |bf16 value|
// over these D columns is folded into amax[token row] with an atomicMax on
// the float's bits (non-negative floats order as their bit patterns); max is
// exact in any order, so the bits repeat.
template <int D>
__device__ __forceinline__ void tc_store(const float (&acc)[D / 8][4], float* outf, bf16* outb,
                                         int ld, int col, int r0, int N, int base, int stride,
                                         float* amax = nullptr) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = r0 + (lane >> 2) + half * 8;
        const size_t token = (size_t)base + (size_t)row * stride;
        float m = 0.f;
        if (row < N) {
            const size_t o = token * ld + col + 2 * (lane & 3);
#pragma unroll
            for (int nt = 0; nt < D / 8; ++nt) {
                const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
                if (outf != nullptr)
                    *reinterpret_cast<float2*>(outf + o + nt * 8) = make_float2(v0, v1);
                const bf162 b = __floats2bfloat162_rn(v0, v1);
                *reinterpret_cast<bf162*>(outb + o + nt * 8) = b;
                if (amax != nullptr)
                    m = fmaxf(m, fmaxf(fabsf(__low2float(b)), fabsf(__high2float(b))));
            }
        }
        if (amax != nullptr) {
            // the four lanes of a row hold its D columns between them
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            if ((lane & 3) == 0 && row < N)
                atomicMax(reinterpret_cast<int*>(amax) + token, __float_as_int(m));
        }
    }
}

// The forward core: out = bf16(bf16(P) v) of (group, head) items
// [blockIdx.x * ITEMS, + ITEMS). q, k, v row stride ld, out row stride
// ld_out, head h at column h * D of each. amax, when not null, takes each
// token row's max |out| over every head (tc_store); the caller zeroes it.
template <int D, int KT>
__global__ void __launch_bounds__(TC_THREADS, KT >= 8 ? 1 : 2)
attn_tc_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, int ld, bf16* __restrict__ out, int ld_out,
                   float* __restrict__ amax, int F, int J, int H, float scale, int temporal,
                   int n_items) {
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
        tc_store<D>(o, nullptr, out, ld_out, (gi % H) * D, r0, N, base, stride, amax);
    }
}

// o = bf16(P) v of a warp's 16 query rows over every key: attn_tc_fwd_kernel's
// loop over 16-key chunks, in its order and with its rounding.
template <int D, int KT>
__device__ __forceinline__ void tc_pv(float (&o)[D / 8][4], const float (&p)[2 * KT][4],
                                      uint32_t vs, int N) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
        if (kt * TC_KEY_TILE >= N) continue;
        uint32_t pa[4];
        tc_to_a(pa, p[2 * kt], p[2 * kt + 1]);
        tc_mma_rows<D, KT>(o, pa, vs, kt * 16);
    }
}

// The split kernels' passes: attn_tc_bwd_kernel's, statement for statement.
//
// The backward's pass 1 up to dq, for a warp's 16 query rows (rows rq of the
// q and dO tiles qs, gs) against the item's N keys (k and v tiles ks, vs):
// P in p, and of rows g and g + 8 (g = lane / 4) the row max, the reciprocal
// of the row sum and D = rowsum(dP * P), each reduced over the row's four
// lanes; dO's A fragments in ga.
template <int D, int KT>
__device__ __forceinline__ void tc_bwd_p(float (&p)[2 * KT][4], uint32_t (&ga)[D / 16][4],
                                         float (&mx)[2], float (&inv)[2], float (&dsum)[2],
                                         uint32_t qs, uint32_t ks, uint32_t vs, uint32_t gs,
                                         int rq, int N, float scale) {
    using S = TcShape<D, KT>;
    const int lane = threadIdx.x & 31;
    tc_scores<D, KT>(p, qs, ks, rq, N, scale);
    tc_softmax<KT>(p, mx, inv);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        tc_ldsm(ga[kk], tc_a_addr(gs, S::ROW_BYTES, rq, kk * 16, lane));
    dsum[0] = dsum[1] = 0.f;
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
}

// The rest of pass 1: dq = sum over 16-key chunks of bf16(dS) k, dP again
// from dO and v.
template <int D, int KT>
__device__ __forceinline__ void tc_bwd_dq(float (&dq)[D / 8][4], const float (&p)[2 * KT][4],
                                          const uint32_t (&ga)[D / 16][4],
                                          const float (&dsum)[2], uint32_t ks, uint32_t vs,
                                          int N, float scale) {
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
}

// Pass 2 for a warp's 16 key rows (rows rk of the k and v tiles ks, vs)
// against the item's N queries (q and dO tiles qs, gs), from the query rows'
// statistics row_mx, row_inv and row_d (shared memory, by query row): dk and
// dv.
template <int D, int KT>
__device__ __forceinline__ void tc_bwd_kv(float (&dk)[D / 8][4], float (&dv)[D / 8][4],
                                          uint32_t qs, uint32_t ks, uint32_t vs, uint32_t gs,
                                          int rk, const float* row_mx, const float* row_inv,
                                          const float* row_d, int N, float scale) {
    using S = TcShape<D, KT>;
    const int lane = threadIdx.x & 31;
    const int t2 = 2 * (lane & 3);
    uint32_t ka[D / 16][4], va[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        tc_ldsm(ka[kk], tc_a_addr(ks, S::ROW_BYTES, rk, kk * 16, lane));
        tc_ldsm(va[kk], tc_a_addr(vs, S::ROW_BYTES, rk, kk * 16, lane));
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
    // two chunks in flight: the registers the split's occupancy leaves (160
    // of 255 at D 64) hold the second's scores while the first's products run
#pragma unroll 2
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
        // element e of n-tile h: key rk + g (+ 8 for e >= 2), query
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
}

// The backward core of (group, head) items [blockIdx.x * ITEMS, + ITEMS):
// q, k, v row stride ld, dO row stride ld_g; dq, dk, dv in bf16 (dqb, dkb,
// dvb) and, where dqf, dkf, dvf are not null, fp32; row stride ld_out; head
// h at column h * D. With ATTN, pass 1 also writes attn = bf16(bf16(P) v)
// (row stride ld_attn), the forward core's bits. The passes are
// tc_bwd_p / tc_bwd_dq and tc_bwd_kv statement for statement, written out
// here so that the flag-off instances (B3's, B5's, B8's) compile as they
// did before the split kernels shared them.
template <int D, int KT, bool ATTN = false>
__global__ void __launch_bounds__(TC_THREADS, KT >= 8 ? 1 : 2)
attn_tc_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, int ld, const bf16* __restrict__ g, int ld_g,
                   float* __restrict__ dqf, float* __restrict__ dkf, float* __restrict__ dvf,
                   bf16* __restrict__ dqb, bf16* __restrict__ dkb, bf16* __restrict__ dvb,
                   int ld_out, int F, int J, int H, float scale, int temporal, int n_items,
                   bf16* __restrict__ attn, int ld_attn) {
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
        if constexpr (ATTN) {
            int n, base, stride;
            attention_group(gi / H, F, J, temporal, &n, &base, &stride);
            float o[D / 8][4];
            tc_pv<D, KT>(o, p, vs, N);
            tc_store<D>(o, nullptr, attn, ld_attn, (gi % H) * D, r0, N, base, stride);
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

// The split backward's query-major half: block b takes item b / SLICES and
// its query rows from row0 = (b % SLICES) * TC_SLICE_ROWS, with the item's k
// and v whole; each warp 16 of the rows, as pass 1 takes them. Writes dq
// (bf16 to dqb; fp32 to dqf, row stride ld_out), attn = bf16(bf16(P) v)
// (row stride ld_attn) and the rows' max, reciprocal sum and D to stats
// ([item][3][N] fp32).
template <int D, int KT>
__global__ void __launch_bounds__(TC_SLICE_THREADS, 2)
attn_tc_bwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld, const bf16* __restrict__ g,
                         int ld_g, float* __restrict__ dqf, bf16* __restrict__ dqb, int ld_out,
                         bf16* __restrict__ attn, int ld_attn, float* __restrict__ stats, int F,
                         int J, int H, float scale, int temporal) {
    using S = TcShape<D, KT>;
    using P = TcSplit<D, KT>;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    bf16* sm = reinterpret_cast<bf16*>(tc_smem);
    const int gi = blockIdx.x / P::SLICES, row0 = (blockIdx.x % P::SLICES) * TC_SLICE_ROWS;
    int N, base, stride;
    attention_group(gi / H, F, J, temporal, &N, &base, &stride);
    const int col = (gi % H) * D;
    // k and v whole, then the slice's q and dO rows
    tc_load_rows<D, S::NP, TC_SLICE_THREADS>(sm, k, ld, 0, N, base, stride, col);
    tc_load_rows<D, S::NP, TC_SLICE_THREADS>(sm + S::NP * S::LD, v, ld, 0, N, base, stride, col);
    tc_load_rows<D, TC_SLICE_ROWS, TC_SLICE_THREADS>(sm + 2 * S::NP * S::LD, q, ld, row0, N,
                                                     base, stride, col);
    tc_load_rows<D, TC_SLICE_ROWS, TC_SLICE_THREADS>(
        sm + (2 * S::NP + TC_SLICE_ROWS) * S::LD, g, ld_g, row0, N, base, stride, col);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rq = warp * TC_KEY_TILE, r0 = row0 + rq;
    if (r0 >= N) return;
    const uint32_t ks = tc_addr(sm), vs = ks + S::MAT_BYTES, qs = vs + S::MAT_BYTES,
                   gs = qs + P::SLICE_BYTES;
    float p[2 * KT][4], mx[2], inv[2], dsum[2];
    uint32_t ga[D / 16][4];
    tc_bwd_p<D, KT>(p, ga, mx, inv, dsum, qs, ks, vs, gs, rq, N, scale);
    if ((lane & 3) == 0) {
        float* st = stats + (size_t)gi * 3 * N;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = r0 + (lane >> 2) + 8 * r;
            if (row < N) {
                st[row] = mx[r];
                st[N + row] = inv[r];
                st[2 * N + row] = dsum[r];
            }
        }
    }
    float o[D / 8][4];
    tc_pv<D, KT>(o, p, vs, N);
    tc_store<D>(o, nullptr, attn, ld_attn, col, r0, N, base, stride);
    float dq[D / 8][4];
    tc_bwd_dq<D, KT>(dq, p, ga, dsum, ks, vs, N, scale);
    tc_store<D>(dq, dqf, dqb, ld_out, col, r0, N, base, stride);
}

// The split backward's key-major half: block b takes item b / SLICES and its
// key rows from row0, with the item's q and dO whole and its rows'
// statistics from the query-major half; each warp 16 of the rows, as pass 2
// takes them. Writes dk and dv (bf16, and fp32 where dkf, dvf are not null;
// row stride ld_out).
template <int D, int KT>
__global__ void __launch_bounds__(TC_SLICE_THREADS, 2)
attn_tc_bwd_key_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, int ld, const bf16* __restrict__ g, int ld_g,
                       float* __restrict__ dkf, float* __restrict__ dvf,
                       bf16* __restrict__ dkb, bf16* __restrict__ dvb, int ld_out,
                       const float* __restrict__ stats, int F, int J, int H, float scale,
                       int temporal) {
    using S = TcShape<D, KT>;
    using P = TcSplit<D, KT>;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    bf16* sm = reinterpret_cast<bf16*>(tc_smem);
    float* row_mx = reinterpret_cast<float*>(tc_smem + P::QUERY_SMEM);
    const int gi = blockIdx.x / P::SLICES, row0 = (blockIdx.x % P::SLICES) * TC_SLICE_ROWS;
    int N, base, stride;
    attention_group(gi / H, F, J, temporal, &N, &base, &stride);
    const int col = (gi % H) * D;
    // q and dO whole, then the slice's k and v rows, then the statistics
    tc_load_rows<D, S::NP, TC_SLICE_THREADS>(sm, q, ld, 0, N, base, stride, col);
    tc_load_rows<D, S::NP, TC_SLICE_THREADS>(sm + S::NP * S::LD, g, ld_g, 0, N, base, stride,
                                             col);
    tc_load_rows<D, TC_SLICE_ROWS, TC_SLICE_THREADS>(sm + 2 * S::NP * S::LD, k, ld, row0, N,
                                                     base, stride, col);
    tc_load_rows<D, TC_SLICE_ROWS, TC_SLICE_THREADS>(
        sm + (2 * S::NP + TC_SLICE_ROWS) * S::LD, v, ld, row0, N, base, stride, col);
    const float* st = stats + (size_t)gi * 3 * N;
    for (int i = threadIdx.x; i < 3 * N; i += TC_SLICE_THREADS)
        row_mx[(i / N) * S::NP + i % N] = st[i];
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    const int rk = warp * TC_KEY_TILE, j0 = row0 + rk;
    if (j0 >= N) return;
    const uint32_t qs = tc_addr(sm), gs = qs + S::MAT_BYTES, ks = gs + S::MAT_BYTES,
                   vs = ks + P::SLICE_BYTES;
    float dk[D / 8][4], dv[D / 8][4];
    tc_bwd_kv<D, KT>(dk, dv, qs, ks, vs, gs, rk, row_mx, row_mx + S::NP, row_mx + 2 * S::NP, N,
                     scale);
    tc_store<D>(dk, dkf, dkb, ld_out, col, j0, N, base, stride);
    tc_store<D>(dv, dvf, dvb, ld_out, col, j0, N, base, stride);
}

// The split forward (see the note at the top; KT 8 or 16): block b takes
// item b / SLICES and its query rows from row0 = (b % SLICES) *
// TC_SLICE_ROWS, with the item's k and v whole; each warp 16 of the rows
// with the one-launch kernel's helpers (tc_scores, tc_softmax, tc_pv) and its
// store. At 4 local heads and batch 4 the one-launch kernel's 272 blocks, one
// an SM, take 6 tile-times a warp; these 1088 blocks, two an SM, take 5.
template <int D, int KT>
__global__ void __launch_bounds__(TC_SLICE_THREADS, 2)
attn_tc_fwd_query_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, int ld, bf16* __restrict__ out, int ld_out,
                         int F, int J, int H, float scale, int temporal) {
    using S = TcShape<D, KT>;
    using P = TcSplit<D, KT>;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    bf16* sm = reinterpret_cast<bf16*>(tc_smem);
    const int gi = blockIdx.x / P::SLICES, row0 = (blockIdx.x % P::SLICES) * TC_SLICE_ROWS;
    int N, base, stride;
    attention_group(gi / H, F, J, temporal, &N, &base, &stride);
    const int col = (gi % H) * D;
    // [k | v | q slice]: k and the slice's q rows first, then v
    tc_load_rows<D, S::NP, TC_SLICE_THREADS>(sm, k, ld, 0, N, base, stride, col);
    tc_load_rows<D, TC_SLICE_ROWS, TC_SLICE_THREADS>(sm + 2 * S::NP * S::LD, q, ld, row0, N,
                                                     base, stride, col);
    asm volatile("cp.async.commit_group;" ::: "memory");
    tc_load_rows<D, S::NP, TC_SLICE_THREADS>(sm + S::NP * S::LD, v, ld, 0, N, base, stride, col);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    const int rq = warp * TC_KEY_TILE, r0 = row0 + rq;
    const uint32_t ks = tc_addr(sm), vs = ks + S::MAT_BYTES, qs = vs + S::MAT_BYTES;
    float s[2 * KT][4], mx[2], inv[2];
    if (r0 < N) {
        tc_scores<D, KT>(s, qs, ks, rq, N, scale);
        tc_softmax<KT>(s, mx, inv);
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (r0 >= N) return;
    float o[D / 8][4];
    tc_pv<D, KT>(o, s, vs, N);
    tc_store<D>(o, nullptr, out, ld_out, col, r0, N, base, stride);
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
// forward's out (and, where not null, the token rows' max |out|, amax (M,)
// fp32, zeroed by the caller), or the backward's dO (g, row stride ld_g) and
// its outputs (the fp32 ones may be null), with row stride ld_out; the
// backward with attn (launch_attention_tc_bwd_attn) writes attn to out with
// row stride ld_out_attn, and the split one passes the row statistics
// through stats (3 N floats an item).
struct TcArgs {
    const void *q, *k, *v, *g;
    void *out, *dqf, *dkf, *dvf, *dqb, *dkb, *dvb;
    float *amax, *stats;
    int ld, ld_g, ld_out, ld_out_attn, B, F, J, C, H;
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
            a.scale, a.temporal, n_items, nullptr, 0);
    } else {
        err = cudaFuncSetAttribute(attn_tc_fwd_kernel<D, KT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        attn_tc_fwd_kernel<D, KT><<<blocks, TC_THREADS, smem, stream>>>(
            q, k, v, a.ld, static_cast<bf16*>(a.out), a.ld_out, a.amax, a.F, a.J, a.H,
            a.scale, a.temporal, n_items);
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

// Key tiles the split backward takes (one item a block in the one-launch
// kernel).
inline bool tc_splits(int kt) { return kt == 8 || kt == 16; }

// The backward with attn's launches on args a: with split, the query-major
// then the key-major half (KT 8 or 16); else the one-launch kernel with
// ATTN. With grid not null, nothing is launched: grid gets the launch count,
// then each launch's blocks and the blocks an SM holds of it (the occupancy
// the runtime reports for its threads and shared memory).
template <int D, int KT>
cudaError_t tc_launch_bwd_attn(const TcArgs& a, bool split, cudaStream_t stream, int* grid) {
    using S = TcShape<D, KT>;
    const int n_items = (a.temporal ? a.B * a.J : a.B * a.F) * a.H;
    const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
               *v = static_cast<const bf16*>(a.v), *g = static_cast<const bf16*>(a.g);
    cudaError_t err;
    if (!split) {
        const size_t smem = tc_smem_bytes<D, KT>(true);
        const int blocks = (n_items + S::ITEMS - 1) / S::ITEMS;
        auto kernel = attn_tc_bwd_kernel<D, KT, true>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        if (grid != nullptr) {
            grid[0] = 1;
            grid[1] = blocks;
            return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&grid[2], kernel, TC_THREADS,
                                                                 smem);
        }
        kernel<<<blocks, TC_THREADS, smem, stream>>>(
            q, k, v, a.ld, g, a.ld_g, static_cast<float*>(a.dqf), static_cast<float*>(a.dkf),
            static_cast<float*>(a.dvf), static_cast<bf16*>(a.dqb), static_cast<bf16*>(a.dkb),
            static_cast<bf16*>(a.dvb), a.ld_out, a.F, a.J, a.H, a.scale, a.temporal, n_items,
            static_cast<bf16*>(a.out), a.ld_out_attn);
        return cudaGetLastError();
    }
    if constexpr (KT == 8 || KT == 16) {
        using P = TcSplit<D, KT>;
        if ((long long)n_items * P::SLICES > 0x7fffffffLL) return cudaErrorInvalidValue;
        const int blocks = n_items * P::SLICES;
        auto query = attn_tc_bwd_query_kernel<D, KT>;
        auto key = attn_tc_bwd_key_kernel<D, KT>;
        err = cudaFuncSetAttribute(query, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)P::QUERY_SMEM);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(key, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)P::KEY_SMEM);
        if (err != cudaSuccess) return err;
        if (grid != nullptr) {
            grid[0] = 2;
            grid[1] = grid[3] = blocks;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&grid[2], query,
                                                                TC_SLICE_THREADS, P::QUERY_SMEM);
            if (err != cudaSuccess) return err;
            return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&grid[4], key, TC_SLICE_THREADS,
                                                                 P::KEY_SMEM);
        }
        query<<<blocks, TC_SLICE_THREADS, P::QUERY_SMEM, stream>>>(
            q, k, v, a.ld, g, a.ld_g, static_cast<float*>(a.dqf), static_cast<bf16*>(a.dqb),
            a.ld_out, static_cast<bf16*>(a.out), a.ld_out_attn, a.stats, a.F, a.J, a.H, a.scale,
            a.temporal);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        key<<<blocks, TC_SLICE_THREADS, P::KEY_SMEM, stream>>>(
            q, k, v, a.ld, g, a.ld_g, static_cast<float*>(a.dkf), static_cast<float*>(a.dvf),
            static_cast<bf16*>(a.dkb), static_cast<bf16*>(a.dvb), a.ld_out, a.stats, a.F, a.J,
            a.H, a.scale, a.temporal);
        return cudaGetLastError();
    }
    return cudaErrorInvalidValue;
}

// The forward on args a: with split, the split forward (KT 8 or 16); else
// the one-launch kernel (tc_launch's). With grid not null, nothing is
// launched: grid gets 1, the launch's blocks and the blocks an SM holds of it
// (the runtime's occupancy for its threads and shared memory).
template <int D, int KT>
cudaError_t tc_launch_fwd(const TcArgs& a, bool split, cudaStream_t stream, int* grid) {
    using S = TcShape<D, KT>;
    const int n_items = (a.temporal ? a.B * a.J : a.B * a.F) * a.H;
    cudaError_t err;
    if (!split) {
        if (grid == nullptr) return tc_launch<D, KT>(a, false, stream);
        const size_t smem = tc_smem_bytes<D, KT>(false);
        auto kernel = attn_tc_fwd_kernel<D, KT>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        grid[0] = 1;
        grid[1] = (n_items + S::ITEMS - 1) / S::ITEMS;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&grid[2], kernel, TC_THREADS, smem);
    }
    if constexpr (KT == 8 || KT == 16) {
        using P = TcSplit<D, KT>;
        if ((long long)n_items * P::SLICES > 0x7fffffffLL) return cudaErrorInvalidValue;
        const int blocks = n_items * P::SLICES;
        auto kernel = attn_tc_fwd_query_kernel<D, KT>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)P::FWD_SMEM);
        if (err != cudaSuccess) return err;
        if (grid != nullptr) {
            grid[0] = 1;
            grid[1] = blocks;
            return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&grid[2], kernel,
                                                                 TC_SLICE_THREADS, P::FWD_SMEM);
        }
        kernel<<<blocks, TC_SLICE_THREADS, P::FWD_SMEM, stream>>>(
            static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
            static_cast<const bf16*>(a.v), a.ld, static_cast<bf16*>(a.out), a.ld_out, a.F, a.J,
            a.H, a.scale, a.temporal);
        return cudaGetLastError();
    }
    return cudaErrorInvalidValue;
}

template <int D>
cudaError_t tc_launch_fwd_d(const TcArgs& a, bool split, cudaStream_t stream, int* grid) {
    const int kt = tc_key_tiles(a.temporal ? a.F : a.J);
    if (split && !tc_splits(kt)) return cudaErrorInvalidValue;
    switch (kt) {
        case 1: return tc_launch_fwd<D, 1>(a, split, stream, grid);
        case 2: return tc_launch_fwd<D, 2>(a, split, stream, grid);
        case 4: return tc_launch_fwd<D, 4>(a, split, stream, grid);
        case 8: return tc_launch_fwd<D, 8>(a, split, stream, grid);
        case 16: return tc_launch_fwd<D, 16>(a, split, stream, grid);
        default: return cudaErrorInvalidValue;
    }
}

template <int D>
cudaError_t tc_launch_bwd_attn_d(const TcArgs& a, bool split, cudaStream_t stream, int* grid) {
    const int kt = tc_key_tiles(a.temporal ? a.F : a.J);
    if (split && !tc_splits(kt)) return cudaErrorInvalidValue;
    switch (kt) {
        case 1: return tc_launch_bwd_attn<D, 1>(a, split, stream, grid);
        case 2: return tc_launch_bwd_attn<D, 2>(a, split, stream, grid);
        case 4: return tc_launch_bwd_attn<D, 4>(a, split, stream, grid);
        case 8: return tc_launch_bwd_attn<D, 8>(a, split, stream, grid);
        case 16: return tc_launch_bwd_attn<D, 16>(a, split, stream, grid);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace
