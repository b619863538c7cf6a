// The Hopper GEMM engine: bf16 products with fp32 accumulation for NVIDIA
// Hopper (sm_90a), fed by the Tensor Memory Accelerator (TMA) and computed
// by warpgroup MMAs (wgmma). It takes the three operand layouts of
// pair_common.cuh's Layout enum and the epilogues of its Epilogue enum, each
// rounding where the JAX kernels round (the epilogue on the fp32 sum, one
// rounding to bf16):
//   NT  out[M, N] = A[M, K] . W[N, K]^T   A and W K-major: wgmma's native form
//   NN  out[M, N] = A[M, K] . W[K, N]     W N-major: the B transpose bit
//   TN  out[N, K] = sum_m A[m, n] W[m, k] both M-major: both transpose bits;
//       the token rows M are cut into HG_TN_SPLITS fixed chunks (a multiple
//       of the k-step each), every block writes its chunk's fp32 partial tile
//       (EPI_PARTIAL) and the caller adds the partials in chunk order, so the
//       result is the same bits on every run
// The whole-width chains run launch_ln_fwd_rows first (pair_bwd_common.cuh)
// and feed its bf16 rows to NT; the attention block on shards takes the
// LayerNorm inside its qkv product (hg_ln_kernel: the last section).
// hg_weight_grad is TN with the in-order second pass
// (pair_bwd_common.cuh's reduce_splits): the weight gradients of the pair
// backward (pair_bwd_kernels.cu) and of the attention and MLP block
// backwards (block_kernels.cu).
//
// Design. Persistent blocks, two an SM, walk over the 128 x 128 output tiles
// (column tile fastest) in two roles. Warp 8 is the producer: one thread
// keeps TMA loads (cp.async.bulk.tensor, 128-byte swizzle) in flight into a
// ring of HG_STAGES stages of 32 KB (a 128 x 64 A tile and a 128 x 64 B
// tile), each stage with a "full" mbarrier (the TMA's byte count) and an
// "empty" one (one arrival per consumer warp); the ring runs on across the
// block's tiles, so the next tile's loads overlap this one's epilogue.
// Warpgroups 0 and 1 (warps 0-7) are the consumers, each owning 64 rows of
// the tile as a 64 x 128 fp32 accumulator in registers (64 a thread): four
// m64n128k16 wgmmas per stage straight from shared memory through matrix
// descriptors, one stage's group kept in flight, a stage released once the
// group after it is committed. The epilogue works from the accumulator
// fragments where wgmma leaves them (thread t of warp w holds rows w*16 + t/4
// and + 8, column pairs 8j + 2(t%4)); neighbouring lanes swap one pair so
// that each holds four consecutive columns of one row, and apply the bias,
// residual, GELU or GELU' with 8- and 16-byte loads and stores, masking rows
// and columns past the edge: no fp32 staging tile. Loads past the edge of a
// tensor come back as zeros from the TMA, so any row count M and any
// multiple of 64 for N and K work; a box wholly outside counts its bytes
// too. The producer is one warp, so a block is 288 threads: two fit an SM
// (2 x 96 KB of shared memory, <= 112 registers a thread) without
// setmaxnreg, and one block's epilogue can run beside the other's products;
// the heavy epilogues (GELU, GELU', the fp32 z) still add most of their time
// to the products' (PERF.md). A ping-pong schedule (each warpgroup a whole
// tile, one block an SM) was measured beside this one and lost on the GELU'
// epilogue: four warps could not keep up with it.
//
// The pipeline (hg_gemm_body: hg_load_tile and hg_mma_tile for each of a
// block's tiles) is a template on an MMA policy, which says what a stage
// holds and which wgmma consumes it, and an epilogue functor: HgBf16 and
// HgEpilogue here, under hg_gemm_kernel; the int8 policy and the
// dequantising epilogue of hopper_gemm_s8.cuh, under hg_gemm_s8_kernel. One
// launcher (hg_launch) puts either on the persistent grid.
//
// Grouped rounds (hg_gemm_pair_kernel). A TN weight gradient at a tensor-
// parallel shard's widths is a few tiles times HG_TN_SPLITS chunks: 64 to
// 192 blocks of the 264 the grid holds, one long round (33 k-steps a tile
// at 16524 rows) on part of the card. hg_gemm_pair walks two independent
// products' tiles in one launch, each tile as its own launch computes it
// (same k order, same epilogue, same bits): two TN gradients side by side
// (block_kernels.cu's hg_weight_grad2: B5_tp's dWqkv and dWproj, then one
// in-order pass over both partial sets, its reduce_partials), or a TN gradient
// beside an NN product that reads the same operand (B7_tp's dW2 with dz, dW1
// with dh), the NN tiles filling the blocks the TN round leaves free.
//
// Everything is in an anonymous namespace, like the other headers: each .cu
// that includes this file builds its own copy.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <atomic>

#include "pair_bwd_common.cuh"

namespace {

constexpr int HG_BM = 128, HG_BN = 128, HG_BK = 64;
constexpr int HG_STAGES = 3;
constexpr int HG_MIN_BLOCKS = 2;                  // blocks an SM
constexpr int HG_CONSUMER_THREADS = 256;          // warpgroups 0 and 1
constexpr int HG_THREADS = HG_CONSUMER_THREADS + 32;  // + the producer warp
constexpr int HG_TN_SPLITS = 8;                   // fixed row chunks of TN
constexpr int HG_BOX_BYTES = 64 * HG_BK * 2;      // 64 rows of K-major, or one 64-wide MN box
constexpr int HG_A_BYTES = HG_BM * HG_BK * 2;
constexpr int HG_STAGE_BYTES = HG_A_BYTES + HG_BN * HG_BK * 2;
constexpr int HG_SMEM = HG_STAGES * HG_STAGE_BYTES + 2 * HG_STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// one 2-D box of the tensor map into shared memory; c0 is the inner coordinate
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled operand tile. K-major: rows
// of 64 bf16 (128 B), 8-row groups 1024 B apart (SBO); the k16 steps advance
// the start address by 32 B. MN-major: 64-wide MN boxes of 64 k-rows
// (128 B each), the boxes 8 KB apart (LBO), 8-k-row groups 1024 B apart
// (SBO); the k16 steps advance by 16 k-rows, 2048 B. Tiles sit on 1024-byte
// boundaries, so the base offset stays 0.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, bool mn_major) {
    uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
    d |= (uint64_t)(mn_major ? (HG_BOX_BYTES >> 4) : 1) << 16;
    d |= (uint64_t)(1024 >> 4) << 32;
    d |= 1ull << 62;
    return d;
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], bf16 operands from shared memory
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// The engine's MMA policies (this one and hopper_gemm_s8.cuh's HgS8): the
// K a stage holds (BK elements, one 128-byte swizzled row of a K-major
// tile), the accumulator's type, its register fence, and a stage's four
// wgmmas from the A and B tiles' shared addresses. A bf16 k16 step advances
// a K-major operand 32 bytes and an MN-major one 16 k-rows (2048 B).
struct HgBf16 {
    using Acc = float;
    static constexpr int BK = HG_BK;
    static __device__ __forceinline__ void fence(float (&d)[64]) { fence_acc(d); }
    template <bool A_MN, bool B_MN>
    static __device__ __forceinline__ void stage(float (&d)[64], uint32_t a, uint32_t b) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n128k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(
                d, wgmma_desc(a + kk * (A_MN ? 2048 : 32), A_MN),
                wgmma_desc(b + kk * (B_MN ? 2048 : 32), B_MN));
    }
};

// The epilogue of four consecutive columns n..n+3 of one output row (o the
// first's offset), as the Epilogue enum defines it: the bias and residual
// added to the fp32 sum, GELU or GELU' applied to it in fp32, one rounding to
// bf16 at the end; 8- and 16-byte loads (through the read-only path: the
// operands reach the kernel in a functor, whose pointers carry no
// __restrict__) and stores.
template <int EPI>
__device__ __forceinline__ void epilogue4(float (&v)[4], size_t o, int n,
                                          const bf16* __restrict__ bias,
                                          const bf16* __restrict__ R,
                                          const float* __restrict__ Z, void* __restrict__ out,
                                          float* __restrict__ out_z, float* __restrict__ part) {
    if (EPI == EPI_F32 || EPI == EPI_PARTIAL) {
        float* dst = EPI == EPI_F32 ? static_cast<float*>(out) + o : part + o;
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
    if (EPI == EPI_DGELU) {
        const float4 z = __ldg(reinterpret_cast<const float4*>(Z + o));
        v[0] *= gelu_grad(z.x);
        v[1] *= gelu_grad(z.y);
        v[2] *= gelu_grad(z.z);
        v[3] *= gelu_grad(z.w);
    }
    if (EPI == EPI_BIAS || EPI == EPI_BIAS_RES || EPI == EPI_BIAS_GELU ||
        EPI == EPI_BIAS_GELU_Z) {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(bias + n));
        const float2 b01 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw.x));
        const float2 b23 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw.y));
        v[0] += b01.x;
        v[1] += b01.y;
        v[2] += b23.x;
        v[3] += b23.y;
    }
    if (EPI == EPI_BIAS_RES || EPI == EPI_RES) {
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(R + o));
        const float2 r01 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw.x));
        const float2 r23 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&raw.y));
        v[0] += r01.x;
        v[1] += r01.y;
        v[2] += r23.x;
        v[3] += r23.y;
    }
    if (EPI == EPI_BIAS_GELU_Z)
        *reinterpret_cast<float4*>(out_z + o) = make_float4(v[0], v[1], v[2], v[3]);
    if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_Z) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = gelu(v[e]);
    }
    const bf162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + o) = packed;
}

// The bf16 engine's epilogue functor: EPI's operands, and for EPI_PARTIAL
// the elements of one TN chunk's fp32 partial tile (rows x cols).
template <int EPI>
struct HgEpilogue {
    static constexpr bool ROW_AMAX = false;   // see hg_gemm_body
    const bf16* bias;
    const bf16* R;
    const float* Z;
    void* out;
    float* out_z;
    size_t chunk_elems;
    __device__ __forceinline__ void operator()(float (&v)[4], int, int n, size_t o,
                                               int chunk) const {
        float* part = EPI == EPI_PARTIAL ? static_cast<float*>(out) + chunk * chunk_elems
                                         : nullptr;
        epilogue4<EPI>(v, o, n, bias, R, Z, out, out_z, part);
    }
};

// The grouped launch's pieces (hg_gemm_pair_kernel): hg_gemm_body's tile
// walk, ring, loads and MMA + epilogue of one tile, statement for statement,
// as functions a kernel can call for either of two products. hg_gemm_body
// keeps its own text, so that the single-product kernels compile as they
// did.
//
// A product's tile grid (see the layouts above): rows x cols is the
// output's shape (M x N, or N x K for TN) and k_len the reduction's length
// (K, or M for TN); TN reduces chunk z over [z * split, z * split + split).
// Tile t of the tiles_x * tiles_y * chunks (n_tiles) has its column tile
// fastest.
struct HgShape {
    int rows, cols, k_len, split, tiles_x, tiles_y, n_tiles;
};

// Tile t's first row and column, its k-steps [k0, k0 + nk) and its TN chunk.
template <int LAYOUT, int BK>
__device__ __forceinline__ void hg_tile_at(const HgShape& sh, int t, int& r0, int& c0, int& k0,
                                           int& nk, int& chunk) {
    const int per_chunk = sh.tiles_x * sh.tiles_y;
    const int rest = t % per_chunk;
    chunk = t / per_chunk;
    r0 = (rest / sh.tiles_x) * HG_BM;
    c0 = (rest % sh.tiles_x) * HG_BN;
    int k_begin = 0, k_end = sh.k_len;
    if (LAYOUT == TN) {
        k_begin = chunk * sh.split;
        k_end = min(sh.k_len, k_begin + sh.split);
    }
    k0 = k_begin;
    nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
}

// The ring in shared memory: HG_STAGES stages of tiles, their "full" and
// "empty" mbarriers. hg_ring sets the barriers up (the whole block calls it).
struct HgRing {
    uint32_t tiles, full, empty;
};

__device__ __forceinline__ HgRing hg_ring() {
    extern __shared__ unsigned char hg_smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(hg_smem_raw) + 1023) & ~uintptr_t(1023));
    HgRing ring;
    ring.tiles = smem_u32(smem);
    ring.full = ring.tiles + HG_STAGES * HG_STAGE_BYTES;
    ring.empty = ring.full + HG_STAGES * 8;
    if (threadIdx.x == 0) {
        for (int s = 0; s < HG_STAGES; ++s) {
            mbar_init(ring.full + 8 * s, 1);
            mbar_init(ring.empty + 8 * s, HG_CONSUMER_THREADS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    return ring;
}

// The producer's loads of tile t (one thread issues them); step, the ring's
// running k-step, runs on across the block's tiles.
template <int LAYOUT, class MMA>
__device__ __forceinline__ void hg_load_tile(const CUtensorMap& tma_a, const CUtensorMap& tma_b,
                                             const HgRing& ring, const HgShape& sh, int t,
                                             int& step) {
    constexpr bool A_MN = LAYOUT == TN;
    constexpr bool B_MN = LAYOUT != NT;
    constexpr int BK = MMA::BK;
    int r0, c0, k0, nk, chunk;
    hg_tile_at<LAYOUT, BK>(sh, t, r0, c0, k0, nk, chunk);
    for (int k = 0; k < nk; ++k, ++step) {
        const int s = step % HG_STAGES;
        const uint32_t bar = ring.full + 8 * s;
        mbar_wait(ring.empty + 8 * s, ((step / HG_STAGES) & 1) ^ 1);
        mbar_expect_tx(bar, HG_STAGE_BYTES);
        const uint32_t a = ring.tiles + s * HG_STAGE_BYTES, b = a + HG_A_BYTES;
        const int kk = k0 + k * BK;
        if (A_MN) {
            tma_load(a, &tma_a, bar, r0, kk);
            tma_load(a + HG_BOX_BYTES, &tma_a, bar, r0 + 64, kk);
        } else {
            tma_load(a, &tma_a, bar, kk, r0);
        }
        if (B_MN) {
            tma_load(b, &tma_b, bar, c0, kk);
            tma_load(b + HG_BOX_BYTES, &tma_b, bar, c0 + 64, kk);
        } else {
            tma_load(b, &tma_b, bar, kk, c0);
        }
    }
}

// The consumer warpgroups' products and epilogue of tile t: rows [cw * 64,
// cw * 64 + 64) of it for warpgroup cw. epi(v, m, n, offset, chunk) takes
// four consecutive columns of row m below rows and cols. An epilogue with
// ROW_AMAX returns the largest |value| it wrote, and epi.row_amax(amax, m)
// takes each row's largest over the tile's columns, once a row and tile (the
// W8A8 pair on shards: hopper_gemm_s8.cuh).
template <int LAYOUT, class MMA, class EPI>
__device__ __forceinline__ void hg_mma_tile(const EPI& epi, const HgRing& ring,
                                            const HgShape& sh, int t, int& step) {
    constexpr bool A_MN = LAYOUT == TN;
    constexpr bool B_MN = LAYOUT != NT;
    constexpr int BK = MMA::BK;
    using Acc = typename MMA::Acc;
    const int cw = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    int r0, c0, k0, nk, chunk;
    hg_tile_at<LAYOUT, BK>(sh, t, r0, c0, k0, nk, chunk);
    Acc acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int k = 0; k < nk; ++k, ++step) {
        const int s = step % HG_STAGES;
        mbar_wait(ring.full + 8 * s, (step / HG_STAGES) & 1);
        // K-major A: 64 rows of 128 B; MN-major A: the cw-th 64-wide box
        const uint32_t a = ring.tiles + s * HG_STAGE_BYTES + cw * HG_BOX_BYTES;
        const uint32_t b = ring.tiles + s * HG_STAGE_BYTES + HG_A_BYTES;
        MMA::fence(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        MMA::template stage<A_MN, B_MN>(acc, a, b);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        MMA::fence(acc);
        if (k > 0 && lane == 0) mbar_arrive(ring.empty + 8 * ((step - 1) % HG_STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    MMA::fence(acc);
    if (nk > 0 && lane == 0) mbar_arrive(ring.empty + 8 * ((step - 1) % HG_STAGES));

    // lanes 2p and 2p+1 swap halves so that each holds four consecutive
    // columns of one row: the even lane row w*16 + t/4, the odd one that
    // row + 8
    const bool upper = lane & 1;
    const int m = r0 + cw * 64 + warp * 16 + (lane >> 2) + (upper ? 8 : 0);
    float amax = 0.f;
#pragma unroll
    for (int jn = 0; jn < HG_BN / 8; ++jn) {
        const Acc s0 = upper ? acc[4 * jn] : acc[4 * jn + 2];
        const Acc s1 = upper ? acc[4 * jn + 1] : acc[4 * jn + 3];
        const Acc p0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const Acc p1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        Acc v[4];
        if (upper) {
            v[0] = p0; v[1] = p1; v[2] = acc[4 * jn + 2]; v[3] = acc[4 * jn + 3];
        } else {
            v[0] = acc[4 * jn]; v[1] = acc[4 * jn + 1]; v[2] = p0; v[3] = p1;
        }
        const int n = c0 + jn * 8 + (lane & 2) * 2;
        if (m >= sh.rows || n >= sh.cols) continue;
        if constexpr (EPI::ROW_AMAX)
            amax = fmaxf(amax, epi(v, m, n, (size_t)m * sh.cols + n, chunk));
        else
            epi(v, m, n, (size_t)m * sh.cols + n, chunk);
    }
    if constexpr (EPI::ROW_AMAX) {
        // lanes lane and lane ^ 2 hold row m's two halves of the tile
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        if (!(lane & 2) && m < sh.rows) epi.row_amax(amax, m);
    }
}

// The engine's pipeline, for any MMA policy and epilogue functor (see the
// layouts above; int8 takes NT only). rows x cols is the output's shape (M x
// N, or N x K for TN) and k_len the reduction's length (K, or M for TN); TN
// reduces chunk z over [z * split, z * split + split). A block takes tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of the tiles_x * tiles_y * chunks
// tiles (column tile fastest); the ring's stage and phase run on across its
// tiles. epi(v, m, n, offset, chunk) takes four consecutive columns of row m
// below rows and cols. An epilogue with ROW_AMAX returns the largest |value|
// it wrote, and epi.row_amax(amax, m) takes each row's largest over the
// tile's columns, once a row and tile (the W8A8 pair on shards:
// hopper_gemm_s8.cuh).
template <int LAYOUT, class MMA, class EPI>
__device__ __forceinline__ void hg_gemm_body(const CUtensorMap& tma_a, const CUtensorMap& tma_b,
                                             const EPI& epi, int rows, int cols, int k_len,
                                             int split, int tiles_x, int tiles_y, int n_tiles) {
    constexpr bool A_MN = LAYOUT == TN;
    constexpr bool B_MN = LAYOUT != NT;
    constexpr int BK = MMA::BK;
    using Acc = typename MMA::Acc;
    extern __shared__ unsigned char hg_smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(hg_smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t tiles = smem_u32(smem);
    const uint32_t full = tiles + HG_STAGES * HG_STAGE_BYTES;
    const uint32_t empty = full + HG_STAGES * 8;

    if (threadIdx.x == 0) {
        for (int s = 0; s < HG_STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, HG_CONSUMER_THREADS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    // tile t: its first row and column, and its k-steps [k0, k0 + nk)
    auto tile_at = [&](int t, int& r0, int& c0, int& k0, int& nk) {
        const int per_chunk = tiles_x * tiles_y;
        const int z = t / per_chunk, rest = t % per_chunk;
        r0 = (rest / tiles_x) * HG_BM;
        c0 = (rest % tiles_x) * HG_BN;
        int k_begin = 0, k_end = k_len;
        if (LAYOUT == TN) {
            k_begin = z * split;
            k_end = min(k_len, k_begin + split);
        }
        k0 = k_begin;
        nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
    };

    if (threadIdx.x >= HG_CONSUMER_THREADS) {
        // producer warp: one thread issues every load
        if (threadIdx.x == HG_CONSUMER_THREADS) {
            asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&tma_a)) : "memory");
            asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&tma_b)) : "memory");
            int step = 0;
            for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
                int r0, c0, k0, nk;
                tile_at(t, r0, c0, k0, nk);
                for (int k = 0; k < nk; ++k, ++step) {
                    const int s = step % HG_STAGES;
                    const uint32_t bar = full + 8 * s;
                    mbar_wait(empty + 8 * s, ((step / HG_STAGES) & 1) ^ 1);
                    mbar_expect_tx(bar, HG_STAGE_BYTES);
                    const uint32_t a = tiles + s * HG_STAGE_BYTES, b = a + HG_A_BYTES;
                    const int kk = k0 + k * BK;
                    if (A_MN) {
                        tma_load(a, &tma_a, bar, r0, kk);
                        tma_load(a + HG_BOX_BYTES, &tma_a, bar, r0 + 64, kk);
                    } else {
                        tma_load(a, &tma_a, bar, kk, r0);
                    }
                    if (B_MN) {
                        tma_load(b, &tma_b, bar, c0, kk);
                        tma_load(b + HG_BOX_BYTES, &tma_b, bar, c0 + 64, kk);
                    } else {
                        tma_load(b, &tma_b, bar, kk, c0);
                    }
                }
            }
        }
    } else {
        // consumer warpgroups: rows [cw * 64, cw * 64 + 64) of each tile
        const int cw = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
        int step = 0;
        for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
            int r0, c0, k0, nk;
            tile_at(t, r0, c0, k0, nk);
            Acc acc[64];
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = 0;
            for (int k = 0; k < nk; ++k, ++step) {
                const int s = step % HG_STAGES;
                mbar_wait(full + 8 * s, (step / HG_STAGES) & 1);
                // K-major A: 64 rows of 128 B; MN-major A: the cw-th 64-wide box
                const uint32_t a = tiles + s * HG_STAGE_BYTES + cw * HG_BOX_BYTES;
                const uint32_t b = tiles + s * HG_STAGE_BYTES + HG_A_BYTES;
                MMA::fence(acc);
                asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
                MMA::template stage<A_MN, B_MN>(acc, a, b);
                asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
                asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
                MMA::fence(acc);
                if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((step - 1) % HG_STAGES));
            }
            asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
            MMA::fence(acc);
            if (nk > 0 && lane == 0) mbar_arrive(empty + 8 * ((step - 1) % HG_STAGES));

            const int chunk = t / (tiles_x * tiles_y);
            // lanes 2p and 2p+1 swap halves so that each holds four
            // consecutive columns of one row: the even lane row w*16 +
            // t/4, the odd one that row + 8
            const bool upper = lane & 1;
            const int m = r0 + cw * 64 + warp * 16 + (lane >> 2) + (upper ? 8 : 0);
            float amax = 0.f;
#pragma unroll
            for (int jn = 0; jn < HG_BN / 8; ++jn) {
                const Acc s0 = upper ? acc[4 * jn] : acc[4 * jn + 2];
                const Acc s1 = upper ? acc[4 * jn + 1] : acc[4 * jn + 3];
                const Acc p0 = __shfl_xor_sync(0xffffffffu, s0, 1);
                const Acc p1 = __shfl_xor_sync(0xffffffffu, s1, 1);
                Acc v[4];
                if (upper) {
                    v[0] = p0; v[1] = p1; v[2] = acc[4 * jn + 2]; v[3] = acc[4 * jn + 3];
                } else {
                    v[0] = acc[4 * jn]; v[1] = acc[4 * jn + 1]; v[2] = p0; v[3] = p1;
                }
                const int n = c0 + jn * 8 + (lane & 2) * 2;
                if (m >= rows || n >= cols) continue;
                if constexpr (EPI::ROW_AMAX)
                    amax = fmaxf(amax, epi(v, m, n, (size_t)m * cols + n, chunk));
                else
                    epi(v, m, n, (size_t)m * cols + n, chunk);
            }
            if constexpr (EPI::ROW_AMAX) {
                // lanes lane and lane ^ 2 hold row m's two halves of the tile
                amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
                if (!(lane & 2) && m < rows) epi.row_amax(amax, m);
            }
        }
    }
}

// The bf16 engine's kernel. The int8 engine's (hopper_gemm_s8.cuh) runs the
// same body under its own name, so that a profile tells the two apart.
template <int LAYOUT, int EPI>
__global__ void __launch_bounds__(HG_THREADS, HG_MIN_BLOCKS)
hg_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
               const __grid_constant__ CUtensorMap tma_b,
               const __grid_constant__ HgEpilogue<EPI> epi,
               int rows, int cols, int k_len, int split, int tiles_x, int tiles_y,
               int n_tiles) {
    hg_gemm_body<LAYOUT, HgBf16>(tma_a, tma_b, epi, rows, cols, k_len, split, tiles_x,
                                 tiles_y, n_tiles);
}

// Two products in one persistent launch (hg_gemm_pair): their tiles in one
// list, product 0's first (the longer-running tiles: the caller puts a TN
// weight gradient there), each tile computed as its own product's launch
// computes it. Block b of the grid's G takes product 0's tiles b, b + G, ...;
// then, where the last round of those left it free (b >= rem = n0 % G),
// `lead` of product 1's tiles (j = b - rem + i (G - rem)) in the time of one
// of product 0's; then product 1's remaining tiles round robin from
// lead * (G - rem). The ring runs on across both products' tiles.
template <int L0, int E0, int L1, int E1>
__global__ void __launch_bounds__(HG_THREADS, HG_MIN_BLOCKS)
hg_gemm_pair_kernel(const __grid_constant__ CUtensorMap a0,
                    const __grid_constant__ CUtensorMap b0,
                    const __grid_constant__ CUtensorMap a1,
                    const __grid_constant__ CUtensorMap b1,
                    const __grid_constant__ HgEpilogue<E0> e0,
                    const __grid_constant__ HgEpilogue<E1> e1,
                    const __grid_constant__ HgShape s0,
                    const __grid_constant__ HgShape s1, int lead) {
    const HgRing ring = hg_ring();
    const int G = gridDim.x, b = blockIdx.x, rem = s0.n_tiles % G;
    const int first = b - rem, stride = G - rem, rest = lead * (G - rem) + b;
    int step = 0;
    if (threadIdx.x >= HG_CONSUMER_THREADS) {
        if (threadIdx.x == HG_CONSUMER_THREADS) {
            const CUtensorMap* maps[4] = {&a0, &b0, &a1, &b1};
#pragma unroll
            for (int i = 0; i < 4; ++i)
                asm volatile("prefetch.tensormap [%0];"
                             :: "l"(reinterpret_cast<uint64_t>(maps[i])) : "memory");
            for (int t = b; t < s0.n_tiles; t += G)
                hg_load_tile<L0, HgBf16>(a0, b0, ring, s0, t, step);
            for (int i = 0, j = first; first >= 0 && i < lead && j < s1.n_tiles; ++i, j += stride)
                hg_load_tile<L1, HgBf16>(a1, b1, ring, s1, j, step);
            for (int j = rest; j < s1.n_tiles; j += G)
                hg_load_tile<L1, HgBf16>(a1, b1, ring, s1, j, step);
        }
    } else {
        for (int t = b; t < s0.n_tiles; t += G) hg_mma_tile<L0, HgBf16>(e0, ring, s0, t, step);
        for (int i = 0, j = first; first >= 0 && i < lead && j < s1.n_tiles; ++i, j += stride)
            hg_mma_tile<L1, HgBf16>(e1, ring, s1, j, step);
        for (int j = rest; j < s1.n_tiles; j += G) hg_mma_tile<L1, HgBf16>(e1, ring, s1, j, step);
    }
}

// cuTensorMapEncodeTiled, a driver-API function, fetched through the runtime
// so that the library links against cudart alone
typedef CUresult (*TensorMapEncodeFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

TensorMapEncodeFn tensor_map_encoder() {
    static const TensorMapEncodeFn fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                        cudaEnableDefault, &q);
#endif
        return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
                   ? reinterpret_cast<TensorMapEncodeFn>(p) : nullptr;
    }();
    return fn;
}

// Map of a row-major (outer, inner) tensor of elem_bytes-wide elements cut
// into boxes of 128 bytes along inner (the swizzle's span) by box_outer rows.
// The encoder refuses a row stride that is not a multiple of 16 bytes.
bool tensor_map_rows(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                     int elem_bytes, int inner, int outer, int box_outer) {
    const TensorMapEncodeFn encode = tensor_map_encoder();
    if (encode == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
    const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_outer};
    const cuuint32_t elem_strides[2] = {1u, 1u};
    return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of a row-major bf16 (outer, inner) tensor cut into boxes of 64 inner
// elements by box_outer rows.
bool tensor_map_2d(CUtensorMap* map, const void* base, int inner, int outer, int box_outer) {
    return tensor_map_rows(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), inner,
                           outer, box_outer);
}

// Token rows of one TN chunk: the split of M into HG_TN_SPLITS, rounded up to
// a whole number of k-steps.
int hg_split_rows(int M) {
    return ((M + HG_TN_SPLITS - 1) / HG_TN_SPLITS + HG_BK - 1) / HG_BK * HG_BK;
}

// Blocks device dev holds at once (HG_MIN_BLOCKS an SM): the persistent grid.
int hg_resident_blocks(int dev) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
    return sms * HG_MIN_BLOCKS;
}

// Opts KERNEL in to `bytes` of dynamic shared memory on the current device,
// once per kernel and device; dev receives the device.
template <auto KERNEL>
cudaError_t hg_opt_in(size_t bytes, int& dev) {
    static std::atomic<unsigned long long> smem_set{0};
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(smem_set.load() & bit)) {
        err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
        if (err != cudaSuccess) return err;
        smem_set.fetch_or(bit);
    }
    return cudaSuccess;
}

// Launches KERNEL, an instantiation of the engine, on the persistent grid:
// min(n_tiles, the blocks the device holds at once) blocks of HG_THREADS
// with HG_SMEM of shared memory (hg_opt_in).
template <auto KERNEL, class... Args>
cudaError_t hg_launch(int n_tiles, cudaStream_t stream, Args... args) {
    int dev = 0;
    const cudaError_t err = hg_opt_in<KERNEL>(HG_SMEM, dev);
    if (err != cudaSuccess) return err;
    const int resident = hg_resident_blocks(dev);
    if (resident == 0) return cudaErrorInvalidValue;
    KERNEL<<<min(n_tiles, resident), HG_THREADS, HG_SMEM, stream>>>(args...);
    return cudaGetLastError();
}

// One product of the engine, ready to launch: LAYOUT's product of A and W
// (M token rows, N output columns, K the reduction of NT and NN; for TN, A
// is (M, N), W is (M, K) and out HG_TN_SPLITS partial (N, K) fp32 tiles,
// chunk_stride floats apart), then EPI with bias, R and Z (out_z for
// EPI_BIAS_GELU_Z).
template <int LAYOUT, int EPI>
struct HgProduct {
    CUtensorMap ta, tb;
    HgEpilogue<EPI> epi;
    HgShape shape;
};

// Builds p for hg_gemm's arguments; TN partials chunk_stride floats apart
// (0: N * K, one product's partials alone). Needs N % 64 == 0 and K % 64 ==
// 0, 16-byte-aligned A and W; any M >= 1. Returns cudaErrorInvalidValue when
// a tensor map cannot be built.
template <int LAYOUT, int EPI>
cudaError_t hg_product(HgProduct<LAYOUT, EPI>& p, const void* A, const void* W,
                       const void* bias, const void* R, const void* Z, void* out, void* out_z,
                       int M, int N, int K, size_t chunk_stride = 0) {
    static_assert((LAYOUT == TN) == (EPI == EPI_PARTIAL), "TN writes partials, and only TN");
    bool ok;
    int rows, cols, k_len, split = 0, chunks = 1;
    if (LAYOUT == TN) {
        ok = tensor_map_2d(&p.ta, A, N, M, HG_BK) && tensor_map_2d(&p.tb, W, K, M, HG_BK);
        rows = N, cols = K, k_len = M, split = hg_split_rows(M), chunks = HG_TN_SPLITS;
    } else {
        ok = tensor_map_2d(&p.ta, A, K, M, HG_BM) &&
             (LAYOUT == NT ? tensor_map_2d(&p.tb, W, K, N, HG_BN)
                           : tensor_map_2d(&p.tb, W, N, K, HG_BK));
        rows = M, cols = N, k_len = K;
    }
    if (!ok) return cudaErrorInvalidValue;
    const int tiles_x = (cols + HG_BN - 1) / HG_BN, tiles_y = (rows + HG_BM - 1) / HG_BM;
    p.shape = HgShape{rows, cols, k_len, split, tiles_x, tiles_y, tiles_x * tiles_y * chunks};
    p.epi = HgEpilogue<EPI>{static_cast<const bf16*>(bias), static_cast<const bf16*>(R),
                            static_cast<const float*>(Z), out, static_cast<float*>(out_z),
                            chunk_stride ? chunk_stride : (size_t)rows * cols};
    return cudaSuccess;
}

// The engine's launch: out = LAYOUT's product of A and W, then EPI (see
// HgProduct and hg_product).
template <int LAYOUT, int EPI>
cudaError_t hg_gemm(const void* A, const void* W, const void* bias, const void* R,
                    const void* Z, void* out, void* out_z, int M, int N, int K,
                    cudaStream_t stream) {
    HgProduct<LAYOUT, EPI> p;
    const cudaError_t err = hg_product(p, A, W, bias, R, Z, out, out_z, M, N, K);
    if (err != cudaSuccess) return err;
    const HgShape& s = p.shape;
    return hg_launch<hg_gemm_kernel<LAYOUT, EPI>>(s.n_tiles, stream, p.ta, p.tb, p.epi, s.rows,
                                                  s.cols, s.k_len, s.split, s.tiles_x,
                                                  s.tiles_y, s.n_tiles);
}

// k-steps of one of a product's tiles (a TN chunk's, or the whole K).
inline int hg_tile_steps(const HgShape& s) {
    return ((s.split ? s.split : s.k_len) + HG_BK - 1) / HG_BK;
}

// The k-steps an epilogue adds to a tile's time, for hg_gemm_pair's lead:
// GELU' reads a 64 KB fp32 tile of z and computes erf and exp per element,
// about as long as 8 k-steps of products (measured at B7_tp's dz, where
// leads 2-3 beat 4 and 1: PERF.md); the others store what they computed.
template <int EPI>
constexpr int hg_epilogue_steps() {
    return EPI == EPI_DGELU ? 8 : 0;
}

// p0 and p1 in one launch of hg_gemm_pair_kernel on the persistent grid:
// min(both products' tiles, the blocks the device holds at once) blocks.
// lead is how many of p1's tiles a block takes where p0's last round left it
// free; 0: p0's tile time in p1's tiles, each a tile's k-steps plus its
// epilogue's (hg_epilogue_steps), rounded, at least 1.
template <int L0, int E0, int L1, int E1>
cudaError_t hg_gemm_pair(const HgProduct<L0, E0>& p0, const HgProduct<L1, E1>& p1,
                         cudaStream_t stream, int lead = 0) {
    const int k0 = hg_tile_steps(p0.shape) + hg_epilogue_steps<E0>();
    const int k1 = hg_tile_steps(p1.shape) + hg_epilogue_steps<E1>();
    if (lead <= 0) lead = k1 > 0 ? max(1, (k0 + k1 / 2) / k1) : 1;
    return hg_launch<hg_gemm_pair_kernel<L0, E0, L1, E1>>(
        p0.shape.n_tiles + p1.shape.n_tiles, stream, p0.ta, p0.tb, p1.ta, p1.tb, p0.epi,
        p1.epi, p0.shape, p1.shape, lead);
}

// The TN product of a weight gradient dW (rows, cols) = sum_m dY[m, :rows]^T
// A[m, :cols] whose HG_TN_SPLITS partials sit at work + offset, chunk_stride
// floats apart: two gradients' partials side by side, chunk by chunk, for
// one in-order pass over both (block_kernels.cu's reduce_partials).
cudaError_t hg_partials(HgProduct<TN, EPI_PARTIAL>& p, const void* dY, const void* A, int M,
                        int rows, int cols, float* work, size_t offset, size_t chunk_stride) {
    return hg_product(p, dY, A, nullptr, nullptr, nullptr, work + offset, nullptr, M, rows,
                      cols, chunk_stride);
}

// dW (rows, cols) bf16 = sum_m dY[m, :rows]^T A[m, :cols] on the engine:
// HG_TN_SPLITS fp32 partials in work, added in chunk order.
cudaError_t hg_weight_grad(const void* dY, const void* A, int M, int rows, int cols,
                           float* work, void* out, cudaStream_t stream) {
    cudaError_t err = hg_gemm<TN, EPI_PARTIAL>(dY, A, nullptr, nullptr, nullptr, work,
                                               nullptr, M, rows, cols, stream);
    if (err != cudaSuccess) return err;
    return reduce_splits(work, HG_TN_SPLITS, rows * cols, out, true, stream);
}

// ---------------------------------------------------------------------------
// The LayerNorm inside the first product
// ---------------------------------------------------------------------------
//
// The attention block on shards (block_kernels.cu's B4_tp) starts with h =
// bf16(LN(x)) and a product over h. Written by ln_fwd_rows and read back by
// the engine, h costs a launch and a round trip of M x C bf16 through device
// memory (16.9 MB at 16524 rows, C 512); the TPU kernel
// (motionbert_tpu/ops/attention.py:_fused_block_kernel's _ln_rows -> _dot)
// never writes it. Here a
// block owns an M tile of x's rows whole (K = C, up to LNG_MAX_C): the
// producer warp copies them by TMA into shared memory in the 128-byte swizzle
// the engine's A tiles have (k-blocks of HG_BK columns, lng_offset), each
// consumer warp's rows onto its own mbarrier; each warp normalises its rows in
// place as soon as they land, with ln_fwd_rows_kernel's arithmetic, lane map
// and order of sums, all its rows' chains interleaved (lng_normalise: h keeps
// its bits), fences them for the async proxy, and every N tile of the block's
// rows runs its wgmma k-steps over the resident rows in the engine's k order,
// while the weight tiles stream through a ring of mbarrier stages as the
// engine's do. Each output element is summed as hg_gemm<NT, EPI> sums it, so
// the bits are those of ln_fwd_rows -> hg_gemm. One block an SM cannot hide
// its epilogues behind another block's products, so a warpgroup writes its
// tile's epilogue (epilogue4's statements) into a staging tile in shared
// memory and one thread hands it to a TMA store, which drains while the next
// tile's products run (LngStage, lng_store).
// hg_ln_kernel, out = EPI(LN(x) W^T + bias), runs two consumer warpgroups,
// each on 64 rows of the block's 128-row M tile, and one weight tile of 128
// rows a stage, which both read. A block streams the whole weight once for
// its LNG_BM rows (the engine streams each 128 x 128 tile's A and B), so the
// weight bytes through L2 halve from 64-row to 128-row tiles.
// block_kernels.cu launches it (hg_ln_gemm; this header's one launcher is
// the engine's, hg_launch). Shapes it does not take (lng_takes) stay with
// the row pass and the engine: block_kernels.cu's ln_product.

constexpr int LNG_MAX_C = 512;          // widest x row a block keeps in shared memory
constexpr int LNG_BM = 128;             // hg_ln_kernel's M tile: 64 rows a warpgroup
constexpr int LNG_STAGES = 4;           // its weight ring
constexpr int LNG_THREADS = 256 + 32;   // two consumer warpgroups, a producer warp
constexpr int LNG_ROW_BYTES = HG_BK * 2;               // one swizzled row of a k-block
constexpr int LNG_STAGE_BYTES = HG_BN * LNG_ROW_BYTES; // a 128 x 64 weight tile
constexpr int LNG_OUT_ROWS = 64;                       // a staging tile's rows (and a box's)
constexpr int LNG_ROWS_A_WARP = LNG_BM / 8;

// Bytes of a warpgroup's 64 x 128 staging tile of elements `elem` bytes wide.
__host__ __device__ constexpr int lng_out_bytes(int elem) { return LNG_OUT_ROWS * HG_BN * elem; }

// Shared bytes of hg_ln_kernel at rows of C: x's rows (then h), the ring, a
// bf16 staging tile a warpgroup, the ring's and x's mbarriers.
constexpr size_t lng_smem_bytes(int C) {
    return 1024 + (size_t)LNG_BM * C * 2 + (size_t)LNG_STAGES * LNG_STAGE_BYTES
         + 2 * lng_out_bytes(2) + (2 * LNG_STAGES + 8) * 8;
}

static_assert(lng_smem_bytes(LNG_MAX_C) <= 232448, "hg_ln_kernel's shared memory");

// Whether hg_ln_kernel takes rows of C (whole k-blocks that fit beside the
// ring).
inline bool lng_takes(int C) { return C >= HG_BK && C % HG_BK == 0 && C <= LNG_MAX_C; }

// Byte offset of element (r, k) of a resident K-major tile of `rows` rows:
// k-block k / HG_BK (rows 128-byte rows each), 16-byte chunks swizzled by
// the row's place in its 1024-byte group, as the TMA writes a box and wgmma
// reads it.
__device__ __forceinline__ uint32_t lng_offset(int rows, int r, int k) {
    const int c = k & (HG_BK - 1);
    return (uint32_t)(k / HG_BK) * rows * LNG_ROW_BYTES + r * LNG_ROW_BYTES
         + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// R rows [r0, r0 + R) of the resident x tile h (`rows` rows of C,
// lng_offset's layout), normalised in place by one warp: h = bf16(((x -
// mean) * rstd) * w + b), ln_fwd_rows_kernel's statements for each row on its
// lane map (the column pair 2 lane + 64 j of k-block j, summed in j's order,
// then warp_sum), the R rows' chains interleaved so that their latencies
// overlap; a lane's pair sits at the same offset of every k-block.
template <int R>
__device__ __forceinline__ void lng_normalise_rows(unsigned char* h, int rows, int C,
                                                   const float* __restrict__ w,
                                                   const float* __restrict__ b, int r0) {
    const int lane = threadIdx.x & 31;
    const int kb = C / HG_BK, kb_bytes = rows * LNG_ROW_BYTES;
    uint32_t off[R];   // lng_offset(rows, r0 + i, 2 lane)
    float s[R], ss[R], mean[R], rstd[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        off[i] = lng_offset(rows, r0 + i, lane * 2);
        s[i] = ss[i] = 0.f;
    }
    for (int j = 0; j < kb; ++j) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const float2 v = load_bf162(reinterpret_cast<const bf16*>(h + off[i] + j * kb_bytes));
            s[i] += v.x + v.y;
            ss[i] += v.x * v.x + v.y * v.y;
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
        s[i] = warp_sum(s[i]);
        ss[i] = warp_sum(ss[i]);
        mean[i] = s[i] / C;
        const float var = ss[i] / C - mean[i] * mean[i];
        rstd[i] = rsqrtf(var + LN_EPS);
    }
    for (int j = 0; j < kb; ++j) {
        const int k = lane * 2 + 64 * j;
        const float w0 = w[k], w1 = w[k + 1], b0 = b[k], b1 = b[k + 1];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            bf16* p = reinterpret_cast<bf16*>(h + off[i] + j * kb_bytes);
            const float2 v = load_bf162(p);
            const float h0 = ((v.x - mean[i]) * rstd[i]) * w0 + b0;
            const float h1 = ((v.y - mean[i]) * rstd[i]) * w1 + b1;
            *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(h0, h1);
        }
    }
}

// A warp's R rows [first, first + R) of the resident x tile, of which those
// below `last` (the rows x has): all R at once, or one by one at the edge.
template <int R>
__device__ __forceinline__ void lng_normalise(unsigned char* h, int rows, int C,
                                              const float* __restrict__ w,
                                              const float* __restrict__ b, int first, int last) {
    if (first + R <= last) {
        lng_normalise_rows<R>(h, rows, C, w, b, first);
        return;
    }
    for (int r = first; r < last; ++r) lng_normalise_rows<1>(h, rows, C, w, b, r);
}

// Rows written by the generic proxy, read next by wgmma or the TMA: fence,
// then meet the other THREADS consumers at named barrier ID (an immediate,
// so that a block holds only the barriers it names).
template <int ID, int THREADS>
__device__ __forceinline__ void lng_publish() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, %1;" :: "n"(ID), "n"(THREADS) : "memory");
}

template <int ID, int THREADS>
__device__ __forceinline__ void lng_sync() {
    asm volatile("bar.sync %0, %1;" :: "n"(ID), "n"(THREADS) : "memory");
}

// A warpgroup's 64 x 128 accumulator over nk k-steps: A's k-block k at
// a + k * a_step (64 resident rows), B the ring stage's tile; each stage
// released once the next step's group is committed, as hg_mma_tile releases
// them (the same four wgmmas a step, the same k order).
__device__ __forceinline__ void lng_mma(float (&acc)[64], uint32_t a, uint32_t a_step,
                                        uint32_t tiles, uint32_t full, uint32_t empty, int nk,
                                        int& step) {
    constexpr int STAGES = LNG_STAGES;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int k = 0; k < nk; ++k, ++step) {
        const int s = step % STAGES;
        mbar_wait(full + 8 * s, (step / STAGES) & 1);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        HgBf16::stage<false, false>(acc, a + k * a_step, tiles + s * LNG_STAGE_BYTES);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc(acc);
        if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((step - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if (nk > 0 && lane == 0) mbar_arrive(empty + 8 * ((step - 1) % STAGES));
}

// The epilogue of a warpgroup's accumulator, rows row0 + [0, 64) and columns
// col0 + [0, 128): four consecutive columns of one row at a time, as
// hg_mma_tile hands them to its functor, masked at rows and cols (its loop,
// kept apart so that the engine's kernels compile as they did).
template <class EPI>
__device__ __forceinline__ void lng_epilogue(const EPI& epi, float (&acc)[64], int row0,
                                             int col0, int rows, int cols) {
    const int warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
    const bool upper = lane & 1;
    const int m = row0 + warp * 16 + (lane >> 2) + (upper ? 8 : 0);
#pragma unroll
    for (int jn = 0; jn < HG_BN / 8; ++jn) {
        const float s0 = upper ? acc[4 * jn] : acc[4 * jn + 2];
        const float s1 = upper ? acc[4 * jn + 1] : acc[4 * jn + 3];
        const float p0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float p1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        float v[4];
        if (upper) {
            v[0] = p0; v[1] = p1; v[2] = acc[4 * jn + 2]; v[3] = acc[4 * jn + 3];
        } else {
            v[0] = acc[4 * jn]; v[1] = acc[4 * jn + 1]; v[2] = p0; v[3] = p1;
        }
        const int n = col0 + jn * 8 + (lane & 2) * 2;
        if (m >= rows || n >= cols) continue;
        epi(v, m, n, (size_t)m * cols + n, 0);
    }
}

// An epilogue into a warpgroup's staging tile of rows row0 + [0, 64) and
// columns col0 + [0, 128): epilogue4<EPI>'s statements (EPI_BIAS,
// EPI_BIAS_GELU: bf16), stored in boxes of 128 bytes by 64 rows in the
// 128-byte swizzle, the layout lng_store's TMA stores read.
template <int EPI>
struct LngStage {
    static constexpr int ELEM = 2;
    static constexpr int PER = 128 / ELEM;   // columns a box row holds
    const bf16* bias;
    void* stage;   // the tile's generic address
    int row0, col0;
    __device__ __forceinline__ void operator()(float (&v)[4], int m, int n, size_t, int) const {
        const int r = m - row0, c = n - col0;
        const int byte = (c % PER) * ELEM;
        const uint32_t o = (c / PER) * LNG_OUT_ROWS * 128 + r * 128
                         + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
        epilogue4<EPI>(v, o / ELEM, n, bias, nullptr, nullptr, stage, nullptr, nullptr);
    }
};

// One TMA store of a 2-D box from shared memory at src to the tensor map's
// (c0, c1), in the bulk group the caller commits.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
                 : "memory");
}

// The warpgroup's epilogue through its staging tile (ID its named barrier):
// wait until the TMA has read the previous tile's stage, write this tile's
// (LngStage), publish it, and one thread stores its boxes (128 / PER of them)
// at (col0, row0) and commits them; they drain under the next tile's
// products.
template <int EPI, int ID>
__device__ __forceinline__ void lng_store(const CUtensorMap& tma_out, const bf16* bias,
                                          unsigned char* stage, float (&acc)[64], int row0,
                                          int col0, int rows, int cols) {
    using St = LngStage<EPI>;
    const bool leader = (threadIdx.x & 127) == 0;
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    lng_sync<ID, 128>();
    lng_epilogue(St{bias, stage, row0, col0}, acc, row0, col0, rows, cols);
    lng_publish<ID, 128>();
    if (leader) {
        for (int box = 0; box < HG_BN / St::PER; ++box)
            tma_store(&tma_out, smem_u32(stage) + box * LNG_OUT_ROWS * 128, col0 + box * St::PER,
                      row0);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
}

// The leader's wait, before its block exits, until the TMA has read every
// staging tile it was given.
__device__ __forceinline__ void lng_store_done() {
    if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ unsigned char* lng_smem_base() {
    extern __shared__ unsigned char hg_smem_raw[];
    return reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(hg_smem_raw) + 1023) & ~uintptr_t(1023));
}

// The producer's copy of x's rows [m0, m0 + box) into the resident tile's
// rows [r0, r0 + box) (`rows` rows of C): C / HG_BK boxes onto one mbarrier.
__device__ __forceinline__ void lng_load_x(const CUtensorMap& tma_x, uint32_t h, uint32_t bar,
                                           int rows, int r0, int box, int C, int m0) {
    const int kb = C / HG_BK;
    mbar_expect_tx(bar, kb * box * LNG_ROW_BYTES);
    for (int k = 0; k < kb; ++k)
        tma_load(h + (k * rows + r0) * LNG_ROW_BYTES, &tma_x, bar, k * HG_BK, m0);
}

// The producer's loads of the weight's tiles: n_tiles 128-row tiles, each
// over k-blocks [0, kb) in the engine's k order.
__device__ __forceinline__ void lng_load_w(const CUtensorMap& tma_w, uint32_t tiles,
                                           uint32_t full, uint32_t empty, int n_tiles, int kb) {
    constexpr int STAGES = LNG_STAGES;
    int step = 0;
    for (int t = 0; t < n_tiles; ++t) {
        for (int k = 0; k < kb; ++k, ++step) {
            const int s = step % STAGES;
            mbar_wait(empty + 8 * s, ((step / STAGES) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, LNG_STAGE_BYTES);
            tma_load(tiles + s * LNG_STAGE_BYTES, &tma_w, full + 8 * s, k * HG_BK, t * HG_BN);
        }
    }
}

// The ring's and x's mbarriers (the whole block calls it): full and empty of
// each stage (an arrival of each consumer warp releases a stage), then one
// for each consumer warp's rows of x.
template <int STAGES, int WARPS>
__device__ __forceinline__ void lng_barriers(uint32_t full) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(full + 8 * (STAGES + s), WARPS);
        }
        for (int i = 0; i < WARPS; ++i) mbar_init(full + 8 * (2 * STAGES + i), 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
}

// out (M, N) = EPI(LN(x) W^T + bias), bf16, through tma_out: block b owns
// x's rows [b LNG_BM, + LNG_BM) and every N tile of them (see the section's
// note).
template <int EPI>
__global__ void __launch_bounds__(LNG_THREADS, 1)
hg_ln_kernel(const __grid_constant__ CUtensorMap tma_x,
             const __grid_constant__ CUtensorMap tma_w,
             const __grid_constant__ CUtensorMap tma_out, const bf16* __restrict__ bias,
             const float* __restrict__ ln_w, const float* __restrict__ ln_b, int M, int N,
             int C) {
    constexpr int RW = LNG_ROWS_A_WARP;
    unsigned char* smem = lng_smem_base();
    const uint32_t h = smem_u32(smem);
    const uint32_t tiles = h + LNG_BM * C * 2;
    const uint32_t stages = tiles + LNG_STAGES * LNG_STAGE_BYTES;
    const uint32_t full = stages + 2 * lng_out_bytes(2);
    const uint32_t empty = full + 8 * LNG_STAGES, xbar = empty + 8 * LNG_STAGES;
    lng_barriers<LNG_STAGES, 8>(full);
    const int m0 = blockIdx.x * LNG_BM, kb = C / HG_BK, n_tiles = (N + HG_BN - 1) / HG_BN;
    int step = 0;
    if (threadIdx.x >= 256) {
        if (threadIdx.x == 256) {
            const CUtensorMap* maps[3] = {&tma_x, &tma_w, &tma_out};
#pragma unroll
            for (int i = 0; i < 3; ++i)
                asm volatile("prefetch.tensormap [%0];"
                             :: "l"(reinterpret_cast<uint64_t>(maps[i])) : "memory");
            // each consumer warp's rows onto its own barrier
            for (int w = 0; w < 8; ++w)
                lng_load_x(tma_x, h, xbar + 8 * w, LNG_BM, w * RW, RW, C, m0 + w * RW);
            lng_load_w(tma_w, tiles, full, empty, n_tiles, kb);
        }
        return;
    }
    // warpgroup cw normalises and multiplies its own 64 rows, RW a warp
    const int cw = threadIdx.x / 128, warp = threadIdx.x / 32;
    mbar_wait(xbar + 8 * warp, 0);
    lng_normalise<RW>(smem, LNG_BM, C, ln_w, ln_b, warp * RW, min(warp * RW + RW, M - m0));
    unsigned char* stage = smem + (stages - h) + cw * lng_out_bytes(2);
    if (cw == 0)
        lng_publish<1, 128>();
    else
        lng_publish<2, 128>();
    for (int t = 0; t < n_tiles; ++t) {
        float acc[64];
        lng_mma(acc, h + cw * 64 * LNG_ROW_BYTES, LNG_BM * LNG_ROW_BYTES, tiles, full, empty,
                kb, step);
        if (cw == 0)
            lng_store<EPI, 1>(tma_out, bias, stage, acc, m0, t * HG_BN, M, N);
        else
            lng_store<EPI, 2>(tma_out, bias, stage, acc, m0 + 64, t * HG_BN, M, N);
    }
    lng_store_done();
}

}  // namespace
