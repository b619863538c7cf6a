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
// No LayerNorm rides a TMA load: a chain that needs one runs
// launch_ln_fwd_rows first (pair_bwd_common.cuh) and feeds its bf16 rows to
// NT. hg_weight_grad, at the end, is TN with the in-order second pass
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
// The pipeline (hg_gemm_body) is a template on an MMA policy, which says
// what a stage holds and which wgmma consumes it, and an epilogue functor:
// HgBf16 and HgEpilogue here, under hg_gemm_kernel; the int8 policy and the
// dequantising epilogue of hopper_gemm_s8.cuh, under hg_gemm_s8_kernel. One
// launcher (hg_launch) puts either on the persistent grid.
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

// The engine's pipeline, for any MMA policy and epilogue functor (see the
// layouts above; int8 takes NT only). rows x cols is the output's shape (M x
// N, or N x K for TN) and k_len the reduction's length (K, or M for TN); TN
// reduces chunk z over [z * split, z * split + split). A block takes tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of the tiles_x * tiles_y * chunks
// tiles (column tile fastest); the ring's stage and phase run on across its
// tiles. epi(v, m, n, offset, chunk) takes four consecutive columns of row m
// below rows and cols.
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
                epi(v, m, n, (size_t)m * cols + n, chunk);
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

// Launches KERNEL, an instantiation of the engine, on the persistent grid:
// min(n_tiles, the blocks the device holds at once) blocks of HG_THREADS
// with HG_SMEM of shared memory, opted in once per kernel and device.
template <auto KERNEL, class... Args>
cudaError_t hg_launch(int n_tiles, cudaStream_t stream, Args... args) {
    static std::atomic<unsigned long long> smem_set{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(smem_set.load() & bit)) {
        err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   HG_SMEM);
        if (err != cudaSuccess) return err;
        smem_set.fetch_or(bit);
    }
    const int resident = hg_resident_blocks(dev);
    if (resident == 0) return cudaErrorInvalidValue;
    KERNEL<<<min(n_tiles, resident), HG_THREADS, HG_SMEM, stream>>>(args...);
    return cudaGetLastError();
}

// The engine's launch: out = LAYOUT's product of A and W (M token rows, N
// output columns, K the reduction of NT and NN; for TN, A is (M, N), W is
// (M, K) and out HG_TN_SPLITS partial (N, K) fp32 tiles), then EPI with
// bias, R and Z (out_z for EPI_BIAS_GELU_Z). Needs N % 64 == 0 and K % 64 ==
// 0, 16-byte-aligned A and W; any M >= 1. Returns cudaErrorInvalidValue
// when a tensor map cannot be built.
template <int LAYOUT, int EPI>
cudaError_t hg_gemm(const void* A, const void* W, const void* bias, const void* R,
                    const void* Z, void* out, void* out_z, int M, int N, int K,
                    cudaStream_t stream) {
    static_assert((LAYOUT == TN) == (EPI == EPI_PARTIAL), "TN writes partials, and only TN");
    CUtensorMap ta, tb;
    bool ok;
    int rows, cols, k_len, split = 0, chunks = 1;
    if (LAYOUT == TN) {
        ok = tensor_map_2d(&ta, A, N, M, HG_BK) && tensor_map_2d(&tb, W, K, M, HG_BK);
        rows = N, cols = K, k_len = M, split = hg_split_rows(M), chunks = HG_TN_SPLITS;
    } else {
        ok = tensor_map_2d(&ta, A, K, M, HG_BM) &&
             (LAYOUT == NT ? tensor_map_2d(&tb, W, K, N, HG_BN)
                           : tensor_map_2d(&tb, W, N, K, HG_BK));
        rows = M, cols = N, k_len = K;
    }
    if (!ok) return cudaErrorInvalidValue;
    const int tiles_x = (cols + HG_BN - 1) / HG_BN, tiles_y = (rows + HG_BM - 1) / HG_BM;
    const int n_tiles = tiles_x * tiles_y * chunks;
    const HgEpilogue<EPI> epi{static_cast<const bf16*>(bias), static_cast<const bf16*>(R),
                              static_cast<const float*>(Z), out, static_cast<float*>(out_z),
                              (size_t)rows * cols};
    return hg_launch<hg_gemm_kernel<LAYOUT, EPI>>(n_tiles, stream, ta, tb, epi, rows, cols,
                                                  k_len, split, tiles_x, tiles_y, n_tiles);
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

}  // namespace
