// The Hopper GEMM engine's int8 variant: int8 x int8 -> int32 products for
// NVIDIA Hopper (sm_90a) with the W8A8 tier's dequantising epilogues. The
// W8A8 pair chain (pair_q8_common.cuh's q8_pair_chain: the pair B9 and the
// W8A8 passes of the stream B10) runs its four products on it:
//   out[M, N] = epilogue((A8[M, K] . W8[N, K]^T) * ascale[m] * wscale[n] + bias[n])
// A8 the per-row quantised activations, W8 the per-output-channel quantised
// nn.Linear weight (out, in), both row-major int8, ascale (M,) and wscale
// (N,) fp32: the NT layout of hopper_gemm.cuh, the only one an nn.Linear
// forward needs. Integer wgmma takes both operands K-major from shared
// memory and has no transpose bit, so NT is also its only native form.
//
// Design. hopper_gemm.cuh's pipeline itself (hg_gemm_body, launched by
// hg_launch), under two policies of this file: HgS8, the MMA (a stage is a
// 128 x 128 int8 A tile and a 128 x 128 int8 B tile, since one swizzled
// 128-byte row holds 128 int8 of K as it holds 64 bf16, so the ring's 32 KB
// stages and the matrix descriptors stay the engine's; four m64n128k32 s8
// wgmmas a stage, a k32 step advancing 32 bytes as a bf16 k16 step does; a
// 64 x 128 int32 accumulator a warpgroup, the fp32 engine's register
// pressure), and HgQ8Epilogue, the dequantising epilogue. Rows past M come
// in as zeros from the TMA and the body masks them.
//
// Rounding. Int32 sums are exact in any order, so the product of a given A8
// is one value on every run and on every design. The epilogue takes the
// plain version's order (ops/pair_q8.py qdot_plain) without fused
// multiply-adds: v = ((float)acc * ascale[m]) * wscale[n] + bias[n], then
// + R for Q8_BIAS_RES, one rounding to bf16; Q8_BIAS_GELU_F32 writes fp32
// GELU(v). So for a given A8 the outputs are a plain integer product's with
// the same epilogue (engine_gemm_q8_plain) bit for bit for Q8_BIAS and
// Q8_BIAS_RES; GELU goes through this card's erff. Q8_ACC_S32 writes the
// int32 accumulators themselves, unscaled and unsaturated: the pair on
// shards (B9_tp) sums them over the model ranks, exactly, and dequantises
// the sum with Q8_BIAS_RES's operations (q8_dequant4, in pair_q8_common.cuh's
// row passes). B9_tp's fc1 takes Q8_BIAS_GELU_F32 with AMAX: the epilogue
// also takes each row's max |act|, which the next quantiser needs, so no
// pass re-reads the fp32 activation for it (HgQ8Epilogue).
//
// Bound. At the W8A8 pair's shapes (K 512 or 1024) an int8 product does
// about 2K operations for every byte of its bf16 output, below the ~590
// operations a byte at which the H100's int8 peak (1,979 TOP/s) outruns its
// memory (3.35 TB/s): each launch alone is bound by its own output and
// operand bytes (the pair as a function, which keeps them inside, is bound
// by operations; pair_q8_kernels.cu). Measured rates are in PERF.md.
//
// Everything is in an anonymous namespace, like the other headers.

#pragma once

#include "hopper_gemm.cuh"

namespace {

enum Q8Epilogue {
    Q8_BIAS = 0,          // bf16(deq + bias)
    Q8_BIAS_RES = 1,      // bf16(deq + bias + R)
    Q8_BIAS_GELU_F32 = 2, // fp32 GELU(deq + bias)
    Q8_ACC_S32 = 3        // the int32 accumulator itself (a row-parallel partial)
};

// d[64 x 128] += A[64 x 32] . B[32 x 128], s8 operands K-major from shared
// memory, s32 accumulator
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// The int8 MMA policy of hg_gemm_body (see HgBf16): K-major operands only.
struct HgS8 {
    using Acc = int;
    static constexpr int BK = 128;
    static __device__ __forceinline__ void fence(int (&d)[64]) {
#pragma unroll
        for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
    }
    template <bool A_MN, bool B_MN>
    static __device__ __forceinline__ void stage(int (&d)[64], uint32_t a, uint32_t b) {
        static_assert(!A_MN && !B_MN, "integer wgmma has no transpose bit");
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
            wgmma_m64n128k32_s8(d, wgmma_desc(a + kk * 32, false), wgmma_desc(b + kk * 32, false));
    }
};
static_assert(HG_BM * HgS8::BK + HG_BN * HgS8::BK == HG_STAGE_BYTES,
              "an int8 stage holds the bf16 engine's bytes");

// The dequantise of one sum: ((float)acc * as) * ws + b, one fp32 rounding
// a step (no fused multiply-add).
__device__ __forceinline__ float q8_deq(int acc, float as, float ws, float b) {
    return __fadd_rn(__fmul_rn(__fmul_rn((float)acc, as), ws), b);
}

// The dequantise of four consecutive columns n..n+3 of one output row (o
// the first's offset, as its row scale): v = ((float)acc * as) * wscale[n] +
// bias[n], then + R for Q8_BIAS_RES, each step one fp32 rounding (see the
// note above); 8- and 16-byte loads.
template <int EPI>
__device__ __forceinline__ void q8_dequant4(const int (&acc)[4], float as, size_t o, int n,
                                            const float* __restrict__ wscale,
                                            const bf16* __restrict__ bias,
                                            const bf16* __restrict__ R, float (&v)[4]) {
    const float4 ws = __ldg(reinterpret_cast<const float4*>(wscale + n));
    const uint2 braw = __ldg(reinterpret_cast<const uint2*>(bias + n));
    const float2 b01 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&braw.x));
    const float2 b23 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&braw.y));
    v[0] = q8_deq(acc[0], as, ws.x, b01.x);
    v[1] = q8_deq(acc[1], as, ws.y, b01.y);
    v[2] = q8_deq(acc[2], as, ws.z, b23.x);
    v[3] = q8_deq(acc[3], as, ws.w, b23.y);
    if (EPI == Q8_BIAS_RES) {
        const uint2 rraw = __ldg(reinterpret_cast<const uint2*>(R + o));
        const float2 r01 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&rraw.x));
        const float2 r23 = __bfloat1622float2(*reinterpret_cast<const bf162*>(&rraw.y));
        v[0] = __fadd_rn(v[0], r01.x);
        v[1] = __fadd_rn(v[1], r01.y);
        v[2] = __fadd_rn(v[2], r23.x);
        v[3] = __fadd_rn(v[3], r23.y);
    }
}

// The dequantising epilogue of four consecutive columns n..n+3 of one output
// row: q8_dequant4, then the GELU or the rounding to bf16, and the store.
// Returns the largest |value| written for Q8_BIAS_GELU_F32 (the row maxima of
// the pair on shards), 0 otherwise.
template <int EPI>
__device__ __forceinline__ float q8_epilogue4(const int (&acc)[4], float as, size_t o, int n,
                                              const float* __restrict__ wscale,
                                              const bf16* __restrict__ bias,
                                              const bf16* __restrict__ R,
                                              void* __restrict__ out) {
    if (EPI == Q8_ACC_S32) {
        *reinterpret_cast<int4*>(static_cast<int*>(out) + o) =
            make_int4(acc[0], acc[1], acc[2], acc[3]);
        return 0.f;
    }
    float v[4];
    q8_dequant4<EPI>(acc, as, o, n, wscale, bias, R, v);
    if (EPI == Q8_BIAS_GELU_F32) {
        const float4 g = make_float4(gelu(v[0]), gelu(v[1]), gelu(v[2]), gelu(v[3]));
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = g;
        return fmaxf(fmaxf(fabsf(g.x), fabsf(g.y)), fmaxf(fabsf(g.z), fabsf(g.w)));
    }
    const bf162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + o) = packed;
    return 0.f;
}

// The dequantising epilogue functor of hg_gemm_body. With AMAX (taken only
// with Q8_BIAS_GELU_F32: B9_tp's fc1) it also folds each row's max |act|
// over the tile's columns (hg_gemm_body takes it) into amax[m], zeroed by
// the caller, with one atomicMax on the float's bits a row and tile:
// non-negative floats order as their bit patterns, and a maximum is exact in
// any order, so the bits repeat.
template <int EPI, bool AMAX = false>
struct HgQ8Epilogue {
    static_assert(!AMAX || EPI == Q8_BIAS_GELU_F32, "row maxima of the fp32 activation only");
    static constexpr bool ROW_AMAX = AMAX;
    const float* ascale;
    const float* wscale;
    const bf16* bias;
    const bf16* R;
    void* out;
    float* amax;
    __device__ __forceinline__ float operator()(const int (&v)[4], int m, int n, size_t o,
                                                int) const {
        return q8_epilogue4<EPI>(v, EPI == Q8_ACC_S32 ? 0.f : __ldg(ascale + m), o, n, wscale,
                                 bias, R, out);
    }
    __device__ __forceinline__ void row_amax(float v, int m) const {
        atomicMax(reinterpret_cast<int*>(amax) + m, __float_as_int(v));
    }
};

// The int8 engine's kernel: hg_gemm_body, NT, under HgS8.
template <int EPI, bool AMAX>
__global__ void __launch_bounds__(HG_THREADS, HG_MIN_BLOCKS)
hg_gemm_s8_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  const __grid_constant__ HgQ8Epilogue<EPI, AMAX> epi, int rows, int cols,
                  int k_len, int split, int tiles_x, int tiles_y, int n_tiles) {
    hg_gemm_body<NT, HgS8>(tma_a, tma_b, epi, rows, cols, k_len, split, tiles_x, tiles_y,
                           n_tiles);
}

// The int8 engine's launch: out = EPI of A8 (M, K) . W8 (N, K)^T with the
// row scales ascale (M,), the column scales wscale (N,), bias (N,) bf16 and,
// for Q8_BIAS_RES, R (M, N) bf16; Q8_ACC_S32 reads none of the four and
// writes int32 out. With AMAX (Q8_BIAS_GELU_F32 only) also each row's max
// |out| into amax (M,) fp32, which the caller zeroes. Needs N % 64 == 0, K %
// 64 == 0, M >= 1, 16-byte-aligned A8, W8, wscale, bias and R; returns
// cudaErrorInvalidValue otherwise (a tensor map that cannot be built
// included).
template <int EPI, bool AMAX = false>
cudaError_t hg_gemm_s8(const void* A, const void* ascale, const void* W, const void* wscale,
                       const void* bias, const void* R, void* out, int M, int N, int K,
                       cudaStream_t stream, float* amax = nullptr) {
    if (M < 1 || N % 64 || K % 64 || AMAX != (amax != nullptr)) return cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    if (!tensor_map_rows(&ta, A, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, M, HG_BM) ||
        !tensor_map_rows(&tb, W, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, HG_BN))
        return cudaErrorInvalidValue;
    const int tiles_x = (N + HG_BN - 1) / HG_BN, tiles_y = (M + HG_BM - 1) / HG_BM;
    const HgQ8Epilogue<EPI, AMAX> epi{static_cast<const float*>(ascale),
                                      static_cast<const float*>(wscale),
                                      static_cast<const bf16*>(bias),
                                      static_cast<const bf16*>(R), out, amax};
    return hg_launch<hg_gemm_s8_kernel<EPI, AMAX>>(tiles_x * tiles_y, stream, ta, tb, epi, M,
                                                   N, K, 0, tiles_x, tiles_y,
                                                   tiles_x * tiles_y);
}

}  // namespace
