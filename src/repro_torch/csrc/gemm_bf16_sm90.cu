// bf16 GEMM with the fused epilogue on Hopper's tensor cores:
//     out = clip(act(x @ w + bias), -c, c)      x (M, K), w (K, N), bf16
// act in none/relu/silu/gelu(tanh); f32 accumulation; bf16 result.
//
// Replaces, for bf16 operands with K % 8 == 0 and N % 8 == 0, the float
// branch of the TPU kernel src/repro/kernels/vta_gemm.py::blocked_gemm (body
// _gemm_kernel), which src/repro/kernels/gemm.py::gemm reaches: the products
// of bf16 values are exact in f32 and the sums stay f32, so only their order
// differs from the reference; the epilogue is applied once to the finished
// sum (float_ops.cuh::activate, as csrc/gemm_f32.cu does) and the result is
// rounded once, to nearest even.
//
// Bound on this card: at the layer shapes (K = 1024, M and N in the
// thousands) each 128 x 128 output tile does 64 operations per operand byte,
// so large products are bound by the tensor cores (989 TFLOP/s bf16) and
// thin ones (M = 8) by the bytes of w. Design, the usual Hopper shape:
// - a block owns a 128 x 128 output tile; two consumer warpgroups each run
//   wgmma.mma_async m64n128k16 on 64 of its rows, A and B both read from
//   shared memory through matrix descriptors (128-byte swizzle);
// - a ring of 4 stages of 64-deep K tiles is filled by TMA from one
//   producer warp: x's tile as one (64 K x 128 M) box, K-major; w's as two
//   (64 N x 64 K) boxes, N-major (w is (K, N) row-major, so B is MN-major:
//   the descriptor's transpose bit says so, with the 8-row K groups 1024
//   bytes apart and the two 64-wide N halves 8192 bytes apart);
// - mbarrier pairs: "full" completes when a stage's bytes land (expect_tx),
//   "empty" when all 8 consumer warps have finished with it;
// - TMA zero-fills every box element past M, K or N, so ragged tails add 0
//   to the sums; the epilogue masks rows past M and columns past N and
//   stores bf16 pairs from the accumulator fragments.
// TMA needs 16-byte row strides (K % 8 == 0 for x, N % 8 == 0 for w) and
// 16-byte aligned bases; the wrapper routes any other bf16 shape to
// csrc/gemm_f32.cu. The tensor maps are encoded on the host through
// cuTensorMapEncodeTiled, reached by cudaGetDriverEntryPoint so the library
// needs no -lcuda.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                        // warpgroups, 64 rows each
constexpr int THREADS = 128 * CONSUMERS + 32;       // and one producer warp
constexpr int A_BYTES = BM * BK * 2;                // 16 KB
constexpr int B_HALF = BK * 64 * 2;                 // one 64 x 64 box, 8 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF;   // 32 KB
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

struct Epilogue {
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  int M, N, K, act, has_clip;
  float lo, hi;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// d (64 x 128 f32 fragment) += A (64 x 16, K-major) * B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned stages
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ktiles = (ep.K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(st, &map_x, kt * BK, m0, &full[s]);
        tma_load(st + A_BYTES, &map_w, n0, kt * BK, &full[s]);
        tma_load(st + A_BYTES + B_HALF, &map_w, n0 + 64, kt * BK, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  const int wg = warp / 4;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* st = smem + s * STAGE_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: rows 8 apart by 128 bytes (8-row groups 1024 apart), k step 32
      // bytes within the swizzled row; B: 16 K rows of 128 bytes a step
      const uint64_t da = desc(st + wg * 64 * 128 + kk * 32, 0, 1024);
      const uint64_t db = desc(st + A_BYTES + kk * 16 * 128, B_HALF, 1024);
      wgmma_m64n128k16(d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: fragment j covers columns 8j + 2 (lane % 4) + {0, 1} of rows
  // 16 (warp % 4) + lane / 4 and + 8
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= ep.N) continue;  // N % 8 == 0: col + 1 < N as well
    float b0 = 0.0f, b1 = 0.0f;
    if (ep.bias) {
      b0 = __bfloat162float(ep.bias[col]);
      b1 = __bfloat162float(ep.bias[col + 1]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      if (r >= ep.M) continue;
      float v0 = d[4 * j + 2 * half], v1 = d[4 * j + 2 * half + 1];
      if (ep.bias) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      v0 = activate(v0, ep.act);
      v1 = activate(v1, ep.act);
      if (ep.has_clip) {
        v0 = min_nan(max_nan(v0, ep.lo), ep.hi);
        v1 = min_nan(max_nan(v1, ep.lo), ep.hi);
      }
      *reinterpret_cast<__nv_bfloat162*>(ep.out + (long long)r * ep.N + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a row-major (rows, cols) bf16 matrix read in (box_cols x box_rows) boxes
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
              int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// bf16 x (M, K), w (K, N), bias (N,) or null, out (M, N); K % 8 == 0,
// N % 8 == 0, x and w 16-byte aligned. act: 0 none, 1 relu, 2 silu, 3 gelu.
// Returns a cudaError_t.
extern "C" int gemm_bf16_launch(const void* x, const void* w, const void* bias, void* out,
                                int M, int N, int K, int act, int has_clip, float lo,
                                float hi, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, M, K, BK, BM) || !make_map(&map_w, w, K, N, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(gemm_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  Epilogue ep{static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
              M, N, K, act, has_clip, lo, hi};
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_bf16_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(map_x, map_w,
                                                                                ep);
  return static_cast<int>(cudaGetLastError());
}
