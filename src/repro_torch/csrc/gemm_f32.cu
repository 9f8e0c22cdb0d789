// Float GEMM with the fused epilogue: x (M, K) @ w (K, N) -> (M, N)
//     out = clip(act(x @ w + bias), -c, c)       act in none/relu/silu/gelu(tanh)
//
// Replaces the float branch of the TPU kernel
// src/repro/kernels/vta_gemm.py::blocked_gemm (body _gemm_kernel), which the
// entry point src/repro/kernels/gemm.py::gemm reaches: f32 accumulation, the
// epilogue applied once to the finished sum, the result rounded to x's type
// (f32, or bf16 round-to-nearest-even). Operands are f32 or bf16, converted
// to f32 on load; bias is optional and of x's type.
//
// Bound on this card: at the sizes the layer tables give (K <= 1024, N <=
// 4096) a 64x64 output tile reads 2*64*K operands for 2*64*64*K operations,
// 32 operations per operand, so the product is bound by operations (f32 on
// the CUDA cores, 67 TFLOP/s) once M*N is large, and by bytes for the thin
// K = 32 layers. The design is the plain tiled SIMT form: a 256-thread block
// owns a 64x64 output tile, stages 16-deep K tiles of x and w in shared
// memory as f32, and each thread keeps 4x4 f32 accumulators in registers
// (rows ty + 16i, columns tx + 16j, so shared-memory reads of w are
// conflict-free and stores of the output are coalesced). Ragged tails are
// guarded, never padded. No TF32: the f32 result keeps f32 rounding.
// bf16 operands whose K and N are multiples of 8 take the tensor-core
// kernel csrc/gemm_bf16_sm90.cu instead (kernels/gemm.py::gemm_route).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ bias, T* __restrict__ out, int M, int N,
            int K, int act, int has_clip, float lo, float hi) {
  __shared__ float as[BK][BM + 4];  // x tile, transposed: as[k][m]
  __shared__ float bs[BK][BN];      // w tile: bs[k][n]
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int t = 0; t < BM * BK / THREADS; ++t) {
      const int e = tid + t * THREADS, r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      as[c][r] = (gm < M && gk < K) ? load(x, (long long)gm * K + gk) : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < BK * BN / THREADS; ++t) {
      const int e = tid + t * THREADS, r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r][c] = (gk < K && gn < N) ? load(w, (long long)gk * N + gn) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      float v = acc[i][j];
      if (bias) v = __fadd_rn(v, load(bias, col));
      v = activate(v, act);
      if (has_clip) v = min_nan(max_nan(v, lo), hi);
      store(out, (long long)row * N + col, v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out, int M,
           int N, int K, int act, int has_clip, float lo, float hi,
           cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), M, N, K, act,
      has_clip, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. bias may be null.
extern "C" int gemm_f32_launch(const void* x, const void* w, const void* bias,
                               void* out, int M, int N, int K, int dtype,
                               int act, int has_clip, float lo, float hi,
                               void* stream) {
  if (M <= 0 || N <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, bias, out, M, N, K, act, has_clip, lo, hi, s);
  return launch<__nv_bfloat16>(x, w, bias, out, M, N, K, act, has_clip, lo, hi, s);
}
