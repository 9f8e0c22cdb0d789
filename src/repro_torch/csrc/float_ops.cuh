// Element helpers shared by the float layer-op kernels (gemm_f32, alu,
// depthwise, pool2d): f32 or bf16 storage with f32 arithmetic, and max/min
// that propagate NaN as jnp.maximum and torch.maximum do (fmaxf drops it).
#pragma once
#include <cuda_bf16.h>

namespace float_ops {

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
// bf16 results are rounded once, to nearest even, as .to(torch.bfloat16) does
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

}  // namespace float_ops
