// Element helpers shared by the float layer-op kernels (gemm_f32,
// gemm_bf16_sm90, alu, depthwise, pool2d, flash_attention, flash_decode): f32 or
// bf16 storage with f32 arithmetic, max/min that propagate NaN as
// jnp.maximum and torch.maximum do (fmaxf drops it), and the GEMM epilogue's
// activations.
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

// act: 0 none, 1 relu, 2 silu (x * sigmoid(x)), 3 gelu, tanh approximation
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return max_nan(v, 0.0f);
    case 2: return v * (1.0f / (1.0f + expf(-v)));
    case 3: {
      const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
      return v * (0.5f * (1.0f + tanhf(inner)));
    }
    default: return v;
  }
}

}  // namespace float_ops
