// Element helpers shared by the float layer-op kernels (gemm_f32,
// gemm_bf16_sm90, alu, depthwise, pool2d, flash_attention, flash_decode): f32 or
// bf16 storage with f32 arithmetic, 16-byte vectors of either as f32 values,
// max/min that propagate NaN as jnp.maximum and torch.maximum do (fmaxf drops
// it), and the GEMM epilogue's activations.
#pragma once
#include <cstdint>
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

// max and min for the GEMM epilogues, held to a limit: NaN propagates, and
// a tie of -0 and +0 gives b
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// max and min as jnp.maximum and jnp.minimum, for the kernels held to bits
// (alu, pool2d): NaN propagates (as the canonical NaN), and -0 < +0. PTX's
// max.NaN and min.NaN do both in one instruction (the card's max orders
// -0 < +0), on f32 and on bf16 pairs.
__device__ __forceinline__ float max_ordered(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_ordered(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ uint32_t max_ordered_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// a 16-byte vector as f32 values and back (4 f32 or 8 bf16)
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2i is the low half of word i; widening bf16 is exact
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  // each value rounded once, to nearest even
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

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
