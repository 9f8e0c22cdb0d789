// Fused element-wise ALU op on float tensors, the VTA ALU analogue:
//     out = clip(op(x, y or imm) * 2^-shift, lo, hi)        op in add/mul/max/min
//
// Replaces the TPU kernel src/repro/kernels/alu.py::alu (body _alu_kernel).
// Arithmetic is in f32 in the reference's order: the op, then the multiply by
// the power-of-two scale, then the clamp; inputs are f32 or bf16 and the
// result is rounded to the input's type (bf16 round-to-nearest-even). max and
// min propagate NaN as jnp.maximum / torch.maximum do.
//
// Bound on this card: bytes. One or two operands read and one result written
// per element against three f32 operations, far below the ~20 operations per
// byte where the scalar units become the limit. The design is one pass over
// the flattened tensor with a grid-stride loop, consecutive threads on
// consecutive elements (coalesced). Vector loads are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
alu_kernel(const T* __restrict__ x, const T* __restrict__ y,
           T* __restrict__ out, long long n, int op, float imm, float scale,
           int has_clip, float lo, float hi) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float a = load(x, i);
    const float b = y ? load(y, i) : imm;
    float r;
    switch (op) {
      case 0: r = __fadd_rn(a, b); break;
      case 1: r = __fmul_rn(a, b); break;
      case 2: r = max_nan(a, b); break;
      default: r = min_nan(a, b); break;
    }
    r = __fmul_rn(r, scale);
    if (has_clip) r = min_nan(max_nan(r, lo), hi);
    store(out, i, r);
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, long long n, int op,
           float imm, float scale, int has_clip, float lo, float hi,
           cudaStream_t stream) {
  long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond 32 per SM
  alu_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      n, op, imm, scale, has_clip, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. y may be null (immediate operand).
extern "C" int alu_launch(const void* x, const void* y, void* out, long long n,
                          int dtype, int op, float imm, float scale,
                          int has_clip, float lo, float hi, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, out, n, op, imm, scale, has_clip, lo, hi, s);
  return launch<__nv_bfloat16>(x, y, out, n, op, imm, scale, has_clip, lo, hi, s);
}
