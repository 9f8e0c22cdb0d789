// Fused element-wise ALU op on float tensors, the VTA ALU analogue:
//     out = clip(op(x, y or imm) * 2^-shift, lo, hi)        op in add/mul/max/min
//
// Replaces the TPU kernel src/repro/kernels/alu.py::alu (body _alu_kernel).
// Arithmetic is in f32 in the reference's order: the op, then the multiply by
// the power-of-two scale, then the clamp; inputs are f32 or bf16 and the
// result is rounded once to the input's type (bf16 round-to-nearest-even).
// max, min and the clamp propagate NaN and order -0 < +0, as jnp.maximum and
// jnp.minimum do.
//
// Bound on this card: bytes. One or two operands read and one result written
// per element against at most four f32 operations, far below the ~20
// operations per byte where the scalar units become the limit. The design is
// one pass of 16-byte vectors (4 f32 or 8 bf16 values): each thread loads
// UNROLL vectors of x (and of y) before it computes any, so their loads are
// in flight together, and consecutive threads take consecutive vectors. The
// op, the presence of y and the clamp are template parameters, so no element
// branches on them. The grid is one wave of resident blocks at most, sized
// for the element count by kernels/alu.py::alu_plan; a grid-stride loop
// covers the rest. Base pointers need not be 16-byte aligned: the plan's
// scalar head (elements before x's first 16-byte boundary) and tail (the
// count's remainder after the vectors) are done element by element by block
// 0; the wrapper gives y and out x's misalignment. Small tensors stay near
// the per-launch floor whatever the kernel does.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

// threads a block and 16-byte vectors a thread a step, from the build:
// kernels/alu.py::THREADS and UNROLL, which alu_plan sizes the grid with
#if !defined(ALU_THREADS) || !defined(ALU_UNROLL)
#error "ALU_THREADS and ALU_UNROLL come from kernels/alu.py; build through kernels/_build.py"
#endif
constexpr int THREADS = ALU_THREADS;
constexpr int UNROLL = ALU_UNROLL;
static_assert(THREADS >= 32 + 8, "block 0 takes the head and the tail");

template <int OP, bool CLIP>
__device__ __forceinline__ float apply(float a, float b, float scale, float lo, float hi) {
  float r;
  if (OP == 0) r = __fadd_rn(a, b);
  else if (OP == 1) r = __fmul_rn(a, b);
  else if (OP == 2) r = max_ordered(a, b);
  else r = min_ordered(a, b);
  r = __fmul_rn(r, scale);
  if (CLIP) r = min_ordered(max_ordered(r, lo), hi);
  return r;
}

template <typename T, int OP, bool HAS_Y, bool CLIP>
__global__ void __launch_bounds__(THREADS)
alu_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
           long long n, int head, int tail, float imm, float scale, float lo,
           float hi) {
  using V = Vec16<T>;
  const long long nvec = (n - head - tail) / V::N;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  const uint4* yv = reinterpret_cast<const uint4*>(HAS_Y ? y + head : x + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  const long long step = (long long)gridDim.x * THREADS * UNROLL;
  for (long long base = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
       base < nvec; base += step) {
    uint4 xr[UNROLL], yr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i < nvec) {
        xr[u] = __ldg(xv + i);
        if (HAS_Y) yr[u] = __ldg(yv + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * THREADS;
      if (i >= nvec) continue;
      float a[V::N], b[V::N];
      V::unpack(xr[u], a);
      if (HAS_Y) V::unpack(yr[u], b);
#pragma unroll
      for (int e = 0; e < V::N; ++e)
        a[e] = apply<OP, CLIP>(a[e], HAS_Y ? b[e] : imm, scale, lo, hi);
      ov[i] = V::pack(a);
    }
  }
  // the scalar head and tail, fewer than V::N elements each, by block 0
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    long long i = -1;
    if (t < head) i = t;
    else if (t >= 32 && t - 32 < tail) i = n - tail + (t - 32);
    if (i >= 0)
      store(out, i, apply<OP, CLIP>(load(x, i), HAS_Y ? load(y, i) : imm, scale, lo, hi));
  }
}

struct Args {
  const void* x;
  const void* y;
  void* out;
  long long n;
  int head, tail, blocks;
  float imm, scale, lo, hi;
};

template <typename T, int OP, bool HAS_Y, bool CLIP>
int launch(const Args& a, cudaStream_t stream) {
  alu_kernel<T, OP, HAS_Y, CLIP><<<(unsigned)a.blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y), static_cast<T*>(a.out),
      a.n, a.head, a.tail, a.imm, a.scale, a.lo, a.hi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int OP>
int launch_op(const Args& a, int has_clip, cudaStream_t s) {
  if (a.y)
    return has_clip ? launch<T, OP, true, true>(a, s) : launch<T, OP, true, false>(a, s);
  return has_clip ? launch<T, OP, false, true>(a, s) : launch<T, OP, false, false>(a, s);
}

template <typename T>
int launch_type(const Args& a, int op, int has_clip, cudaStream_t s) {
  switch (op) {
    case 0: return launch_op<T, 0>(a, has_clip, s);
    case 1: return launch_op<T, 1>(a, has_clip, s);
    case 2: return launch_op<T, 2>(a, has_clip, s);
    default: return launch_op<T, 3>(a, has_clip, s);
  }
}

bool aligned16(const void* p, long long elems, int itemsize) {
  return (reinterpret_cast<uintptr_t>(p) + (uintptr_t)(elems * itemsize)) % 16 == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; op 0 add, 1 mul, 2 max, 3 min. y may be null
// (immediate operand). (head, blocks, tail) is alu_plan's: head elements
// before x + head is 16-byte aligned (y + head and out + head must be too),
// tail elements after the vectors, each fewer than a 16-byte vector holds.
// Returns a cudaError_t.
extern "C" int alu_launch(const void* x, const void* y, void* out, long long n,
                          int dtype, int op, float imm, float scale,
                          int has_clip, float lo, float hi, int head,
                          int blocks, int tail, void* stream) {
  if (n <= 0) return 0;
  const int itemsize = dtype == 0 ? 4 : 2, vec = 16 / itemsize;
  if (head < 0 || head >= vec ||
      tail < 0 || tail >= vec || head + tail > n || (n - head - tail) % vec ||
      blocks < 1 || op < 0 || op > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n - head - tail > 0 &&
      (!aligned16(x, head, itemsize) || !aligned16(out, head, itemsize) ||
       (y && !aligned16(y, head, itemsize))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{x, y, out, n, head, tail, blocks, imm, scale, lo, hi};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_type<float>(a, op, has_clip, s);
  return launch_type<__nv_bfloat16>(a, op, has_clip, s);
}
