// NHWC pooling with a selectable pad value: x (B, H, W, C) -> (B, OH, OW, C)
//     max: the largest of the k*k taps, padding reads -inf
//     avg: the f32 sum of the k*k taps in tap order, padding reads 0, divided
//          by k*k everywhere (padding counts, as count_include_pad=True)
//
// Replaces the TPU kernel src/repro/kernels/pool2d.py::pool2d (body
// _pool_kernel). Taps run dy-major, dx-minor; the result is rounded to the
// input's type (f32 or bf16, round-to-nearest-even). max propagates NaN as
// torch.maximum does.
//
// Bound on this card: bytes. k*k comparisons or additions per output against
// one read of the input and one write of the output. The design is the same
// as the depthwise kernel's: one thread per output element, channel fastest,
// so every tap is a coalesced row of channels; padding is a bounds check.
// The sum uses __fadd_rn and the division __fdiv_rn, so the result equals the
// plain version (a sequence of tensor adds, then a true division) bit for bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

constexpr int THREADS = 256;

template <typename T, bool MAX>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C,
            int k, int stride, int pad, int OH, int OW, long long total) {
  const long long step = (long long)gridDim.x * THREADS;
  const float fill = MAX ? -CUDART_INF_F : 0.0f;
  for (long long o = (long long)blockIdx.x * THREADS + threadIdx.x; o < total;
       o += step) {
    const int c = (int)(o % C);
    long long r = o / C;
    const int j = (int)(r % OW);
    r /= OW;
    const int i = (int)(r % OH);
    const long long b = r / OH;
    const T* xb = x + b * H * (long long)W * C;
    float acc = fill;
    for (int dy = 0; dy < k; ++dy) {
      const int ih = i * stride - pad + dy;
      const bool row_ok = ih >= 0 && ih < H;
      for (int dx = 0; dx < k; ++dx) {
        const int iw = j * stride - pad + dx;
        const float v = (row_ok && iw >= 0 && iw < W)
                            ? load(xb, ((long long)ih * W + iw) * C + c)
                            : fill;
        if (MAX)
          acc = max_nan(acc, v);
        else
          acc = __fadd_rn(acc, v);
      }
    }
    if (!MAX) acc = __fdiv_rn(acc, (float)(k * k));
    store(out, o, acc);
  }
}

template <typename T, bool MAX>
int launch(const void* x, void* out, int B, int H, int W, int C, int k,
           int stride, int pad, int OH, int OW, cudaStream_t stream) {
  const long long total = (long long)B * OH * OW * C;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  pool_kernel<T, MAX><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, k, stride, pad,
      OH, OW, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; mode: 0 max, 1 avg.
extern "C" int pool2d_launch(const void* x, void* out, int B, int H, int W,
                             int C, int k, int stride, int pad, int OH, int OW,
                             int dtype, int mode, void* stream) {
  if ((long long)B * OH * OW * C <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mode == 0
               ? launch<float, true>(x, out, B, H, W, C, k, stride, pad, OH, OW, s)
               : launch<float, false>(x, out, B, H, W, C, k, stride, pad, OH, OW, s);
  return mode == 0
             ? launch<__nv_bfloat16, true>(x, out, B, H, W, C, k, stride, pad, OH, OW, s)
             : launch<__nv_bfloat16, false>(x, out, B, H, W, C, k, stride, pad, OH, OW, s);
}
