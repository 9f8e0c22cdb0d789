// NHWC depthwise convolution: x (B, H, W, C), w (KH, KW, C) -> (B, OH, OW, C)
//     out[b, i, j, c] = sum over dy, dx of xpad[b, i*s + dy, j*s + dx, c] * w[dy, dx, c]
//
// Replaces the TPU kernel src/repro/kernels/depthwise.py::depthwise_conv
// (body _dw_kernel): zero padding, KH*KW strided taps, f32 accumulation
// starting from 0 in dy-major, dx-minor order, no bias, result rounded to the
// input's type (f32 or bf16, round-to-nearest-even).
//
// Bound on this card: bytes. 2*KH*KW operations per output against one input
// read (each input element feeds at most KH*KW outputs, mostly from L1/L2)
// and one output write. The design is one thread per output element with the
// channel fastest, so a warp reads 32 consecutive channels of one pixel
// (coalesced) and each weight tap is a coalesced row. Padding is a bounds
// check, not a padded copy: an out-of-range tap reads 0 and is accumulated
// like any other. Each tap is __fmul_rn then __fadd_rn, so nvcc cannot
// contract them into an FMA, and the result equals the plain version's
// separate multiply and add bit for bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int H, int W, int C, int KH, int KW,
                 int stride, int pad, int OH, int OW, long long total) {
  const long long step = (long long)gridDim.x * THREADS;
  for (long long o = (long long)blockIdx.x * THREADS + threadIdx.x; o < total;
       o += step) {
    const int c = (int)(o % C);
    long long r = o / C;
    const int j = (int)(r % OW);
    r /= OW;
    const int i = (int)(r % OH);
    const long long b = r / OH;
    const T* xb = x + b * H * (long long)W * C;
    float acc = 0.0f;
    for (int dy = 0; dy < KH; ++dy) {
      const int ih = i * stride - pad + dy;
      const bool row_ok = ih >= 0 && ih < H;
      for (int dx = 0; dx < KW; ++dx) {
        const int iw = j * stride - pad + dx;
        const float v = (row_ok && iw >= 0 && iw < W)
                            ? load(xb, ((long long)ih * W + iw) * C + c)
                            : 0.0f;
        const float wt = load(w, ((long long)dy * KW + dx) * C + c);
        acc = __fadd_rn(acc, __fmul_rn(v, wt));
      }
    }
    store(out, o, acc);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int H, int W, int C,
           int KH, int KW, int stride, int pad, int OH, int OW,
           cudaStream_t stream) {
  const long long total = (long long)B * OH * OW * C;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  depthwise_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      H, W, C, KH, KW, stride, pad, OH, OW, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.
extern "C" int depthwise_launch(const void* x, const void* w, void* out,
                                int B, int H, int W, int C, int KH, int KW,
                                int stride, int pad, int OH, int OW, int dtype,
                                void* stream) {
  if ((long long)B * OH * OW * C <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, out, B, H, W, C, KH, KW, stride, pad, OH, OW, s);
  return launch<__nv_bfloat16>(x, w, out, B, H, W, C, KH, KW, stride, pad, OH,
                               OW, s);
}
