// NHWC depthwise convolution: x (B, H, W, C), w (KH, KW, C) -> (B, OH, OW, C)
//     out[b, i, j, c] = sum over dy, dx of xpad[b, i*s + dy, j*s + dx, c] * w[dy, dx, c]
//
// Replaces the TPU kernel src/repro/kernels/depthwise.py::depthwise_conv
// (body _dw_kernel): zero padding, KH*KW strided taps in dy-major, dx-minor
// order, f32 accumulation contracted as XLA's CPU build of the reference
// contracts it (its zero seed folded away): fma(x0, w0, x1*w1) for taps 0
// and 1, then fma(x_k, w_k, acc) for each later tap, a bare product for a
// 1x1 window; no bias, result rounded to the input's type (f32 or bf16,
// round-to-nearest-even).
//
// Bound on this card: bytes. 2*KH*KW operations per output against one
// input read and one output write. The earlier design, one thread per output
// element under a capped grid-stride loop, was bound by instructions
// instead: 64-bit divisions for six indices per output, and 9 scalar input
// and 9 scalar weight loads per output, each input element read up to 9
// times through L1/L2. The design now:
// - one block owns an output tile of TH rows x TW columns x CB channels of
//   one image (kernels/depthwise.py::depthwise_plan picks it; CB is 32-128,
//   or all of C below 32); the grid is the tile count, and the block's
//   indices are computed once;
// - the block stages the tile's input halo, ((TH-1)s + KH) x ((TW-1)s + KW)
//   pixels x CB channels, once in shared memory, by one TMA tiled copy:
//   x is a 4-D tensor (C, W, H, B), the halo one box of it, and the box's
//   out-of-bounds elements, which TMA fills with 0, are the zero padding
//   (and the channels past C of a ragged last chunk). One thread issues
//   the copy, an mbarrier counts its bytes, and the other threads stage
//   the KH*KW*CB weights as f32 meanwhile. TMA and not 16-byte cp.async
//   copies: the threads then spend no instructions on the halo's
//   addresses and bounds, and on the H100 the TMA halo was the faster of
//   the two, most of all on the stride-2 layers, whose halo is 4x their
//   output;
// - a thread computes R = 4 outputs along W for V consecutive channels (4
//   in f32, 8 in bf16): per tap row it loads the (R-1)s + KW input columns
//   of its run into registers once and reuses them across dx (for the 3x3
//   layers; other kernel sizes read each tap from shared memory), and
//   writes each output as one 16-byte store;
// - a scalar path inside the same kernel (V = 1) covers C that is not a
//   multiple of the vector width (TMA needs 16-byte pixel strides), and
//   element copies and stores cover pointers that are not 16-byte aligned.
// Each output's taps run in dy-major, dx-minor order through tap_step, by
// __fmul_rn and __fmaf_rn, so nvcc contracts nothing of its own and the
// result equals the plain version's torch.addcmul chain bit for bit.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

constexpr int R = 4;                    // outputs along W a thread
constexpr int MAX_THREADS = 256;
constexpr int SMEM_BUDGET = 48 * 1024;  // kernels/depthwise.py::SMEM_BUDGET

struct Params {
  const void* x;
  const void* w;
  void* out;
  int H, W, C, KH, KW, S, P, OH, OW;
  int TH, TW, CB, tiles_h, tiles_w, chunks, aligned, tma;
};

// V consecutive values as f32: 16-byte shared-memory loads where V > 1
template <int V>
__device__ __forceinline__ void loadv(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    if (V == 1) {
      v[0] = p[0];
    } else {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      v[i] = u.x; v[i + 1] = u.y; v[i + 2] = u.z; v[i + 3] = u.w;
    }
  }
}
template <int V>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* v) {
  if (V == 1) {
    v[0] = __bfloat162float(p[0]);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; i += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      v[i + 2 * j] = f.x;
      v[i + 2 * j + 1] = f.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int V>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float* v) {
#pragma unroll
  for (int i = 0; i < V; i += 8) {
    __nv_bfloat162 e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      e[j] = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
    *reinterpret_cast<uint4*>(p + i) = *reinterpret_cast<const uint4*>(e);
  }
}

__host__ __device__ __forceinline__ int halo_bytes(const Params& p, int es) {
  const int hh = (p.TH - 1) * p.S + p.KH, hw = (p.TW - 1) * p.S + p.KW;
  return (hh * hw * p.CB * es + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}
// the halo box, (CB, HW, HH, 1) of x as (C, W, H, B), by TMA: one thread
// issues it, the mbarrier counts its bytes; out-of-bounds elements are 0
__device__ __forceinline__ void tma_halo(void* dst, const CUtensorMap* map,
                                         int c0, int ix0, int iy0, int b,
                                         uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(ix0), "r"(iy0), "r"(b)
      : "memory");
}
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

// Tap t of one output: tap 0 parks x0 in acc and w0 apart, tap 1 makes
// fma(x0, w0, x1*w1), each later tap fma(x, w, acc)
__device__ __forceinline__ void tap_step(int t, float x, float w, float& acc,
                                         float& w0) {
  if (t == 0) {
    acc = x;
    w0 = w;
  } else if (t == 1) {
    acc = __fmaf_rn(acc, w0, __fmul_rn(x, w));
  } else {
    acc = __fmaf_rn(x, w, acc);
  }
}

// V channels a thread (1: the scalar path); KW_, S_ > 0 fix the kernel
// width and stride at compile time (the 3x3 layers), 0 reads them from p
template <typename T, int V, int KW_, int S_>
__global__ void __launch_bounds__(MAX_THREADS)
depthwise_kernel(const __grid_constant__ CUtensorMap map, Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const int KW = KW_ ? KW_ : p.KW, S = S_ ? S_ : p.S;
  const int HH = (p.TH - 1) * S + p.KH, HW = (p.TW - 1) * S + KW;
  const int CB = p.CB, G = CB / V, NP = p.TH * (p.TW / R);
  // [HH][HW][CB], 128-byte aligned for TMA
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  T* halo = reinterpret_cast<T*>(base);
  float* wsm = reinterpret_cast<float*>(base + halo_bytes(p, sizeof(T)));

  int bid = blockIdx.x;
  const int chunk = bid % p.chunks;
  bid /= p.chunks;
  const int tc = bid % p.tiles_w;
  bid /= p.tiles_w;
  const int tr = bid % p.tiles_h, b = bid / p.tiles_h;
  const int c0 = chunk * CB, cn = min(CB, p.C - c0);
  const int oy0 = tr * p.TH, ox0 = tc * p.TW;
  const int iy0 = oy0 * S - p.P, ix0 = ox0 * S - p.P;
  const T* __restrict__ x =
      static_cast<const T*>(p.x) + (long long)b * p.H * p.W * p.C + c0;
  const int tid = threadIdx.x, g = tid % G, pos = tid / G;
  T zero;
  store(&zero, 0, 0.0f);

  if (V > 1 && p.tma) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      tma_halo(halo, &map, c0, ix0, iy0, b, &bar,
               (unsigned)(HH * HW * CB * sizeof(T)));
    }
  } else {
    // the scalar path: thread (g, pos) copies channel group g of pixels
    // pos, pos + NP, ..., element by element
    int hy = 0, hx = pos;
    while (hx >= HW) hx -= HW, ++hy;
    for (; hy < HH;) {
      const int iy = iy0 + hy, ix = ix0 + hx;
      const bool ok = iy >= 0 && iy < p.H && ix >= 0 && ix < p.W && g * V < cn;
      const int src = (iy * p.W + ix) * p.C + g * V;
      T* dst = halo + (hy * HW + hx) * CB + g * V;
#pragma unroll
      for (int v = 0; v < V; ++v) dst[v] = ok ? x[src + v] : zero;
      hx += NP;
      while (hx >= HW) hx -= HW, ++hy;
    }
  }
  const T* __restrict__ wg = static_cast<const T*>(p.w) + c0;
  for (int e = tid; e < p.KH * KW * CB; e += G * NP) {
    const int t = e / CB, c = e - t * CB;
    wsm[e] = c < cn ? load(wg, (long long)t * p.C + c) : 0.0f;
  }
  __syncthreads();  // the weights, the element copies, the barrier's init
  if (V > 1 && p.tma) mbar_wait(&bar, 0);

  const int py = pos / (p.TW / R), px = pos - py * (p.TW / R);
  const int oy = oy0 + py, ox = ox0 + px * R;
  if (oy >= p.OH || ox >= p.OW || g * V >= cn) return;
  float acc[R][V], w0[V];
  for (int dy = 0; dy < p.KH; ++dy) {
    const T* hrow = halo + ((py * S + dy) * HW + px * R * S) * CB + g * V;
    const float* wrow = wsm + dy * KW * CB + g * V;
    if constexpr (KW_ > 0) {
      constexpr int COLS = (R - 1) * S_ + KW_;
      float xv[COLS][V], wv[KW_][V];
#pragma unroll
      for (int i = 0; i < COLS; ++i) loadv<V>(hrow + i * CB, xv[i]);
#pragma unroll
      for (int dx = 0; dx < KW_; ++dx) loadv<V>(wrow + dx * CB, wv[dx]);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int dx = 0; dx < KW_; ++dx)
#pragma unroll
          for (int v = 0; v < V; ++v)
            tap_step(dy * KW_ + dx, xv[r * S_ + dx][v], wv[dx][v], acc[r][v],
                     w0[v]);
    } else {
      for (int dx = 0; dx < KW; ++dx) {
        float wv[V];
        loadv<V>(wrow + dx * CB, wv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float xv[V];
          loadv<V>(hrow + (r * S + dx) * CB, xv);
#pragma unroll
          for (int v = 0; v < V; ++v)
            tap_step(dy * KW + dx, xv[v], wv[v], acc[r][v], w0[v]);
        }
      }
    }
  }
  if (p.KH * KW == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = __fmul_rn(acc[r][v], w0[v]);
  }
  T* out = static_cast<T*>(p.out) +
           (((long long)b * p.OH + oy) * p.OW + ox) * p.C + c0 + g * V;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (ox + r >= p.OW) break;
    if (V > 1 && p.aligned) {
      storev<V>(out + r * p.C, acc[r]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) store(out, (long long)r * p.C + v, acc[r][v]);
    }
  }
}

template <typename T, int V, int KW_, int S_>
int launch_kernel(const CUtensorMap& map, const Params& p, int blocks,
                  int threads, int smem, cudaStream_t stream) {
  depthwise_kernel<T, V, KW_, S_><<<blocks, threads, smem, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_vec(const CUtensorMap& map, const Params& p, int blocks,
               int threads, int smem, cudaStream_t stream) {
  if (p.KW == 3 && p.S == 1)
    return launch_kernel<T, V, 3, 1>(map, p, blocks, threads, smem, stream);
  if (p.KW == 3 && p.S == 2)
    return launch_kernel<T, V, 3, 2>(map, p, blocks, threads, smem, stream);
  return launch_kernel<T, V, 0, 0>(map, p, blocks, threads, smem, stream);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// x (B, H, W, C) as a 4-D tensor (C, W, H, B) read in (CB, HW, HH, 1)
// boxes; no swizzle, so a box lands as [HH][HW][CB]
bool make_map(CUtensorMap* map, const Params& p, int B, int es, int hh,
              int hw) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)p.C * es,
                                 (cuuint64_t)p.W * p.C * es,
                                 (cuuint64_t)p.H * p.W * p.C * es};
  const cuuint32_t box[4] = {(cuuint32_t)p.CB, (cuuint32_t)hw,
                             (cuuint32_t)hh, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(p.x), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(Params p, int vec, int B, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  if (p.TH < 1 || p.TW < R || p.TW % R || p.CB < 1 || p.CB % vec ||
      (vec != 1 && vec * es != 16) || (vec > 1 && p.C % vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = p.CB / vec * p.TH * (p.TW / R);
  const int smem = 128 + halo_bytes(p, es) + p.KH * p.KW * p.CB * 4;
  if (threads > MAX_THREADS || smem > SMEM_BUDGET)
    return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_h = (p.OH + p.TH - 1) / p.TH;
  p.tiles_w = (p.OW + p.TW - 1) / p.TW;
  p.chunks = (p.C + p.CB - 1) / p.CB;
  const long long blocks = (long long)B * p.tiles_h * p.tiles_w * p.chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map{};
  p.tma = vec > 1 && p.aligned;
  if (p.tma && !make_map(&map, p, B, es, (p.TH - 1) * p.S + p.KH,
                         (p.TW - 1) * p.S + p.KW))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 1)
    return launch_vec<T, 1>(map, p, (int)blocks, threads, smem, stream);
  return launch_vec<T, 16 / sizeof(T)>(map, p, (int)blocks, threads, smem,
                                       stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. (th, tw, cb, vec) is the tile of
// kernels/depthwise.py::depthwise_plan: th x tw outputs (tw a multiple of
// 4) x cb channels a block, vec channels a thread (16 bytes, or 1).
extern "C" int depthwise_launch(const void* x, const void* w, void* out,
                                int B, int H, int W, int C, int KH, int KW,
                                int stride, int pad, int OH, int OW, int dtype,
                                int th, int tw, int cb, int vec,
                                void* stream) {
  if ((long long)B * OH * OW * C <= 0) return 0;
  Params p{x, w, out, H, W, C, KH, KW, stride, pad, OH, OW, th, tw, cb,
           0, 0, 0, aligned16(x) && aligned16(out), 0};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, vec, B, s);
  return launch<__nv_bfloat16>(p, vec, B, s);
}
