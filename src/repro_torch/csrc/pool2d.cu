// NHWC pooling with a selectable pad value: x (B, H, W, C) -> (B, OH, OW, C)
//     max: the largest of the k*k taps, padding reads -inf; NaN propagates
//          and -0 < +0, as jnp.maximum orders them
//     avg: the f32 sum of the k*k taps in tap order from -0.0, padding reads
//          0, times the f32 reciprocal of k*k everywhere (padding counts, as
//          count_include_pad=True)
//
// Replaces the TPU kernel src/repro/kernels/pool2d.py::pool2d (body
// _pool_kernel), which keeps a whole NHWC block in VMEM and takes each tap as
// a shifted, strided slice of it. Taps run dy-major, dx-minor; the result is
// rounded once to the input's type (f32 or bf16, round-to-nearest-even). The
// sum uses __fadd_rn and the scale __fmul_rn, so the result equals the plain
// version (a sequence of tensor adds, then a multiply) and the reference as
// XLA compiles it (its acc / (k * k) becomes a multiply by the rounded
// reciprocal) bit for bit; -0.0 is IEEE addition's identity, so seeding the
// sum with it is seeding it with the first tap, as the reference does.
//
// Bound on this card: bytes. k*k comparisons or additions per output
// against one read of the input and one write of the output. The design is
// the Hopper form of the TPU's resident block, as the depthwise kernel's:
// - one block owns an output tile of TH rows x TW columns x G channel
//   groups of one image (kernels/pool2d.py::pool_plan picks it); a group is
//   16 bytes of channels (4 f32 or 8 bf16), or one channel on the scalar
//   path (C not a multiple of the vector, or x off a 16-byte boundary);
// - the block stages the tile's input halo, ((TH-1)s + k) x ((TW-1)s + k)
//   pixels x G groups, once in shared memory: every thread issues 16-byte
//   cp.async copies, all in flight together, and writes the mode's pad
//   value itself where a pixel lies outside the image (TMA would fill 0,
//   which is avg's padding but not max's -inf);
// - a thread computes one output group from the halo and stores it as one
//   16-byte vector; the taps are unrolled for the compiled windows (k2 s2,
//   k3 s2, k3 s1 and the 7x7 global pool, whose tiles come from
//   kernels/pool2d.py::POOL_TILES as macros), and a run-time loop takes any
//   other window;
// - max takes PTX max.NaN, one instruction that propagates NaN and orders
//   -0 < +0 as jnp.maximum does; in bf16 on the packed pairs as they lie in
//   shared memory (the max of bf16 values is one of them: nothing to widen
//   or round). A compare-and-select chain on widened values, about five
//   instructions an element, kept the bf16 case bound by issue rather
//   than by bytes;
// - index math is 32-bit from the block's coordinates (the plan's G is a
//   power of two), 64-bit only for an image's base offset;
// - a global pool (one output pixel) gets a tile per (image, channel
//   chunk), the chunks small enough that the grid gives every SM a block:
//   49 copies per group all in flight, where one thread a channel would
//   walk 49 dependent loads.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

// the compiled windows, from the build: kernels/pool2d.py::nvcc_defines()
#if !defined(POOL_THREADS) || !defined(POOL_K2S2_SMEM) || \
    !defined(POOL_K3S2_SMEM) || !defined(POOL_K3S1_SMEM) || !defined(POOL_K7G_SMEM)
#error "the POOL_* macros come from kernels/pool2d.py; build through kernels/_build.py"
#endif
constexpr int THREADS = POOL_THREADS;
constexpr int SMEM_BUDGET = 48 * 1024;  // kernels/pool2d.py::SMEM_BUDGET
constexpr int MAX_SMEM = 232448;        // kernels/pool2d.py::MAX_SMEM

__host__ __device__ constexpr long long halo_bytes(int k, int s, int th, int tw,
                                                   int g, int group_bytes) {
  return (long long)((th - 1) * s + k) * ((tw - 1) * s + k) * g * group_bytes;
}

// a compiled window: k x k at stride S, a TH x TW output tile, at most GMAX
// 16-byte groups a block, whose halo takes SMEM bytes (the plan's number)
template <int K_, int S_, int TH_, int TW_, int GMAX, int SMEM_>
struct Kind {
  static constexpr int K = K_, S = S_, TH = TH_, TW = TW_, SMEM = SMEM_;
  static_assert(halo_bytes(K, S, TH, TW, GMAX, 16) == SMEM,
                "kernels/pool2d.py's shared bytes differ from this layout");
  static_assert(SMEM <= SMEM_BUDGET && TH * TW * GMAX <= THREADS,
                "a compiled tile must fit the budget and the block");
};
#define POOL_KIND(N)                                                      \
  Kind<POOL_##N##_K, POOL_##N##_S, POOL_##N##_TH, POOL_##N##_TW,          \
       POOL_##N##_GMAX, POOL_##N##_SMEM>
using K2S2 = POOL_KIND(K2S2);
using K3S2 = POOL_KIND(K3S2);
using K3S1 = POOL_KIND(K3S1);
using K7G = POOL_KIND(K7G);
// any other window: k, stride and tile at run time
struct Any {
  static constexpr int K = 0, S = 0, TH = 0, TW = 0;
};

struct Params {
  const void* x;
  void* out;
  int H, W, C, k, s, pad, OH, OW;
  int th, tw, lg, tiles_h, tiles_w, chunks;  // lg: log2 of the groups a block
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

constexpr uint32_t BF16X2_NEG_INF = 0xff80ff80u;  // two bf16 -inf

// tap(dy, dx) over the k x k window in dy-major, dx-minor order: unrolled
// for a compiled k (KF > 0), else a loop over the run-time k
template <int KF, class F>
__device__ __forceinline__ void for_taps(int k, F&& tap) {
  if constexpr (KF > 0) {
#pragma unroll
    for (int dy = 0; dy < KF; ++dy)
#pragma unroll
      for (int dx = 0; dx < KF; ++dx) tap(dy, dx);
  } else {
    for (int dy = 0; dy < k; ++dy)
      for (int dx = 0; dx < k; ++dx) tap(dy, dx);
  }
}

// V channels a group (16 bytes, or 1: the scalar path)
template <typename T, int V, bool MAX, class KD>
__global__ void __launch_bounds__(THREADS) pool_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool FIXED = KD::K > 0;
  const int K = FIXED ? KD::K : p.k, S = FIXED ? KD::S : p.s;
  const int TH = FIXED ? KD::TH : p.th, TW = FIXED ? KD::TW : p.tw;
  const int HW = (TW - 1) * S + K, NH = ((TH - 1) * S + K) * HW;
  const int lg = p.lg, G = 1 << lg;
  const float fill = MAX ? -CUDART_INF_F : 0.0f;

  int bid = blockIdx.x;
  const int chunk = bid % p.chunks;
  bid /= p.chunks;
  const int tc = bid % p.tiles_w;
  bid /= p.tiles_w;
  const int tr = bid % p.tiles_h, b = bid / p.tiles_h;
  const int c0 = chunk * G * V, oy0 = tr * TH, ox0 = tc * TW;
  const int iy0 = oy0 * S - p.pad, ix0 = ox0 * S - p.pad;
  const T* __restrict__ x =
      static_cast<const T*>(p.x) + (long long)b * p.H * p.W * p.C;
  T* halo = reinterpret_cast<T*>(smem_raw);  // [halo row][column][group][V]

  // the halo, once: group h = pixel * G + g, each copied by one thread
  for (int h = threadIdx.x; h < (NH << lg); h += blockDim.x) {
    const int g = h & (G - 1), pix = h >> lg;
    const int hy = pix / HW, hx = pix - hy * HW;
    const int iy = iy0 + hy, ix = ix0 + hx, c = c0 + g * V;
    const bool in = (unsigned)iy < (unsigned)p.H &&
                    (unsigned)ix < (unsigned)p.W && c < p.C;
    T* dst = halo + h * V;
    if constexpr (V > 1) {
      if (in) {
        cp_async16(dst, x + (iy * p.W + ix) * p.C + c);
      } else {
        float f[V];
#pragma unroll
        for (int v = 0; v < V; ++v) f[v] = fill;
        *reinterpret_cast<uint4*>(dst) = Vec16<T>::pack(f);
      }
    } else {
      if (in) *dst = x[(iy * p.W + ix) * p.C + c];
      else store(dst, 0, fill);
    }
  }
  if constexpr (V > 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // one output group a thread: output o = pixel * G + g of the tile
  const int o = threadIdx.x;
  if (o >= (TH * TW << lg)) return;
  const int g = o & (G - 1), pix = o >> lg;
  const int py = pix / TW, px = pix - py * TW;
  const int oy = oy0 + py, ox = ox0 + px, c = c0 + g * V;
  if (oy >= p.OH || ox >= p.OW || c >= p.C) return;
  const T* base = halo + (((py * HW + px) * S) << lg) * V + g * V;
  T* out = static_cast<T*>(p.out) + (long long)b * p.OH * p.OW * p.C +
           (oy * p.OW + ox) * p.C + c;
  if constexpr (MAX && V == 8) {
    // bf16 max on the pairs as they lie in shared memory: the max of bf16
    // values is one of them, so nothing is widened or rounded
    uint32_t m[4] = {BF16X2_NEG_INF, BF16X2_NEG_INF, BF16X2_NEG_INF,
                     BF16X2_NEG_INF};
    for_taps<KD::K>(K, [&](int dy, int dx) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          base + (((dy * HW + dx) << lg) * V));
      m[0] = max_ordered_bf16x2(m[0], u.x);
      m[1] = max_ordered_bf16x2(m[1], u.y);
      m[2] = max_ordered_bf16x2(m[2], u.z);
      m[3] = max_ordered_bf16x2(m[3], u.w);
    });
    *reinterpret_cast<uint4*>(out) = make_uint4(m[0], m[1], m[2], m[3]);
    return;
  }
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = MAX ? -CUDART_INF_F : -0.0f;
  for_taps<KD::K>(K, [&](int dy, int dx) {
    const T* src = base + (((dy * HW + dx) << lg) * V);
    float t[V];
    if constexpr (V > 1) {
      Vec16<T>::unpack(*reinterpret_cast<const uint4*>(src), t);
    } else {
      t[0] = load(src, 0);
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc[v] = MAX ? max_ordered(acc[v], t[v]) : __fadd_rn(acc[v], t[v]);
  });
  if (!MAX) {  // XLA's form of the reference's acc / (k * k)
    const float scale = __fdiv_rn(1.0f, (float)(K * K));
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = __fmul_rn(acc[v], scale);
  }
  if constexpr (V > 1) {
    *reinterpret_cast<uint4*>(out) = Vec16<T>::pack(acc);
  } else {
    store(out, 0, acc[0]);
  }
}

struct Plan {
  int kind, th, tw, vec, groups, threads, smem, tiles_h, tiles_w, chunks;
};

template <typename T, int V, bool MAX, class KD>
int launch_kind(const Params& p, const Plan& plan, int blocks,
                cudaStream_t stream) {
  auto kernel = pool_kernel<T, V, MAX, KD>;
  if (plan.smem > SMEM_BUDGET) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, plan.threads, plan.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool MAX>
int launch_mode(const Params& p, const Plan& plan, int blocks,
                cudaStream_t s) {
  switch (plan.kind) {
    case 0: return launch_kind<T, V, MAX, K2S2>(p, plan, blocks, s);
    case 1: return launch_kind<T, V, MAX, K3S2>(p, plan, blocks, s);
    case 2: return launch_kind<T, V, MAX, K3S1>(p, plan, blocks, s);
    case 3: return launch_kind<T, V, MAX, K7G>(p, plan, blocks, s);
    default: return launch_kind<T, V, MAX, Any>(p, plan, blocks, s);
  }
}

template <typename T, int V>
int launch_vec(const Params& p, const Plan& plan, int blocks, int mode,
               cudaStream_t s) {
  return mode == 0 ? launch_mode<T, V, true>(p, plan, blocks, s)
                   : launch_mode<T, V, false>(p, plan, blocks, s);
}

// the grid: B images of tiles_h x tiles_w tiles x chunks
template <typename T>
int launch(const Params& p, const Plan& plan, int blocks, int mode,
           cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (plan.vec == 1) return launch_vec<T, 1>(p, plan, blocks, mode, s);
  if (plan.vec != V) return static_cast<int>(cudaErrorInvalidValue);
  if (p.C % V || reinterpret_cast<uintptr_t>(p.x) % 16 ||
      reinterpret_cast<uintptr_t>(p.out) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_vec<T, V>(p, plan, blocks, mode, s);
}

template <class KD>
bool fits(const Plan& plan, int k, int s) {
  return k == KD::K && s == KD::S && plan.th == KD::TH && plan.tw == KD::TW &&
         plan.smem <= KD::SMEM;
}

// the plan's kind takes this window: a compiled kind its own k, stride and
// tile (k7g one output pixel, at any stride), "any" every window
bool kind_takes(const Plan& plan, int k, int s, int OH, int OW) {
  switch (plan.kind) {
    case 0: return fits<K2S2>(plan, k, s);
    case 1: return fits<K3S2>(plan, k, s);
    case 2: return fits<K3S1>(plan, k, s);
    case 3: return OH == 1 && OW == 1 && fits<K7G>(plan, k, K7G::S);
    case 4: return true;
    default: return false;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; mode: 0 max, 1 avg. (kind, th, tw, vec,
// groups, threads, smem, tiles_h, tiles_w, chunks) is
// kernels/pool2d.py::pool_plan's: kind 0-3 the compiled windows of
// POOL_TILES, 4 any other; groups a power of two. Returns a cudaError_t.
extern "C" int pool2d_launch(const void* x, void* out, int B, int H, int W,
                             int C, int k, int stride, int pad, int OH, int OW,
                             int dtype, int mode, int kind, int th, int tw,
                             int vec, int groups, int threads, int smem,
                             int tiles_h, int tiles_w, int chunks,
                             void* stream) {
  if ((long long)B * OH * OW * C <= 0) return 0;
  const Plan plan{kind, th, tw, vec, groups, threads, smem, tiles_h, tiles_w,
                  chunks};
  const int es = dtype == 0 ? 4 : 2;
  int lg = 0;
  while ((1 << lg) < groups) ++lg;
  const long long cg = (C + vec - 1) / vec;
  const bool ok =
      (dtype == 0 || dtype == 1) && (mode == 0 || mode == 1) && k >= 1 &&
      stride >= 1 && pad >= 0 && th >= 1 && tw >= 1 && vec >= 1 &&
      groups >= 1 && (1 << lg) == groups && threads % 32 == 0 &&
      threads <= THREADS && (long long)th * tw * groups <= threads &&
      kind_takes(plan, k, stride, OH, OW) &&
      smem == halo_bytes(k, stride, th, tw, groups, vec * es) &&
      smem <= MAX_SMEM && tiles_h == (OH + th - 1) / th &&
      tiles_w == (OW + tw - 1) / tw && chunks == (cg + groups - 1) / groups &&
      (long long)H * W * C < (1LL << 31) && (long long)OH * OW * C < (1LL << 31) &&
      (long long)B * tiles_h * tiles_w * chunks < (1LL << 31);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{x, out, H, W, C, k, stride, pad, OH, OW,
                 th, tw, lg, tiles_h, tiles_w, chunks};
  const int blocks = B * tiles_h * tiles_w * chunks;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, plan, blocks, mode, s);
  return launch<__nv_bfloat16>(p, plan, blocks, mode, s);
}
