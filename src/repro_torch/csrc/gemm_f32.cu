// Float GEMM with the fused epilogue: x (M, K) @ w (K, N) -> (M, N)
//     out = clip(act(x @ w + bias), -c, c)       act in none/relu/silu/gelu(tanh)
//
// Replaces the float branch of the TPU kernel
// src/repro/kernels/vta_gemm.py::blocked_gemm (body _gemm_kernel), which the
// entry point src/repro/kernels/gemm.py::gemm reaches: f32 accumulation, the
// epilogue applied once to the finished sum, the result rounded to x's type
// (f32, or bf16 round-to-nearest-even). Operands are f32 or bf16, kept in
// their own type in shared memory and widened to f32 on the way to the FMAs;
// bias is optional and of x's type. No TF32: the f32 result keeps f32
// rounding. bf16 operands whose K and N are multiples of 8 take the
// tensor-core kernel csrc/gemm_bf16_sm90.cu instead (kernels/gemm.py::
// gemm_route).
//
// Bound on this card: operations. The layer products (M in the hundreds to
// the hundred thousands, K <= 1024, N <= 1024) do 2MNK FMAs' worth at the
// f32 CUDA-core rate (67 TFLOP/s) against a few MB of operands; only the
// K = 32 and 64 pointwise convs and the M = 8 fc layers are bound by bytes.
// What kept the earlier 64x64 kernel at 16% of the f32 rate was the grid,
// not the arithmetic: a 392 x 1024 product made 112 blocks for 132 SMs, an
// fc layer 16, and each block walked all of K alone with two barriers and
// scalar 4-byte loads per 16-deep K tile. The design:
// - a plan chosen in Python (kernels/gemm.py::gemm_float_plan) gives the
//   output tile, 64x64 (128 threads, 8x4 accumulators each, at most 128
//   registers so that an SM holds 4 blocks) or 16x32 for M <= 16 (32
//   threads, 4x4), and a split count of K that brings the grid (N tiles,
//   M tiles, splits) near 6 blocks an SM where the tiles alone are fewer
//   than 2 an SM. 128x128 and 128x64 tiles (8x8 and 8x4 a thread), 64x32,
//   and 8x8 a thread in 64x64 were slower on these shapes on the H100;
// - x and w tiles of 32-deep K move through a 3-stage cp.async ring in
//   shared memory, in 16-byte copies where the rows allow it (8 or 4 bytes
//   otherwise, element loads for bf16 rows of odd length), zero-filled past
//   M, N and the split's end, so ragged shapes are guarded and never padded
//   in device memory; the next tiles' copies run under the current tile's
//   FMAs, and one barrier a tile guards the ring;
// - the x tile keeps x's row-major layout: consecutive threads copy
//   consecutive 16 bytes (conflict-free stores), and a quarter warp reads
//   one row's 4 K values as one 16-byte load, a broadcast; the w tile is
//   read as 16-byte rows of 4 columns, consecutive threads on consecutive
//   columns (conflict-free);
// - with one split the block applies the epilogue and stores the output;
//   with several, each block stores its f32 partial sums in a workspace
//   (splits, M, N) that the wrapper allocates, and a second kernel
//   (gemm_f32_reduce_launch) sums the splits in order 0, 1, ..., its loads
//   issued 8 splits at a time ahead of the adds, then adds the bias and
//   applies activation and clip once. Nothing is atomic: the same inputs
//   give the same bytes on every run. (A reduction by the last block of
//   each output tile to finish, behind a per-tile counter, saves the second
//   launch but was slower on every split case on the H100: one block
//   walks all the splits of its tile while the rest of the card idles.)
// Split s covers K units of 16 from floor(s * U / S) to floor((s+1) * U /
// S), U = ceil(K / 16), the last ending at K (split_range below;
// kernels/gemm.py::gemm_float_splits computes the same bounds).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

constexpr int BK = 32, STAGES = 3;
constexpr int UNIT = 16;  // splits start on multiples of 16 in K

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? bytes : 0;  // src-size 0: the bytes are zero-filled
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(e[0]), b = __bfloat1622float2(e[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 e[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(e);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// [k0, k1) of split s of S over K (in units of 16; the last ends at K)
__device__ __forceinline__ void split_range(int K, int S, int s, int& k0,
                                            int& k1) {
  const int units = (K + UNIT - 1) / UNIT;
  k0 = (int)((long long)s * units / S) * UNIT;
  k1 = s == S - 1 ? K : (int)((long long)(s + 1) * units / S) * UNIT;
}

// A ROWS x COLS tile of a row-major matrix with row stride ld into shared
// memory, row-major and unpadded: rows past nrows and columns past cend read
// 0. vbytes is the copy width (16, 8 or 4; 0: element by element, for bf16
// rows of odd length); the wrapper guarantees that every copy is aligned.
// The 16-byte width, the common one, has its own unrolled copy loop.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(T* sm, const T* __restrict__ g,
                                          int ld, int r0, int nrows, int c0,
                                          int cend, int vbytes, int tid) {
  if (vbytes == 16) {
    constexpr int CE = 16 / (int)sizeof(T), PER_ROW = COLS / CE;
#pragma unroll
    for (int e = tid; e < ROWS * PER_ROW; e += THREADS) {
      const int r = e / PER_ROW, c = (e % PER_ROW) * CE;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < nrows && gc < cend;
      cp_async(sm + r * COLS + c, ok ? g + (long long)gr * ld + gc : g, 16,
               ok);
    }
  } else if (vbytes > 0) {
    const int ce = vbytes / (int)sizeof(T), per_row = COLS / ce;
    for (int e = tid; e < ROWS * per_row; e += THREADS) {
      const int r = e / per_row, c = (e - r * per_row) * ce;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < nrows && gc < cend;
      cp_async(sm + r * COLS + c, ok ? g + (long long)gr * ld + gc : g,
               vbytes, ok);
    }
  } else {
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS, gr = r0 + r, gc = c0 + c;
      sm[e] = (gr < nrows && gc < cend) ? g[(long long)gr * ld + gc]
                                        : from_float<T>(0.0f);
    }
  }
}

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  void* out;
  float* work;  // (splits, M, N) partial sums, or null for one split
  int M, N, K, splits, vx, vw, act, has_clip;
  float lo, hi;
};

// bias, activation and clip on a finished sum
template <typename T>
__device__ __forceinline__ float finish(float v, const T* bias, int col,
                                        const Args& a) {
  if (bias) v = __fadd_rn(v, load(bias, col));
  v = activate(v, a.act);
  if (a.has_clip) v = min_nan(max_nan(v, a.lo), a.hi);
  return v;
}

// BM x BN output tile, TM x TN accumulators a thread: rows ty*TM + i, and
// TN/4 groups of 4 columns tx*4 + g*4*(BN/TN) + j
template <typename T, int BM, int BN, int TM, int TN, int MINB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
gemm_kernel(Args a) {
  constexpr int TX = BN / TN, THREADS = (BM / TM) * TX;
  constexpr int XS = BM * BK, WS = BK * BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* ws = xs + STAGES * XS;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  int k0, k1;
  split_range(a.K, a.splits, split, k0, k1);
  const int tiles = (k1 - k0 + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  auto fill = [&](int t) {
    const int slot = t % STAGES, kt = k0 + t * BK;
    load_tile<T, BM, BK, THREADS>(xs + slot * XS, x, a.K, m0, a.M, kt, k1,
                                  a.vx, tid);
    load_tile<T, BK, BN, THREADS>(ws + slot * WS, w, a.N, kt, k1, n0, a.N,
                                  a.vw, tid);
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < tiles) fill(t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every thread is done with tile t-1
    if (t + STAGES - 1 < tiles) fill(t + STAGES - 1);
    cp_async_commit();
    const T* xt = xs + (t % STAGES) * XS + ty * TM * BK;
    const T* wt = ws + (t % STAGES) * WS + tx * 4;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float av[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) load4(xt + i * BK + k4, av[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g)
          load4(wt + (k4 + kk) * BN + g * 4 * TX, bv + 4 * g);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  const T* bias = static_cast<const T*>(a.bias);
  T* out = static_cast<T*>(a.out);
  const bool vec = a.N % 4 == 0;
  if (a.splits > 1) {
    // every split stores its partial sums for reduce_kernel
    const long long mn = (long long)a.M * a.N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const int col = n0 + tx * 4 + g * 4 * TX;
        if (row >= a.M || col >= a.N) continue;
        float* p = a.work + split * mn + (long long)row * a.N + col;
        if (vec) {
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                          acc[i][4 * g + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < a.N) p[j] = acc[i][4 * g + j];
        }
      }
    }
    return;  // the reduce kernel sums the splits
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= a.M) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int col = n0 + tx * 4 + g * 4 * TX;
      if (col >= a.N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = col + j < a.N ? finish(acc[i][4 * g + j], bias, col + j, a)
                             : 0.0f;
      const long long o = (long long)row * a.N + col;
      if (vec) {
        store4(out + o, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < a.N) store(out, o + j, v[j]);
      }
    }
  }
}

// out = epilogue(sum over s of work[s]), summed in the order s = 0, 1, ...
template <typename T>
__global__ void __launch_bounds__(256)
reduce_kernel(Args a) {
  const long long mn = (long long)a.M * a.N;
  const long long e = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= mn) return;
  const T* bias = static_cast<const T*>(a.bias);
  T* out = static_cast<T*>(a.out);
  float v[4];
  if (a.N % 4 == 0) {
    for (int s0 = 0; s0 < a.splits; s0 += 8) {
      float q[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (s0 + u < a.splits) load4(a.work + (s0 + u) * mn + e, q[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u >= a.splits) break;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = s0 + u ? __fadd_rn(v[j], q[u][j]) : q[u][j];
      }
    }
    const int col = (int)(e % a.N);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = finish(v[j], bias, col + j, a);
    store4(out + e, v);
    return;
  }
  for (long long i = e; i < e + 4 && i < mn; ++i) {
    float s0 = a.work[i];
    for (int s = 1; s < a.splits; ++s) s0 = __fadd_rn(s0, a.work[s * mn + i]);
    store(out, i, finish(s0, bias, (int)(i % a.N), a));
  }
}

// MINB: blocks an SM must be able to hold (caps the registers a thread)
template <typename T, int BM, int BN, int TM, int TN, int MINB>
int launch_tile(const Args& a, cudaStream_t stream) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int SMEM = STAGES * (BM * BK + BK * BN) * (int)sizeof(T);
  auto kernel = gemm_kernel<T, BM, BN, TM, TN, MINB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((unsigned)((a.N + BN - 1) / BN), (unsigned)((a.M + BM - 1) / BM),
            (unsigned)a.splits);
  kernel<<<grid, THREADS, SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int bm, int bn, cudaStream_t stream) {
  if (bm == 128 && bn == 128)
    return launch_tile<T, 128, 128, 8, 8, 1>(a, stream);
  if (bm == 64 && bn == 64) return launch_tile<T, 64, 64, 8, 4, 4>(a, stream);
  if (bm == 16 && bn == 32) return launch_tile<T, 16, 32, 4, 4, 8>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the widest copy (16, 8 or 4 bytes) that every row start of a matrix with
// rows of row_bytes bytes at p keeps aligned; 0 for element loads
int copy_width(const void* p, long long row_bytes) {
  for (int v = 16; v >= 4; v /= 2)
    if (row_bytes % v == 0 && reinterpret_cast<uintptr_t>(p) % v == 0)
      return v;
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. bias may be null. (bm, bn, splits) is the
// plan of kernels/gemm.py::gemm_float_plan. For splits > 1 the launch writes
// the partial sums to work, (splits, M, N) f32, and leaves bias, act, clip
// and out to gemm_f32_reduce_launch; for one split it writes out.
extern "C" int gemm_f32_launch(const void* x, const void* w, const void* bias,
                               void* out, float* work, int M, int N, int K,
                               int dtype, int act, int has_clip, float lo,
                               float hi, int bm, int bn, int splits,
                               void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || (splits > 1 && (!work || K < UNIT * splits)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  Args a{x, w, bias, out, work, M, N, K, splits,
         copy_width(x, (long long)K * es), copy_width(w, (long long)N * es),
         act, has_clip, lo, hi};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, bm, bn, s);
  return launch<__nv_bfloat16>(a, bm, bn, s);
}

// out (M, N) = clip(act(work[0] + work[1] + ... + bias)), work (splits, M,
// N) f32 from gemm_f32_launch; out and bias of dtype (0 f32, 1 bf16).
extern "C" int gemm_f32_reduce_launch(const float* work, const void* bias,
                                      void* out, int M, int N, int splits,
                                      int dtype, int act, int has_clip,
                                      float lo, float hi, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  Args a{nullptr, nullptr, bias, out, const_cast<float*>(work), M, N, 0,
         splits, 0, 0, act, has_clip, lo, hi};
  const long long quads = ((long long)M * N + 3) / 4;
  const unsigned blocks = (unsigned)((quads + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    reduce_kernel<float><<<blocks, 256, 0, s>>>(a);
  else
    reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
