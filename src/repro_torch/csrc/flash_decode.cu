// Split-K attention for decoding (Sq <= 8), f32 or bf16:
//     q (B, H, Sq, D), k and v (B, KV, Sk, D) -> o (B, H, Sq, D)
// in two kernels: flash_decode_kernel writes one partial (m, l, acc) per
// (query row, key chunk), flash_decode_combine merges the chunks of a row.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _fa_kernel) at the decode shape, with its rules: the
// score is (q * scale) . k in f32 with q scaled first; softcap * tanh(s /
// softcap) before the mask (aligned bottom-right); masked scores are -2e38
// and their p is 0; the online softmax m, l, acc per key tile; the output
// acc / max(l, 1e-30), rounded once to the input type. A chunk, or a warp,
// that sees no key keeps m = -2e38, l = 0, acc = 0: merged with weight
// e^{m_i - m} it adds exactly 0 (e^0 * 0 where every part saw nothing), so a
// row that sees no key is exactly 0, as in the reference kernel.
//
// Bound on this card: bytes. One decode step reads the whole K/V cache for
// G * Sq query rows, about 2 * G * Sq operations per byte, far under the
// bf16 ridge, so the design is about moving each byte once at full rate:
// - one block per (batch, kv head, key chunk, slice of RT rows of the GQA
//   group): K and V of the chunk stream once through shared memory for all
//   the group's rows (G = H / KV q-heads times Sq), where one block per
//   q-head would read each kv head G times;
// - the wrapper picks the chunk so that the grid holds about 8 blocks per
//   SM, so all 132 SMs keep loads in flight at any batch;
// - tiles of BK keys move by 16-byte cp.async into a ring of 2-4 stages
//   (as many as 64 KB hold, at least 2), so that two or three blocks share
//   an SM and their warps hide each other's latency (with one block of 8
//   warps an SM, latency, not bytes, set the pace); rows padded so that a
//   quarter warp's 16-byte reads fall on distinct banks;
// - all 8 warps compute, each on BK / 8 keys of a tile: LPK lanes share a
//   key's dot product (a shuffle tree finishes it), then each warp keeps its
//   own online softmax and p v sums in f32 registers (lane l owns columns
//   4l..4l+3 and 4l+128..); at the end the warps' partials are merged in
//   shared memory and written as the block's partial in f32.
// The math is f32 on CUDA cores, with expf and tanhf and the reference's
// separate roundings (__fmul_rn, __fdiv_rn): decoding has no operations to
// spare for the tensor cores to save.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "float_ops.cuh"

namespace {

using namespace float_ops;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -2.0e38f;
constexpr int SMEM_BUDGET = 64 * 1024;  // of the ring

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* part_m;    // (B * H * Sq, chunks)
  float* part_l;    // (B * H * Sq, chunks)
  float* part_acc;  // (B * H * Sq, chunks, D)
  int H, KV, Sq, Sk, D, G, slices;
  int causal, has_window, has_softcap;
  long long window;
  float softcap, scale;
  int kbeg, chunk, chunks;  // chunk c: keys [kbeg + c * chunk, ... + chunk) below Sk
  int stages, row_bytes;          // ring depth, bytes per K or V row in shared memory
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

// 16 bytes of T widened to f32
__device__ __forceinline__ void widen16(const float* p, float* out) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
// four consecutive values widened to f32
__device__ __forceinline__ void widen4(const float* p, float* out) { widen16(p, out); }
__device__ __forceinline__ void widen4(const __nv_bfloat16* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(e[0]), b = __bfloat1622float2(e[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n (0, 1 or 2) committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 2;\n" ::);
}

// RT query rows per block, LPK lanes per key (BK = 8 warps * 32 / LPK keys)
template <typename T, int RT, int LPK>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(Params p) {
  constexpr int KPW = 32 / LPK;  // keys per warp per tile
  constexpr int BK = KPW * WARPS;
  constexpr int VEC = Vec<T>::n;
  const int D = p.D, nchunk = D / VEC, RB = p.row_bytes;
  const int stage_bytes = 2 * BK * RB;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                     // RT x D
  unsigned char* ring = smem + ((RT * D * 4 + 127) / 128) * 128;  // stages x (K, V)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.slices, r0 = (blockIdx.y % p.slices) * RT;
  const int rows = p.G * p.Sq;
  const long long off = (long long)p.Sk - p.Sq;
  const long long kvbase = ((long long)b * p.KV + kvh) * p.Sk * D;
  const T* k = static_cast<const T*>(p.k) + kvbase;
  const T* v = static_cast<const T*>(p.v) + kvbase;

  // the block's rows: the q head and query index of each, and the keys
  // any of them sees within this chunk, [bbeg, bend)
  const long long cbeg = (long long)p.kbeg + (long long)c * p.chunk;
  long long lo = p.Sk, hi = 0;
  for (int r = 0; r < RT; ++r) {
    const int gr = r0 + r;
    if (gr >= rows) break;
    const long long qpos = gr % p.Sq + off;
    lo = min(lo, p.has_window ? max(0LL, qpos - p.window + 1) : 0LL);
    hi = max(hi, p.causal ? qpos + 1 : (long long)p.Sk);
  }
  const long long bbeg = max(cbeg, lo);
  const long long bend = min(cbeg + p.chunk, hi);  // hi <= Sk
  const int ntiles = bend > bbeg ? (int)((bend - bbeg + BK - 1) / BK) : 0;

  for (int e = threadIdx.x; e < RT * D; e += THREADS) {
    const int gr = r0 + e / D;
    float x = 0.0f;
    if (gr < rows) {
      const int h = kvh * p.G + gr / p.Sq, i = gr % p.Sq;
      x = __fmul_rn(load(static_cast<const T*>(p.q),
                         (((long long)b * p.H + h) * p.Sq + i) * D + e % D),
                    p.scale);
    }
    qs[e] = x;
  }

  // one tile: BK rows of K then BK rows of V, 16 bytes a thread at a time
  auto issue = [&](int t) {
    if (t < ntiles) {
      unsigned char* st = ring + (t % p.stages) * stage_bytes;
      const long long j0 = bbeg + (long long)t * BK;
      for (int e = threadIdx.x; e < 2 * BK * nchunk; e += THREADS) {
        const int which = e / (BK * nchunk), rem = e % (BK * nchunk);
        const int r = rem / nchunk, ch = rem % nchunk;
        const long long key = j0 + r;
        const bool ok = key < bend;
        const T* src = (which ? v : k) + (ok ? key : 0) * D + ch * VEC;
        cp_async16(st + which * BK * RB + r * RB + ch * 16, src, ok);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  float m[RT], l[RT], acc[RT][2][4];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][i][j] = 0.0f;
  }
  const int kk = lane / LPK, part = lane % LPK;

  for (int t = 0; t < p.stages - 1; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait(p.stages - 2);
    __syncthreads();  // tile t landed for all; stage (t - 1) consumed
    issue(t + p.stages - 1);
    const unsigned char* st = ring + (t % p.stages) * stage_bytes;
    const long long key = bbeg + (long long)t * BK + warp * KPW + kk;

    // q . k for the lane's key, LPK lanes a key, each on every LPK-th chunk
    float s[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) s[r] = 0.0f;
    const T* krow = reinterpret_cast<const T*>(st + (warp * KPW + kk) * RB);
    for (int ch = part; ch < nchunk; ch += LPK) {
      float kf[VEC];
      widen16(krow + ch * VEC, kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(qs + r * D + ch * VEC);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qv = qr[e];
          s[r] = fmaf(qv.x, kf[4 * e], s[r]);
          s[r] = fmaf(qv.y, kf[4 * e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[4 * e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[4 * e + 3], s[r]);
        }
      }
    }

    // softcap, mask, online softmax; p of the lane's key in s[r]
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
      const int gr = r0 + r;
      const long long qpos = gr % p.Sq + off;
      const bool vis = gr < rows && key < bend && (!p.causal || key <= qpos) &&
                       (!p.has_window || key > qpos - p.window);
      float x = s[r];
      if (p.has_softcap) x = __fmul_rn(p.softcap, tanhf(__fdiv_rn(x, p.softcap)));
      x = vis ? x : NEG_INF;
      float mx = x;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float pv = vis ? expf(x - m_new) : 0.0f;
      float sum = pv;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(fminf(m[r] - m_new, 0.0f));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr), sum);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][i][j] = __fmul_rn(acc[r][i][j], corr);
      s[r] = pv;
    }

    // acc += p v over the warp's KPW keys
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      const T* vrow = reinterpret_cast<const T*>(st + BK * RB + (warp * KPW + j) * RB);
      float vv[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = 4 * (lane + 32 * i);
        if (col < D) widen4(vrow + col, vv[i]);
        else vv[i][0] = vv[i][1] = vv[i][2] = vv[i][3] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j * LPK);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][i][e] = fmaf(pj, vv[i][e], acc[r][i][e]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // the ring is free: it holds the warps' partials now

  float* wm = reinterpret_cast<float*>(ring);  // WARPS x RT
  float* wl = wm + WARPS * RT;                  // WARPS x RT
  float* wacc = wl + WARPS * RT;                // WARPS x RT x D
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wm[warp * RT + r] = m[r];
      wl[warp * RT + r] = l[r];
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 4 * (lane + 32 * i);
      if (col < D)
#pragma unroll
        for (int e = 0; e < 4; ++e) wacc[(warp * RT + r) * D + col + e] = acc[r][i][e];
    }
  __syncthreads();

  for (int e = threadIdx.x; e < RT * D; e += THREADS) {
    const int r = e / D, d = e % D, gr = r0 + r;
    if (gr >= rows) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * RT + r]);
    float a = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(wm[w * RT + r] - mx);
      a = fmaf(f, wacc[(w * RT + r) * D + d], a);
      lsum = fmaf(f, wl[w * RT + r], lsum);
    }
    const int h = kvh * p.G + gr / p.Sq, i = gr % p.Sq;
    const long long row = ((long long)b * p.H + h) * p.Sq + i;
    p.part_acc[(row * p.chunks + c) * D + d] = a;
    if (d == 0) {
      p.part_m[row * p.chunks + c] = mx;
      p.part_l[row * p.chunks + c] = lsum;
    }
  }
}

// one block per output row: out = sum_i e^{m_i - m} acc_i / max(sum_i
// e^{m_i - m} l_i, 1e-30), m = max_i m_i
template <typename T>
__global__ void __launch_bounds__(128)
flash_decode_combine(const float* __restrict__ pm, const float* __restrict__ pl,
                     const float* __restrict__ pacc, T* __restrict__ o, int chunks,
                     int D) {
  const long long row = blockIdx.x;
  const float* m = pm + row * chunks;
  float mx = NEG_INF;
  for (int c = 0; c < chunks; ++c) mx = fmaxf(mx, m[c]);
  float lsum = 0.0f;
  for (int c = 0; c < chunks; ++c) lsum = fmaf(expf(m[c] - mx), pl[row * chunks + c], lsum);
  const float denom = fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.0f;
    for (int c = 0; c < chunks; ++c)
      a = fmaf(expf(m[c] - mx), pacc[(row * chunks + c) * D + d], a);
    store(o, row * D + d, __fdiv_rn(a, denom));
  }
}

// bytes of a K or V row in shared memory for LPK lanes a key: rows start
// LPK * 16 bytes apart modulo 128, so the 128 / (LPK * 16) keys a quarter
// warp reads lie on distinct banks
int row_bytes(int D, int esize, int lpk) {
  const int rb = D * esize, want = (lpk * 16) % 128;
  return rb + ((want - rb % 128) % 128 + 128) % 128;
}

template <typename T, int RT, int LPK>
int launch(Params p, int B, int rb, cudaStream_t stream) {
  constexpr int BK = (32 / LPK) * WARPS;
  const int stage = 2 * BK * rb;
  p.row_bytes = rb;
  p.stages = SMEM_BUDGET / stage < 2 ? 2 : (SMEM_BUDGET / stage > 4 ? 4 : SMEM_BUDGET / stage);
  const size_t ring = (size_t)p.stages * stage;
  const size_t merge = (size_t)WARPS * RT * (p.D + 2) * 4;
  const size_t smem = ((RT * p.D * 4 + 127) / 128) * 128 + (ring > merge ? ring : merge);
  auto kernel = flash_decode_kernel<T, RT, LPK>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((unsigned)p.chunks, (unsigned)(p.KV * p.slices), (unsigned)B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// LPK: 4 lanes a key (64-key tiles) while a tile stage stays within 48 KB,
// else 8 (32-key tiles: f32 rows of more than 96 values)
template <typename T, int RT>
int by_lanes(const Params& p, int B, cudaStream_t s) {
  const int rb4 = row_bytes(p.D, sizeof(T), 4);
  if (2 * 64 * rb4 <= 48 * 1024) return launch<T, RT, 4>(p, B, rb4, s);
  return launch<T, RT, 8>(p, B, row_bytes(p.D, sizeof(T), 8), s);
}

template <typename T>
int by_rows(const Params& p, int rt, int B, cudaStream_t s) {
  switch (rt) {
    case 1: return by_lanes<T, 1>(p, B, s);
    case 2: return by_lanes<T, 2>(p, B, s);
    case 4: return by_lanes<T, 4>(p, B, s);
    default: return by_lanes<T, 8>(p, B, s);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; D a multiple of 8 up to 256; rt (1, 2, 4
// or 8) rows of the GQA group per block; the key chunks [kbeg + c * chunk,
// ...) for c < chunks, clipped to Sk. part_m, part_l: (B * H * Sq,
// chunks) f32; part_acc: (B * H * Sq, chunks, D) f32. Returns a cudaError_t.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, float* part_m, float* part_l,
    float* part_acc, int B, int H, int KV, int Sq, int Sk, int D, int causal,
    int has_window, long long window, int has_softcap, float softcap,
    float scale, int rt, int kbeg, int chunk, int chunks, int dtype,
    void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || B < 1 || Sq < 1 ||
      Sk < 1 || chunks < 1 || chunk < 1 || (rt != 1 && rt != 2 && rt != 4 && rt != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  Params p{q, k, v, part_m, part_l, part_acc, H, KV, Sq, Sk, D, G,
           (G * Sq + rt - 1) / rt, causal, has_window, has_softcap, window,
           softcap, scale, kbeg, chunk, chunks, 0, 0};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? by_rows<float>(p, rt, B, s)
                    : by_rows<__nv_bfloat16>(p, rt, B, s);
}

// o (B * H * Sq rows of D) from the partials above. Returns a cudaError_t.
extern "C" int flash_decode_combine_launch(const float* part_m,
                                           const float* part_l,
                                           const float* part_acc, void* o,
                                           int rows, int chunks, int D,
                                           int dtype, void* stream) {
  if (rows < 1 || chunks < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    flash_decode_combine<float><<<rows, 128, 0, s>>>(
        part_m, part_l, part_acc, static_cast<float*>(o), chunks, D);
  else
    flash_decode_combine<__nv_bfloat16><<<rows, 128, 0, s>>>(
        part_m, part_l, part_acc, static_cast<__nv_bfloat16*>(o), chunks, D);
  return static_cast<int>(cudaGetLastError());
}
