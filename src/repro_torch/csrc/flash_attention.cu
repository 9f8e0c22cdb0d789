// Online-softmax attention with GQA, a causal and/or sliding-window mask
// aligned bottom-right, and a logit softcap:
//     q (B, H, Sq, D), k and v (B, KV, Sk, D) -> o (B, H, Sq, D)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _fa_kernel) and keeps its rules: the score is
// (q * scale) . k in f32 with q scaled first; softcap * tanh(s / softcap)
// before the mask; masked scores are -2e38; per key tile m_new = max(m,
// rowmax s), p = exp(s - m_new) zeroed where masked, corr = exp(min(m -
// m_new, 0)), l = l * corr + rowsum p, acc = acc * corr + p v; the output is
// acc / max(l, 1e-30), rounded once to the input type. A row that sees no key
// ends with l = 0 and acc = 0, so it is 0, as in the reference kernel.
//
// It serves the f32 prefill route (Sq > 8) of kernels/flash_attention.py:
// TF32 tensor cores would round q and k to 10 mantissa bits, which the f32
// limit of chip_smoke.py phase 5 rules out.
//
// Bound on this card: the 4*D operations per visible (query, key) pair, at
// the f32 rate of the CUDA cores. The kernel is SIMT f32 and simple: one
// block of 8 warps per (q tile, head, batch), the heaviest causal tiles
// launched first. The scaled q tile sits in shared memory; K and V stream
// through shared memory one tile of BK keys at a time. Each warp owns RPW
// query rows: its lanes hold the scores of BK/32 keys each for those rows,
// take the row max and sum with shuffles, write the probabilities to the
// warp's own slice of shared memory, and accumulate p v into registers, lane
// l owning columns l, l + 32, ... Key tiles wholly outside the causal or
// window range are skipped, by the block and by each warp: such a tile has
// m_cur = -2e38 and p = 0, so visiting it changes nothing. Keys at or past
// Sk count as masked; rows at or past Sq are never stored. No fast math:
// expf and tanhf, and q * scale, s / softcap, softcap * t and the final
// division each round on their own, as the reference's separate steps do.
// Element offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 8;            // query rows a warp
constexpr int BQ = RPW * WARPS;   // query rows a block
constexpr float NEG_INF = -2.0e38f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int H, KV, Sq, Sk, D;
  int causal, has_window, has_softcap;
  long long window;
  float softcap, scale;
};

// the scaled q tile, the warps' probabilities, a K tile and a V tile; a K
// row is padded by one element: a row stride of an odd number of words keeps
// the lanes' reads of 32 different keys on 32 different banks
size_t smem_bytes(int bk, int D) {
  return (size_t)BQ * D * 4 + (size_t)BQ * bk * 4 + (size_t)bk * (D + 1) * 4 +
         (size_t)bk * D * 4;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// KPL keys per lane (BK = 32 * KPL), DC columns per lane (D <= 32 * DC)
template <int KPL, int DC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(Params p) {
  constexpr int BK = KPL * 32;
  const int D = p.D, KS = D + 1;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // BQ x D, scaled
  float* ps = qs + BQ * D;                      // WARPS x RPW x BK
  float* ks = ps + BQ * BK;                     // BK x KS
  float* vs = ks + BK * KS;                     // BK x D

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const long long qbase = ((long long)b * p.H + h) * p.Sq * D;
  const long long kvbase = ((long long)b * p.KV + kvh) * p.Sk * D;
  const float* q = p.q + qbase;
  const float* k = p.k + kvbase;
  const float* v = p.v + kvbase;
  const long long off = (long long)p.Sk - p.Sq;

  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int row = q0 + e / D;
    qs[e] = row < p.Sq ? __fmul_rn(q[(long long)row * D + e % D], p.scale) : 0.0f;
  }

  // keys the block's rows can see, [kbeg, kend), and the warp's own range
  const long long rlast = (long long)min(q0 + BQ, p.Sq) - 1;
  long long kbeg = 0, kend = p.Sk;
  if (p.causal) kend = min(kend, rlast + off + 1);
  if (p.has_window) kbeg = max(kbeg, q0 + off - p.window + 1);
  const int w0 = q0 + warp * RPW;
  const bool has_rows = w0 < p.Sq;
  long long wbeg = 0, wend = p.Sk;
  if (p.causal) wend = min(wend, (long long)min(w0 + RPW, p.Sq) - 1 + off + 1);
  if (p.has_window) wbeg = max(wbeg, w0 + off - p.window + 1);

  float acc[RPW][DC], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DC; ++i) acc[r][i] = 0.0f;
  }
  const float* qw = qs + warp * RPW * D;
  float* pw = ps + warp * RPW * BK;

  for (long long j0 = kbeg < kend ? (kbeg / BK) * BK : kend; j0 < kend;
       j0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs written)
    for (int e = threadIdx.x * 4; e < BK * D; e += THREADS * 4) {
      const int r = e / D, c = e % D;
      float4 ku{}, vu{};  // keys past Sk: zeros, masked below (0 * v stays 0)
      if (j0 + r < p.Sk) {
        const long long g = (j0 + r) * D + c;
        ku = *reinterpret_cast<const float4*>(k + g);
        vu = *reinterpret_cast<const float4*>(v + g);
      }
      float* kd = ks + r * KS + c;
      kd[0] = ku.x; kd[1] = ku.y; kd[2] = ku.z; kd[3] = ku.w;
      *reinterpret_cast<float4*>(vs + r * D + c) = vu;
    }
    __syncthreads();
    if (!has_rows || j0 >= wend || j0 + BK <= wbeg) continue;

    // scores of the warp's RPW rows against the lane's KPL keys
    float s[RPW][KPL];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < KPL; ++c) s[r][c] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      float kv[4][KPL];
#pragma unroll
      for (int c = 0; c < KPL; ++c)
#pragma unroll
        for (int t = 0; t < 4; ++t) kv[t][c] = ks[(lane + 32 * c) * KS + d + t];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + d);
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          s[r][c] = fmaf(qv.x, kv[0][c], s[r][c]);
          s[r][c] = fmaf(qv.y, kv[1][c], s[r][c]);
          s[r][c] = fmaf(qv.z, kv[2][c], s[r][c]);
          s[r][c] = fmaf(qv.w, kv[3][c], s[r][c]);
        }
      }
    }

    // softcap, mask, online softmax; probabilities to the warp's slice
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const long long qpos = (long long)w0 + r + off;
      bool vis[KPL];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const long long key = j0 + lane + 32 * c;
        float x = s[r][c];
        if (p.has_softcap)
          x = __fmul_rn(p.softcap, tanhf(__fdiv_rn(x, p.softcap)));
        vis[c] = key < p.Sk && (!p.causal || key <= qpos) &&
                 (!p.has_window || key > qpos - p.window);
        s[r][c] = vis[c] ? x : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const float pv = vis[c] ? expf(s[r][c] - m_new) : 0.0f;
        pw[r * BK + lane + 32 * c] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      const float corr = expf(fminf(m[r] - m_new, 0.0f));
      l[r] = __fadd_rn(__fmul_rn(l[r], corr), sum);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DC; ++i) acc[r][i] = __fmul_rn(acc[r][i], corr);
    }
    __syncwarp();

    // acc += p v, four keys at a time
    for (int jj = 0; jj < BK; jj += 4) {
      float vv[4][DC];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          const int col = lane + 32 * i;
          vv[t][i] = col < D ? vs[(jj + t) * D + col] : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(pw + r * BK + jj);
#pragma unroll
        for (int i = 0; i < DC; ++i) {
          acc[r][i] = fmaf(pr.x, vv[0][i], acc[r][i]);
          acc[r][i] = fmaf(pr.y, vv[1][i], acc[r][i]);
          acc[r][i] = fmaf(pr.z, vv[2][i], acc[r][i]);
          acc[r][i] = fmaf(pr.w, vv[3][i], acc[r][i]);
        }
      }
    }
  }

  float* o = p.o + qbase;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = w0 + r;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int col = lane + 32 * i;
      if (col < D) o[(long long)row * D + col] = __fdiv_rn(acc[r][i], denom);
    }
  }
}

template <int KPL, int DC>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(KPL * 32, p.D);
  auto kernel = flash_attention_kernel<KPL, DC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)p.H, (unsigned)B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 only, Sq > 8; D a multiple of 8 up to 256. The tile is picked here
// from D: BK = 32 * KPL keys, 64, or 32 where a 64-key tile of rows of more
// than 128 values would pass 32 KB. At D = 128 smem_bytes is 114,944 bytes,
// so two blocks share an SM. Returns a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, int causal, int has_window,
    long long window, int has_softcap, float softcap, float scale,
    void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || B < 1 || Sq <= 8 ||
      Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Sk,
           D, causal, has_window, has_softcap,
           window, softcap, scale};
  auto s = static_cast<cudaStream_t>(stream);
  const int dc = (D + 31) / 32;
  if (dc <= 1) return launch<2, 1>(p, B, s);
  if (dc <= 2) return launch<2, 2>(p, B, s);
  if (dc <= 4) return launch<2, 4>(p, B, s);
  return launch<1, 8>(p, B, s);
}
