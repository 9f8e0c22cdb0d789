// Online-softmax attention for bf16 prefill (Sq > 8) on the tensor cores,
// FlashAttention-2 style on mma.sync.m16n8k16 bf16 -> f32:
//     q (B, H, Sq, D), k and v (B, KV, Sk, D) bf16 -> o (B, H, Sq, D) bf16
// with GQA, a causal and/or sliding-window mask aligned bottom-right, and a
// logit softcap.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _fa_kernel) for bf16 operands, keeping its rules:
// softcap * tanh(s / softcap) before the mask; masked scores -2e38 with p
// zeroed; per key tile m_new = max(m, rowmax s), corr = exp(m - m_new), l =
// l * corr + rowsum p, acc = acc * corr + p v; out = acc / max(l, 1e-30),
// rounded once to bf16. A row that sees no key ends at l = 0, acc = 0: 0.
// Where it departs, and why the bf16 limit of chip_smoke.py phase 5 still
// holds:
// - the score is (q . k) * scale, not (q * scale) . k as at
//   flash_attention.py:43: the products of two bf16 values are exact in f32,
//   so scaling after the sum changes only one f32 rounding;
// - the softmax runs in base 2, log2(e) folded into the scale and the scale
//   into the exponent's FFMA, p = 2^(s * scale * log2(e) - m) (ex2.approx,
//   relative error about 2^-22); the softcap's tanh is built on the same ex2
//   (absolute error about softcap * 2^-22); tanh.approx.f32 (about 2^-11)
//   would be too coarse. The scale is not negative (the wrapper negates q
//   for a negative scale, exact in bf16);
// - P enters the tensor cores as bf16, so it is split in two: hi = p with
//   its low 16 bits cleared (a bf16 value; p - hi is exact in f32), lo = p -
//   hi cut the same way, two MMAs into one f32 accumulator (hi + lo is below
//   p by less than 2^-14 p, against 2^-9 for one bf16 rounding: one-term
//   bf16 P breaks the limit in about 7% of elements at 8192 keys;
//   tests/test_torch_attention.py emulates both). Cutting instead of
//   rounding takes bit operations only, no conversion instructions;
// - O is rescaled only when a row's max moved (corr is exactly 1 otherwise).
//
// Bound on this card: operations, 4 * D per visible (query, key) pair (6 * D
// issued, with the split P), on the bf16 tensor cores. Design:
// - a block of WARPS warps owns BQ = 16 * RPW * WARPS query rows, 16 * RPW a
//   warp (RPW 16-row MMA tiles share each K and V fragment a warp loads), and
//   runs over key tiles of BK keys of one kv head; the grid's slowest
//   dimension is the q tile, heaviest causal tiles first, so the last wave
//   holds the light ones;
// - Q (zero-padded to DP, a multiple of 16, in shared memory) is read into
//   A fragments with ldmatrix; K and V tiles are double-buffered in shared
//   memory, filled by 16-byte cp.async, one barrier per tile: the next
//   tile's copies run while this one is used; rows are padded by 16 bytes so
//   the 8 rows an ldmatrix reads fall on distinct banks; K^T fragments come
//   from ldmatrix, V fragments from ldmatrix.trans;
// - S's f32 C fragments become P's A fragments in registers; the row max
//   takes two quad shuffles; the row sum l comes from the tensor cores as P
//   times a column of ones, split like P V, so l sums the same hi + lo that
//   P V does and needs no shuffles;
// - only tiles that the diagonal, the window edge or Sk cut are masked;
//   tiles wholly outside a warp's rows are skipped, by the block and by each
//   warp. Keys at or past Sk load as zeros and are masked; rows at or past
//   Sq are not stored.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;

// the tile of each padded head dim: warps a block, 16-row MMA tiles a warp,
// keys a tile
template <int DP> struct Tile {
  static constexpr int WARPS = 8, RPW = DP <= 128 ? 2 : 1, BK = DP <= 128 ? 64 : 32;
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int H, KV, Sq, Sk, D;
  int causal, has_window, has_softcap;
  int window;  // clamped to +-(Sq + Sk + 1), where it masks all or nothing
  float softcap, scale;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c = a * b, from a zero accumulator (no zeroing of c first)
__device__ __forceinline__ void mma0(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// tanh(x) = sign(x) (1 - e) / (1 + e), e = 2^(-2 |x| log2(e))
__device__ __forceinline__ float tanh_ex2(float x) {
  const float e = ex2(-2.0f * LOG2E * fabsf(x));
  return copysignf(__fdividef(1.0f - e, 1.0f + e), x);
}

template <int DP>
__global__ void __launch_bounds__(32 * Tile<DP>::WARPS)
flash_attention_mma_kernel(Params p) {
  constexpr int WARPS = Tile<DP>::WARPS, RPW = Tile<DP>::RPW, BK = Tile<DP>::BK;
  constexpr int THREADS = 32 * WARPS;
  constexpr int BQ = 16 * RPW * WARPS;     // query rows a block
  constexpr int LD = DP + 8;               // shared row, elements
  constexpr int KSTEPS = DP / 16;          // k-steps of q . k
  constexpr int NT = BK / 8;               // n-tiles of S
  constexpr int OT = DP / 8;               // n-tiles of O
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // BQ x LD
  bf16* ks = qs + BQ * LD;                    // 2 x BK x LD
  bf16* vs = ks + 2 * BK * LD;                // 2 x BK x LD

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (p.H / p.KV);
  const int D = p.D, nch = D / 8;
  const long long qbase = ((long long)b * p.H + h) * p.Sq * D;
  const long long kvbase = ((long long)b * p.KV + kvh) * p.Sk * D;
  const bf16* q = p.q + qbase;
  const bf16* k = p.k + kvbase;
  const bf16* v = p.v + kvbase;

  // pad columns [D, DP) of Q, K and V are zero (cp.async never writes them)
  if (D < DP)
    for (int e = threadIdx.x; e < (BQ + 4 * BK) * (DP - D); e += THREADS)
      qs[(e / (DP - D)) * LD + D + e % (DP - D)] = __float2bfloat16_rn(0.0f);
  for (int e = threadIdx.x; e < BQ * nch; e += THREADS) {
    const int r = e / nch, ch = e % nch;
    const bool ok = q0 + r < p.Sq;
    cp_async16(qs + r * LD + ch * 8, q + (ok ? (long long)(q0 + r) * D : 0) + ch * 8, ok);
  }

  // keys the block's rows see, as whole tiles [tbeg, tend) * BK, and the
  // warp's own range [wbeg, wend); positions fit in int (Sq + Sk < 2^30)
  const int off = p.Sk - p.Sq, window = p.window;
  const int rlast = min(q0 + BQ, p.Sq) - 1;
  int kbeg = 0, kend = p.Sk;
  if (p.causal) kend = min(kend, rlast + off + 1);
  if (p.has_window) kbeg = max(kbeg, q0 + off - window + 1);
  const int tbeg = kbeg / BK;
  const int tend = kbeg < kend ? (kend + BK - 1) / BK : tbeg;
  const int w0 = q0 + warp * 16 * RPW;
  const bool has_rows = w0 < p.Sq;
  int wbeg = 0, wend = p.Sk;
  if (p.causal) wend = min(wend, min(w0 + 16 * RPW, p.Sq) - 1 + off + 1);
  if (p.has_window) wbeg = max(wbeg, w0 + off - window + 1);

  // one tile of K and V into its buffer, as one commit group (empty past
  // the last tile, so that Q's copies are always committed)
  auto issue = [&](int t) {
    if (t < tend) {
      const int j0 = t * BK;
      bf16* kd = ks + ((t - tbeg) & 1) * BK * LD;
      bf16* vd = vs + ((t - tbeg) & 1) * BK * LD;
      for (int e = threadIdx.x; e < 2 * BK * nch; e += THREADS) {
        const int which = e / (BK * nch), rem = e % (BK * nch);
        const int r = rem / nch, ch = rem % nch;
        const bool ok = j0 + r < p.Sk;
        const long long src = (ok ? (long long)(j0 + r) * D : 0) + ch * 8;
        cp_async16((which ? vd : kd) + r * LD + ch * 8, (which ? v : k) + src, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // base 2: p = 2^(x * c - m) with x = s and c = scale * log2(e), or with a
  // softcap x = tanh(s * c_in) * c_out and c = 1
  const float c = p.has_softcap ? 1.0f : p.scale * LOG2E;
  const float c_in = p.has_softcap ? p.scale / p.softcap : 0.0f;
  const float c_out = p.softcap * LOG2E;

  float o[RPW][OT][4];
  float m[RPW][2], l[RPW][4];  // l: row sums, an 8-column C fragment of P 1
#pragma unroll
  for (int mi = 0; mi < RPW; ++mi) {
#pragma unroll
    for (int i = 0; i < OT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][i][e] = 0.0f;
    m[mi][0] = m[mi][1] = NEG_INF;
    l[mi][0] = l[mi][1] = l[mi][2] = l[mi][3] = 0.0f;
  }

  // Q rides in the first group
  issue(tbeg);
  for (int t = tbeg; t < tend; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t (and Q) landed for every warp; tile t - 1 consumed
    issue(t + 1);
    const int j0 = t * BK;
    const bf16* kt = ks + ((t - tbeg) & 1) * BK * LD;
    const bf16* vt = vs + ((t - tbeg) & 1) * BK * LD;
    if (!has_rows || j0 >= wend || j0 + BK <= wbeg) continue;

    // S = q k^T over the tile, f32 on the tensor cores
    float s[RPW][NT][4];
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[RPW][4];
#pragma unroll
      for (int mi = 0; mi < RPW; ++mi)
        ldmatrix_x4(a[mi], qs + ((warp * RPW + mi) * 16 + (lane & 15)) * LD + kk * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (n2 * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < RPW; ++mi) {
          if (kk == 0) {
            mma0(s[mi][2 * n2], a[mi], bk[0], bk[1]);
            mma0(s[mi][2 * n2 + 1], a[mi], bk[2], bk[3]);
          } else {
            mma(s[mi][2 * n2], a[mi], bk[0], bk[1]);
            mma(s[mi][2 * n2 + 1], a[mi], bk[2], bk[3]);
          }
        }
      }
    }

    // the tile is whole for every row of the warp: no mask to apply
    const bool full = j0 + BK <= p.Sk && (!p.causal || j0 + BK - 1 <= w0 + off) &&
                      (!p.has_window || j0 > w0 + 16 * RPW - 1 + off - window);

    // softcap, then the mask where the tile is cut: x = s, or with a
    // softcap x = tanh(s * scale / softcap) * softcap * log2(e); masked x
    // is -2e38
#pragma unroll
    for (int mi = 0; mi < RPW; ++mi) {
      const int qpos0 = w0 + mi * 16 + g + off, qpos1 = qpos0 + 8;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = p.has_softcap ? tanh_ex2(s[mi][n][e] * c_in) * c_out : s[mi][n][e];
          if (!full) {
            const int key = j0 + n * 8 + 2 * t4 + (e & 1);
            const int qpos = e < 2 ? qpos0 : qpos1;
            const bool vis = key < p.Sk && (!p.causal || key <= qpos) &&
                             (!p.has_window || key > qpos - window);
            x = vis ? x : NEG_INF;
          }
          s[mi][n][e] = x;
        }
    }

    // online softmax on the fragments, rows g (e 0, 1) and g + 8 (e 2, 3),
    // in base 2: m is the running max of x * c, p = 2^(x * c - m), one FFMA
    // and one ex2 an element
#pragma unroll
    for (int mi = 0; mi < RPW; ++mi) {
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[mi][n][0], s[mi][n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mi][n][2], s[mi][n][3]));
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m[mi][0], mx0 > NEG_INF ? mx0 * c : NEG_INF);
      const float mn1 = fmaxf(m[mi][1], mx1 > NEG_INF ? mx1 * c : NEG_INF);
      const float corr0 = ex2(m[mi][0] - mn0), corr1 = ex2(m[mi][1] - mn1);
      m[mi][0] = mn0;
      m[mi][1] = mn1;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[mi][n][e];
          const float pv = (!full && x == NEG_INF) ? 0.0f : ex2(fmaf(x, c, -(e < 2 ? mn0 : mn1)));
          s[mi][n][e] = pv;
        }
      // corr is exactly 1 wherever the max did not move: skip the multiply
      if (__any_sync(0xffffffffu, corr0 != 1.0f || corr1 != 1.0f)) {
#pragma unroll
        for (int i = 0; i < OT; ++i) {
          o[mi][i][0] *= corr0;
          o[mi][i][1] *= corr0;
          o[mi][i][2] *= corr1;
          o[mi][i][3] *= corr1;
        }
        l[mi][0] *= corr0;
        l[mi][1] *= corr0;
        l[mi][2] *= corr1;
        l[mi][3] *= corr1;
      }
    }

    // O += P V, P split as hi + lo, both bf16, into one f32 accumulator: hi
    // is p with its low 16 bits cleared (p - hi is then exact in f32), lo is
    // p - hi cut the same way; bit operations, no conversions
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[RPW][4], lo[RPW][4];
#pragma unroll
      for (int mi = 0; mi < RPW; ++mi)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float c0 = s[mi][2 * kk + (i >> 1)][2 * (i & 1)];
          const float c1 = s[mi][2 * kk + (i >> 1)][2 * (i & 1) + 1];
          const uint32_t b0 = __float_as_uint(c0) & 0xffff0000u;
          const uint32_t b1 = __float_as_uint(c1) & 0xffff0000u;
          hi[mi][i] = __byte_perm(b0, b1, 0x7632);
          lo[mi][i] = __byte_perm(__float_as_uint(c0 - __uint_as_float(b0)),
                                  __float_as_uint(c1 - __uint_as_float(b1)), 0x7632);
        }
#pragma unroll
      for (int mi = 0; mi < RPW; ++mi) {  // l += P times a column of ones (bf16 1.0)
        mma(l[mi], hi[mi], 0x3F803F80u, 0x3F803F80u);
        mma(l[mi], lo[mi], 0x3F803F80u, 0x3F803F80u);
      }
#pragma unroll
      for (int n2 = 0; n2 < OT / 2; ++n2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                  n2 * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < RPW; ++mi) {
          mma(o[mi][2 * n2], hi[mi], bv[0], bv[1]);
          mma(o[mi][2 * n2], lo[mi], bv[0], bv[1]);
          mma(o[mi][2 * n2 + 1], hi[mi], bv[2], bv[3]);
          mma(o[mi][2 * n2 + 1], lo[mi], bv[2], bv[3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  bf16* out = p.o + qbase;
#pragma unroll
  for (int mi = 0; mi < RPW; ++mi) {
    const float d0 = fmaxf(l[mi][0], 1e-30f), d1 = fmaxf(l[mi][2], 1e-30f);
    const int row0 = w0 + mi * 16 + g, row1 = row0 + 8;
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col >= D) continue;
      if (row0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row0 * D + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[mi][i][0], d0), __fdiv_rn(o[mi][i][1], d0));
      if (row1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row1 * D + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[mi][i][2], d1), __fdiv_rn(o[mi][i][3], d1));
    }
  }
}

template <int DP>
int launch(const Params& p, int B, cudaStream_t stream) {
  using T = Tile<DP>;
  constexpr int BQ = 16 * T::RPW * T::WARPS;
  const size_t smem = (size_t)(BQ + 4 * T::BK) * (DP + 8) * 2;  // Q, 2 K and 2 V tiles
  auto kernel = flash_attention_mma_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((unsigned)p.H, (unsigned)B, (unsigned)((p.Sq + BQ - 1) / BQ));
  kernel<<<grid, 32 * T::WARPS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only; D a multiple of 8 up to 256, padded to DP = 16, 32, 64, 128 or
// 256 in shared memory; B and ceil(Sq / BQ) at most 65535, Sq + Sk below
// 2^30, scale not negative. Returns a cudaError_t.
extern "C" int flash_attention_mma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, int causal, int has_window,
    long long window, int has_softcap, float softcap, float scale,
    void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || B < 1 || B > 65535 ||
      Sq < 1 || Sk < 1 || Sq + Sk >= (1 << 30) || !(scale >= 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long span = (long long)Sq + Sk + 1;
  window = window > span ? span : (window < -span ? -span : window);
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
           H, KV, Sq, Sk, D, causal, has_window, has_softcap,
           (int)window, softcap, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(p, B, s);
  if (D <= 32) return launch<32>(p, B, s);
  if (D <= 64) return launch<64>(p, B, s);
  if (D <= 128) return launch<128>(p, B, s);
  return launch<256>(p, B, s);
}
