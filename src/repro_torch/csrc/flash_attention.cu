// Online-softmax attention for f32 prefill (Sq > 8) on the tensor cores, in
// 3xTF32 on mma.sync.m16n8k8:
//     q (B, H, Sq, D), k and v (B, KV, Sk, D) f32 -> o (B, H, Sq, D) f32
// with GQA, a causal and/or sliding-window mask aligned bottom-right, and a
// logit softcap.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _fa_kernel) for f32 operands and keeps its rules: the
// score is (q * scale) . k with q scaled and rounded first; softcap *
// tanh(s / softcap) before the mask; masked scores are -2e38 and p is zeroed
// there; per key tile m_new = max(m, rowmax s), p = exp(s - m_new), corr =
// exp(min(m - m_new, 0)), l = l * corr + rowsum p, acc = acc * corr + p v;
// the output is acc / max(l, 1e-30). A row that sees no key ends with l = 0
// and acc = 0, so it is 0, as in the reference kernel. No fast math: expf,
// tanhf, and q * scale, s / softcap, softcap * t and the final division each
// round on their own.
//
// 3xTF32. One TF32 term rounds q and k to 10 mantissa bits, about 1e-3 of
// error in the output against the f32 limit of chip_smoke.py phase 5 (2x the
// plain version's float64 error + 1e-6, about 1.5e-6). So every f32 operand
// x is split in two TF32 values, hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi) (the subtraction is exact in f32; x - hi - lo is
// below 2^-22 |x|), and each product is three MMAs into one f32 accumulator,
// lo . hi and hi . lo first, then hi . hi; lo . lo (2^-22) is left out.
// tests/test_torch_attention.py emulates both: three terms stay well inside
// the limit, one term is hundreds of times over it.
//
// Bound on this card: operations, 4 * D per visible (query, key) pair, issued
// three times over, at the dense TF32 tensor-core rate (495 TFLOP/s; what
// mma.sync reaches is lower, chip_smoke.py's kernel rows and PERF.md). Design:
// - a block of WARPS warps owns BQ = 16 * MT * WARPS query rows, MT 16-row
//   MMA tiles a warp, and runs over key tiles of BK keys of one kv head; the
//   tile (warps, rows a warp, BK, stages, Q tiles, shared bytes) of each
//   instance, one per head-dim class DP (16, 32, 64, 128, 256), is
//   kernels/flash_attention.py::TF32_TILES, which the build passes in as
//   macros (nvcc_defines). Columns
//   [D, DP) are zeros in shared memory, so every loop over the head
//   dimension has a fixed trip count. At DP 256 a 16-row tile's O
//   accumulator is 128 registers a thread; with 8 warps a block and Q
//   staged in 133 KB, BK is 16 there;
// - the grid's slowest dimension is the q tile, heaviest causal tiles first;
// - Q is staged scaled in shared memory, already split in hi and lo tiles
//   where both fit (DP <= 64), else split as each fragment is loaded; K and
//   V tiles go through a 2-stage ring filled by 16-byte cp.async, one
//   barrier per tile, so the next tile's copies run while this one is used,
//   and each warp splits the K and V fragments it loads; rows are padded to DP + 4 floats, with which both fragment patterns are
//   free of bank conflicts, K's (key g, d t) and V's (key 2t, column g);
// - S's C fragment gives thread (g, t) keys 2t and 2t + 1 of each 8-key
//   tile, and the TF32 A fragment wants columns t and t + 4; a sum over keys
//   does not care about their order, so c0/c2 stand as column t and c1/c3
//   as column t + 4, and V's B fragment is read in the same order, b0 = V[j
//   + 2t][n + g], b1 = V[j + 2t + 1][n + g]: P goes into P V from registers,
//   split like any operand, without shared memory;
// - the tensor cores round their f32 sums toward zero, which over one O
//   accumulator of 8192 keys went over the f32 limit: S takes a fresh
//   partial every 32 head dims and O every 32 keys, each added with a
//   rounded f32 add, as the plain version adds its key tiles;
// - each thread keeps its own share of the row sums l (one shuffle pair at
//   the end); O is rescaled only where a row's max moved (corr is exactly 1
//   otherwise); only tiles that the diagonal, the window edge or Sk cut are
//   masked; key tiles wholly outside a block's or a warp's rows are skipped.
//   Keys at or past Sk load as zeros and are masked; rows at or past Sq are
//   not stored. Offsets are 64-bit.
//
// Why mma.sync and not wgmma: tf32 wgmma takes both operands K-major only,
// so P V would need V transposed in shared memory for every tile. A
// FlashAttention-3 design on wgmma is the later step, for bf16 and f32 alike.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -2.0e38f;

// the instances, one per head-dim class DP, from the build: TF32_STAGES and
// TF32_<WARPS|ROWS|BK|QTILES|SMEM>_<DP> (warps, rows a warp, BK, Q tiles,
// shared bytes), kernels/flash_attention.py::nvcc_defines
#ifndef TF32_STAGES
#error "the tiles come from kernels/flash_attention.py; build through kernels/_build.py"
#endif
static_assert(TF32_STAGES == 2, "the K/V ring has two stages");
template <int DP> struct Tile;
#define TILE(DP)                                                                  \
  template <> struct Tile<DP> {                                                   \
    static constexpr int WARPS = TF32_WARPS_##DP, MT = TF32_ROWS_##DP / 16,      \
                         BK = TF32_BK_##DP, STAGES = TF32_STAGES,                \
                         QTILES = TF32_QTILES_##DP;                              \
    static constexpr size_t SMEM = TF32_SMEM_##DP;                               \
    static_assert(TF32_ROWS_##DP % 16 == 0 && BK % 8 == 0 && (QTILES == 1 || QTILES == 2), \
                  "a tile this kernel does not take");                            \
  };
TILE(16) TILE(32) TILE(64) TILE(128) TILE(256)
#undef TILE

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
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
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, each a TF32 value, up to 2^-22 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}
// c += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DP>
__host__ __device__ constexpr bool q_split() { return Tile<DP>::QTILES == 2; }

// the layout the kernel carves, which the plan's byte count must equal
template <int DP>
constexpr size_t smem_bytes() {
  using T = Tile<DP>;
  return ((q_split<DP>() ? 2 : 1) * (size_t)(16 * T::MT * T::WARPS) + 2 * T::STAGES * T::BK) *
         (size_t)(DP + 4) * 4;
}

template <int DP>
__global__ void __launch_bounds__(32 * Tile<DP>::WARPS)
flash_attention_tf32_kernel(Params p) {
  constexpr int WARPS = Tile<DP>::WARPS, MT = Tile<DP>::MT, BK = Tile<DP>::BK;
  constexpr int STAGES = Tile<DP>::STAGES;
  constexpr int THREADS = 32 * WARPS;
  constexpr int BQ = 16 * MT * WARPS;  // query rows a block
  constexpr int LD = DP + 4;           // shared row, floats
  constexpr int KT = DP / 8;           // k-steps of q . k, n-tiles of O
  constexpr int NT = BK / 8;           // n-tiles of S, k-steps of P V
  constexpr int KG = KT < 4 ? KT : 4;  // k-steps a fresh partial of S
  constexpr int NC = NT < 4 ? NT : 4;  // k-steps a fresh partial of P V
  constexpr int IG = KT < 4 ? KT : 4;  // n-tiles of O a pass of P V
  constexpr bool QS = q_split<DP>();
  const int D = p.D, nch = D / 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // BQ x LD, scaled (hi, then lo if split)
  float* ks = qs + (QS ? 2 : 1) * BQ * LD;     // STAGES x BK x LD
  float* vs = ks + STAGES * BK * LD;           // STAGES x BK x LD

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (p.H / p.KV);
  const long long qbase = ((long long)b * p.H + h) * p.Sq * D;
  const long long kvbase = ((long long)b * p.KV + kvh) * p.Sk * D;
  const float* q = p.q + qbase;
  const float* k = p.k + kvbase;
  const float* v = p.v + kvbase;

  // Q scaled and rounded once, as the reference does, then split where the
  // hi and lo tiles fit; rows at or past Sq and columns [D, DP) are zeros,
  // and so are K's and V's columns [D, DP) (cp.async never writes them)
  for (int e = threadIdx.x; e < BQ * (DP / 4); e += THREADS) {
    const int r = e / (DP / 4), c = (e % (DP / 4)) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < p.Sq && c < D)
      x = *reinterpret_cast<const float4*>(q + (long long)(q0 + r) * D + c);
    x = make_float4(__fmul_rn(x.x, p.scale), __fmul_rn(x.y, p.scale),
                    __fmul_rn(x.z, p.scale), __fmul_rn(x.w, p.scale));
    float* dst = qs + r * LD + c;
    if (QS) {
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t hi, lo;
        split(xs[i], hi, lo);
        dst[i] = __uint_as_float(hi);
        dst[BQ * LD + i] = __uint_as_float(lo);
      }
    } else {
      *reinterpret_cast<float4*>(dst) = x;
    }
  }
  if (D < DP)
    for (int e = threadIdx.x; e < 2 * STAGES * BK * (DP - D); e += THREADS)
      ks[(e / (DP - D)) * LD + D + e % (DP - D)] = 0.0f;

  // keys the block's rows see, as whole tiles [tbeg, tend) * BK, and the
  // warp's own range [wbeg, wend); positions fit in int (Sq + Sk < 2^30)
  const int off = p.Sk - p.Sq, window = p.window;
  const int rlast = min(q0 + BQ, p.Sq) - 1;
  int kbeg = 0, kend = p.Sk;
  if (p.causal) kend = min(kend, rlast + off + 1);
  if (p.has_window) kbeg = max(kbeg, q0 + off - window + 1);
  const int tbeg = kbeg / BK;
  const int tend = kbeg < kend ? (kend + BK - 1) / BK : tbeg;
  const int w0 = q0 + warp * 16 * MT;
  const bool has_rows = w0 < p.Sq;
  int wbeg = 0, wend = p.Sk;
  if (p.causal) wend = min(wend, min(w0 + 16 * MT, p.Sq) - 1 + off + 1);
  if (p.has_window) wbeg = max(wbeg, w0 + off - window + 1);

  // one tile of K and V into its stage, as one commit group (empty past the
  // last tile); keys at or past Sk are zero-filled
  auto issue = [&](int t) {
    if (t < tend) {
      const int j0 = t * BK;
      float* kd = ks + ((t - tbeg) % STAGES) * BK * LD;
      float* vd = vs + ((t - tbeg) % STAGES) * BK * LD;
      for (int e = threadIdx.x; e < 2 * BK * nch; e += THREADS) {
        const int which = e / (BK * nch), rem = e % (BK * nch);
        const int r = rem / nch, c = (rem % nch) * 4;
        const bool ok = j0 + r < p.Sk;
        const long long src = (ok ? (long long)(j0 + r) * D : 0) + c;
        cp_async16((which ? vd : kd) + r * LD + c, (which ? v : k) + src, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float o[MT][KT][4];
  float m[MT][2], l[MT][2];  // l: this thread's share of rows g and g + 8's sums
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int i = 0; i < KT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][i][e] = 0.0f;
    m[mi][0] = m[mi][1] = NEG_INF;
    l[mi][0] = l[mi][1] = 0.0f;
  }

  issue(tbeg);
  for (int t = tbeg; t < tend; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // tile t (and Q) in place for every warp; tile t - 1 consumed
    issue(t + 1);
    const int j0 = t * BK;
    const float* kt = ks + ((t - tbeg) % STAGES) * BK * LD;
    const float* vt = vs + ((t - tbeg) % STAGES) * BK * LD;
    if (!has_rows || j0 >= wend || j0 + BK <= wbeg) continue;

    // S = (q * scale) k^T over the tile, 3xTF32. The tensor cores round
    // their f32 sums toward zero, so each KG k-steps start a fresh partial,
    // added to S with a rounded f32 add
    float s[MT][NT][4];
#pragma unroll
    for (int kg = 0; kg < KT; kg += KG) {
      float part[MT][NT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mi][n][e] = 0.0f;
#pragma unroll
      for (int kk = kg; kk < kg + KG; ++kk) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float* qa = qs + ((warp * MT + mi) * 16 + g) * LD + kk * 8 + t4;
          const int at[4] = {0, 8 * LD, 4, 8 * LD + 4};  // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (QS) {
              ah[mi][i] = __float_as_uint(qa[at[i]]);
              al[mi][i] = __float_as_uint(qa[BQ * LD + at[i]]);
            } else {
              split(qa[at[i]], ah[mi][i], al[mi][i]);
            }
          }
        }
        // the K fragments of all n-tiles first, then each term across all
        // n-tiles: a warp issues in order, so NT independent accumulators
        // stand between two MMAs into the same one
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int kat = (n * 8 + g) * LD + kk * 8 + t4;
          split(kt[kat], bh[n][0], bl[n][0]);
          split(kt[kat + 4], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma(part[mi][n], al[mi], bh[n][0], bh[n][1]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma(part[mi][n], ah[mi], bl[n][0], bl[n][1]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma(part[mi][n], ah[mi], bh[n][0], bh[n][1]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mi][n][e] = kg == 0 ? part[mi][n][e] : __fadd_rn(s[mi][n][e], part[mi][n][e]);
    }

    // softcap, then the mask where the tile is cut: masked scores are -2e38
    if (p.has_softcap) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mi][n][e] = __fmul_rn(p.softcap, tanhf(__fdiv_rn(s[mi][n][e], p.softcap)));
    }
    // the tile is whole for every row of the warp: no mask to apply
    const bool full = j0 + BK <= p.Sk && (!p.causal || j0 + BK - 1 <= w0 + off) &&
                      (!p.has_window || j0 > w0 + 16 * MT - 1 + off - window);
    if (!full) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int qpos0 = w0 + mi * 16 + g + off, qpos1 = qpos0 + 8;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + n * 8 + 2 * t4 + (e & 1);
            const int qpos = e < 2 ? qpos0 : qpos1;
            const bool vis = key < p.Sk && (!p.causal || key <= qpos) &&
                             (!p.has_window || key > qpos - window);
            s[mi][n][e] = vis ? s[mi][n][e] : NEG_INF;
          }
      }
    }

    // online softmax on the fragments, rows g (e 0, 1) and g + 8 (e 2, 3)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
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
      const float mn0 = fmaxf(m[mi][0], mx0), mn1 = fmaxf(m[mi][1], mx1);
      const float corr0 = expf(fminf(m[mi][0] - mn0, 0.0f));
      const float corr1 = expf(fminf(m[mi][1] - mn1, 0.0f));
      m[mi][0] = mn0;
      m[mi][1] = mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[mi][n][e];
          const float pv = (!full && x == NEG_INF) ? 0.0f : expf(x - (e < 2 ? mn0 : mn1));
          s[mi][n][e] = pv;
          if (e < 2) sum0 += pv; else sum1 += pv;
        }
      l[mi][0] = __fadd_rn(__fmul_rn(l[mi][0], corr0), sum0);
      l[mi][1] = __fadd_rn(__fmul_rn(l[mi][1], corr1), sum1);
      // corr is exactly 1 wherever the max did not move: skip the multiply
      if (__any_sync(0xffffffffu, corr0 != 1.0f || corr1 != 1.0f)) {
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          o[mi][i][0] = __fmul_rn(o[mi][i][0], corr0);
          o[mi][i][1] = __fmul_rn(o[mi][i][1], corr0);
          o[mi][i][2] = __fmul_rn(o[mi][i][2], corr1);
          o[mi][i][3] = __fmul_rn(o[mi][i][3], corr1);
        }
      }
    }

    // O += P V, 3xTF32, a fresh partial every NC k-steps (8 NC keys) added
    // to O with rounded f32 adds; P's A fragment straight from S's C
    // fragment: c0 and c2 (key 2t) as column t, c1 and c3 (key 2t + 1) as
    // column t + 4
#pragma unroll
    for (int nc = 0; nc < NT; nc += NC) {
      uint32_t ph[MT][NC][4], pl[MT][NC][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          split(s[mi][nc + n][0], ph[mi][n][0], pl[mi][n][0]);
          split(s[mi][nc + n][2], ph[mi][n][1], pl[mi][n][1]);
          split(s[mi][nc + n][1], ph[mi][n][2], pl[mi][n][2]);
          split(s[mi][nc + n][3], ph[mi][n][3], pl[mi][n][3]);
        }
      // IG output n-tiles at a time, each term across them, as in S
#pragma unroll
      for (int ig = 0; ig < KT; ig += IG) {
        float part[MT][IG][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ii = 0; ii < IG; ++ii)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][ii][e] = 0.0f;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          uint32_t bh[IG][2], bl[IG][2];
#pragma unroll
          for (int ii = 0; ii < IG; ++ii) {
            const int vat = ((nc + n) * 8 + 2 * t4) * LD + (ig + ii) * 8 + g;
            split(vt[vat], bh[ii][0], bl[ii][0]);
            split(vt[vat + LD], bh[ii][1], bl[ii][1]);
          }
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int ii = 0; ii < IG; ++ii) mma(part[mi][ii], pl[mi][n], bh[ii][0], bh[ii][1]);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int ii = 0; ii < IG; ++ii) mma(part[mi][ii], ph[mi][n], bl[ii][0], bl[ii][1]);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int ii = 0; ii < IG; ++ii)
              mma(part[mi][ii], ph[mi][n], bh[ii][0], bh[ii][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ii = 0; ii < IG; ++ii)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[mi][ig + ii][e] = __fadd_rn(o[mi][ig + ii][e], part[mi][ii][e]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  float* out = p.o + qbase;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float l0 = l[mi][0], l1 = l[mi][1];
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int row0 = w0 + mi * 16 + g, row1 = row0 + 8;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col >= D) continue;
      if (row0 < p.Sq)
        *reinterpret_cast<float2*>(out + (long long)row0 * D + col) =
            make_float2(__fdiv_rn(o[mi][i][0], d0), __fdiv_rn(o[mi][i][1], d0));
      if (row1 < p.Sq)
        *reinterpret_cast<float2*>(out + (long long)row1 * D + col) =
            make_float2(__fdiv_rn(o[mi][i][2], d1), __fdiv_rn(o[mi][i][3], d1));
    }
  }
}

template <int DP>
int launch(const Params& p, int B, cudaStream_t stream) {
  using T = Tile<DP>;
  static_assert(smem_bytes<DP>() == T::SMEM,
                "the plan's shared bytes are not the kernel's layout");
  constexpr int BQ = 16 * T::MT * T::WARPS;
  constexpr size_t smem = T::SMEM;
  const long long qtiles = (p.Sq + BQ - 1) / BQ;
  if (qtiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_tf32_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((unsigned)p.H, (unsigned)B, (unsigned)qtiles);
  kernel<<<grid, 32 * T::WARPS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 only, Sq > 8; D a multiple of 8 up to 256; B at most 65535, Sq + Sk
// below 2^30. The tile is the instance of D's class. Returns a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int D, int causal, int has_window,
    long long window, int has_softcap, float softcap, float scale,
    void* stream) {
  if (D < 8 || D > 256 || D % 8 || KV < 1 || H % KV || B < 1 || B > 65535 ||
      Sq <= 8 || Sk < 1 || (long long)Sq + Sk >= (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long span = (long long)Sq + Sk + 1;
  window = window > span ? span : (window < -span ? -span : window);
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Sk,
           D, causal, has_window, has_softcap,
           (int)window, softcap, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(p, B, s);
  if (D <= 32) return launch<32>(p, B, s);
  if (D <= 64) return launch<64>(p, B, s);
  if (D <= 128) return launch<128>(p, B, s);
  return launch<256>(p, B, s);
}
