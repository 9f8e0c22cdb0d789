// One VTA GEMM instruction in one launch: gather -> int8 mma -> add into acc.
//
// Replaces the TPU kernel src/repro/kernels/vta_gemm.py::blocked_gemm (body
// _gemm_kernel) together with what the JAX backend computes around it for a
// GEMM entry: the row gathers of fsim_jax._gemm_product and the
// `state["acc"].at[acc_idx].add(...)` after it (fsim_jax._exec_entries).
//
// Contract, with group q = j * gb + m, gb = g / w_d:
//   acc[n, uidx[q], bv, c] += sum_r sum_bi inp[n, inp_idx[q*R + r], bv, bi]
//                                          * wgt[nw, wrows[j*R + r], c, bi]
// acc (N, acc_depth, BV, BO) int32, inp (N, inp_depth, BV, BI) int8, wgt
// (Nw, wgt_depth, BO, BI) int8 with Nw in {1, N} (wgt_nstride 0: a weight
// scratchpad the batch shares), int32 index vectors uidx (g), inp_idx (g*R),
// wrows (w_d*R). BV in {1, 2}; BI, BO in {16, 32, 64}. The add wraps in
// int32, as numpy's does.
//
// Per (image n, weight block j) the instruction is one (gb*BV, R*BI) x
// (R*BI, BO) product. A block owns 16 rows a warp (1-4 warps) of it and all
// BO columns, and walks K in passes of up to KP_MAX bytes (one pass for
// every trunk entry: K <= 576). A pass is two dependent memory round trips
// and no more:
//  - the pass's index rows (inp_idx of the block's groups, wrows of its
//    weight block) are copied into shared memory by cp.async, all in
//    flight at once (16 bytes a copy where one pass covers all of R), with
//    the groups' uidx before the first pass;
//  - A operand: the inp rows are gathered through them straight into
//    shared memory by 16-byte cp.async; every (r, bv) row is BI contiguous
//    bytes, so a 16-byte piece never straddles two rows;
//  - B operand: a weight row wgt[wrows[j*R + r]] is (BO, BI), BO columns
//    with their K bytes contiguous: exactly mma's `.col` B layout, so it is
//    copied as it lies, with no transpose and no byte packing;
//  - every copy of the pass is in flight at once, and where the uidx are
//    unique, the acc values the epilogue adds to are loaded behind them.
// Shared rows are padded by 16 bytes, so the fragment reads of a warp hit 32
// distinct banks. mma.sync.m16n8k32 s8 x s8 -> s32 accumulates in int32:
// exact at any K, with no 1024-term split (the reference's exact-f32 blocks
// agree). Epilogue: each thread adds its C fragment into acc at uidx: a
// plain read-add-write where the entry's uidx are unique (every trunk
// entry), else int32 atomicAdd, which is exact in any order. Tails: A rows
// past gb*BV and K bytes past R*BI are zero-filled and never written.
//
// Bound on this card: latency, not bytes or the int8 rate. The trunk's
// products are at most 448 x 576 x 16 per (image, block) and move a few
// hundred KB; a launch lasts a few microseconds, most of it memory round
// trips that depend on one another. So the design removes the PyTorch
// kernels that used to surround the product (two row gathers, an operand
// copy, index_add_) and the byte-wise weight packing, and keeps each
// launch at two round trips before its products; it uses mma.sync rather
// than wgmma: a 64-row warpgroup tile and TMA descriptors buy nothing at
// these shapes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KP_MAX = 1024;  // K bytes a pass stages
constexpr int PAD = 16;       // shared-memory row padding, bytes
constexpr int MAX_WARPS = 4;

struct Args {
  int32_t* acc;
  const int8_t* inp;
  const int8_t* wgt;
  const int32_t* uidx;
  const int32_t* inp_idx;
  const int32_t* wrows;
  long long acc_ns, inp_ns, wgt_ns;   // per-image strides, elements
  int R, gb, M, BV, log_bi, unique;
  int rp;                             // reduction rows a pass stages
  int sw;                             // bytes of K a pass stages, % 32 == 0
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; ok == false fills the 16 bytes with zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// the first `bytes` (at most 16) of 16 bytes global -> shared, zero-filled
__device__ __forceinline__ void cp16n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// 4 bytes global -> shared
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// shared memory of one block: A rows, B rows, then the index rows
__host__ __device__ __forceinline__ int smem_bytes(int tm, int bo, int bv,
                                                   int rp, int sw) {
  return (tm + bo) * (sw + PAD) + 4 * ((tm / bv) * (rp + 1) + rp + 8);
}

template <int NT>   // BO / 8 column tiles
__global__ void __launch_bounds__(32 * MAX_WARPS)
vta_gemm_acc_kernel(Args a) {
  constexpr int BO = NT * 8;
  extern __shared__ __align__(16) int8_t smem[];
  const int TM = blockDim.x / 2;      // 16 rows a warp
  const int GT = TM / a.BV;           // groups a block covers
  const int row_b = a.sw + PAD;       // shared row, bytes
  int8_t* As = smem;
  int8_t* Bs = As + TM * row_b;
  int* sidx = reinterpret_cast<int*>(Bs + BO * row_b);   // GT x rp
  int* swr = sidx + GT * a.rp + 8;                        // rp
  int* suidx = swr + a.rp;                                // GT
  const int n = blockIdx.z, j = blockIdx.y;
  const int m0 = blockIdx.x * TM, g0 = m0 / a.BV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int BI = 1 << a.log_bi;
  const int ppr = a.sw / 16;          // 16-byte pieces a row a pass
  const int row0 = tid / ppr, kq0 = tid - row0 * ppr;
  const int step_r = blockDim.x / ppr, step_k = blockDim.x - step_r * ppr;
  const int log_bv = a.BV == 2;
  const int8_t* inp = a.inp + n * a.inp_ns;
  const int8_t* wgt = a.wgt + n * a.wgt_ns;
  const long long q0 = (long long)j * a.gb;   // the block weight's groups

  int c[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0;
  int2 pre[2][NT];                    // acc values the epilogue adds to
  int32_t* out[2] = {nullptr, nullptr};

  for (int r0 = 0; r0 < a.R; r0 += a.rp) {
    const int rn = a.R - r0 < a.rp ? a.R - r0 : a.rp;   // rows this pass
    if (r0) __syncthreads();          // every warp is done with the last pass
    // the index rows by cp.async too: no thread waits on one load before
    // it issues the next (groups past gb are never read). In one pass they
    // are one contiguous run, copied 16 bytes at a time from the 16-byte
    // boundary at or before it; else group by group, 4 bytes at a time.
    const int gn = a.gb - g0 < GT ? a.gb - g0 : GT;
    const int* sx = sidx;             // index of (group gl, row rr) at
    int sxs = a.rp;                   // sx[gl * sxs + rr]
    if (rn == a.R) {
      const long long first = (q0 + g0) * a.R;
      const int shift = static_cast<int>(first & 3);
      const int32_t* src = a.inp_idx + (first - shift);
      const int bytes = 4 * (gn * a.R + shift);
      for (int i = tid; 16 * i < bytes; i += blockDim.x) {
        const int left = bytes - 16 * i;
        cp16n(sidx + 4 * i, src + 4 * i, left < 16 ? left : 16);
      }
      sx = sidx + shift;
      sxs = a.R;
    } else {
#pragma unroll 4
      for (int i = tid; i < gn * rn; i += blockDim.x) {
        const int gl = i / rn, rr = i - gl * rn;
        cp4(sidx + gl * a.rp + rr,
            a.inp_idx + (q0 + g0 + gl) * a.R + r0 + rr);
      }
    }
    for (int i = tid; i < rn; i += blockDim.x)
      cp4(swr + i, a.wrows + (long long)j * a.R + r0 + i);
    if (r0 == 0)
      for (int i = tid; i < gn; i += blockDim.x)
        cp4(suidx + i, a.uidx + q0 + g0 + i);
    cp_wait_all();
    __syncthreads();
    // piece p = (row, kq) of A, then (col, kq) of B, for p = tid, tid +
    // blockDim.x, ...: row and kq advance by step_r, step_k (no division)
#pragma unroll 4
    for (int row = row0, kq = kq0; row < TM;) {
      const int k = kq * 16, rr = k >> a.log_bi;
      const bool ok = m0 + row < a.M && rr < rn;
      const int8_t* src = inp;
      if (ok) {
        const int gl = row >> log_bv, bv = row & (a.BV - 1);
        src = inp + ((long long)sx[gl * sxs + rr] * a.BV + bv) * BI
              + (k & (BI - 1));
      }
      cp16(As + row * row_b + k, src, ok);
      row += step_r;
      kq += step_k;
      if (kq >= ppr) kq -= ppr, ++row;
    }
#pragma unroll 4
    for (int col = row0, kq = kq0; col < BO;) {
      const int k = kq * 16, rr = k >> a.log_bi;
      const bool ok = rr < rn;
      const int8_t* src = wgt;
      if (ok)
        src = wgt + ((long long)swr[rr] * BO + col) * BI + (k & (BI - 1));
      cp16(Bs + col * row_b + k, src, ok);
      col += step_r;
      kq += step_k;
      if (kq >= ppr) kq -= ppr, ++col;
    }
    if (r0 == 0) {
      // the epilogue's acc rows: C fragment rows g + 8h of this warp
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h;
        if (m0 + row >= a.M) continue;
        const int gl = row >> log_bv, bv = row & (a.BV - 1);
        out[h] = a.acc + n * a.acc_ns
                 + ((long long)suidx[gl] * a.BV + bv) * BO + 2 * t;
        if (a.unique) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            pre[h][nt] = *reinterpret_cast<const int2*>(out[h] + nt * 8);
        }
      }
    }
    cp_wait_all();
    __syncthreads();
    const int8_t* a0 = As + (warp * 16 + g) * row_b;
    const int8_t* a1 = a0 + 8 * row_b;
    for (int kk = t * 4; kk < a.sw; kk += 32) {
      unsigned af[4];
      af[0] = *reinterpret_cast<const unsigned*>(a0 + kk);
      af[1] = *reinterpret_cast<const unsigned*>(a1 + kk);
      af[2] = *reinterpret_cast<const unsigned*>(a0 + kk + 16);
      af[3] = *reinterpret_cast<const unsigned*>(a1 + kk + 16);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* b0 = Bs + (nt * 8 + g) * row_b;
        unsigned bf[2];
        bf[0] = *reinterpret_cast<const unsigned*>(b0 + kk);
        bf[1] = *reinterpret_cast<const unsigned*>(b0 + kk + 16);
        mma_s8(c[nt], af, bf);
      }
    }
  }

  // C fragment: c[nt][2h], c[nt][2h + 1] are row g + 8h, columns 2t, 2t + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (out[h] == nullptr) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      int32_t* o = out[h] + nt * 8;
      if (a.unique) {
        int2 v = pre[h][nt];
        v.x = wadd(v.x, c[nt][2 * h]);
        v.y = wadd(v.y, c[nt][2 * h + 1]);
        *reinterpret_cast<int2*>(o) = v;
      } else {
        atomicAdd(o, c[nt][2 * h]);
        atomicAdd(o + 1, c[nt][2 * h + 1]);
      }
    }
  }
}

template <int NT>
int launch(const Args& a, dim3 grid, int threads, int smem, cudaStream_t st) {
  // shared memory above 48 KB needs opting in; once, for the largest block,
  // so that no launch inside a CUDA-graph capture makes the call
  static bool opted = false;
  if (!opted) {
    const int most = smem_bytes(32 * MAX_WARPS / 2, NT * 8, 1,
                                KP_MAX / 16, KP_MAX);
    const cudaError_t e = cudaFuncSetAttribute(
        vta_gemm_acc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  vta_gemm_acc_kernel<NT><<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vta_gemm_launch(void* acc, const void* inp, const void* wgt,
                               const void* uidx, const void* inp_idx,
                               const void* wrows, int n, long long acc_ns,
                               long long inp_ns, long long wgt_ns, int g,
                               int R, int w_d, int bv, int bi, int bo,
                               int unique, void* stream) {
  if (n <= 0 || g <= 0 || R <= 0) return 0;
  if (w_d <= 0 || g % w_d != 0 || (bv != 1 && bv != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_bi = bi == 16 ? 4 : bi == 32 ? 5 : bi == 64 ? 6 : -1;
  if (log_bi < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.acc = static_cast<int32_t*>(acc);
  a.inp = static_cast<const int8_t*>(inp);
  a.wgt = static_cast<const int8_t*>(wgt);
  a.uidx = static_cast<const int32_t*>(uidx);
  a.inp_idx = static_cast<const int32_t*>(inp_idx);
  a.wrows = static_cast<const int32_t*>(wrows);
  a.acc_ns = acc_ns;
  a.inp_ns = inp_ns;
  a.wgt_ns = wgt_ns;
  a.R = R;
  a.gb = g / w_d;
  a.M = a.gb * bv;
  a.BV = bv;
  a.log_bi = log_bi;
  a.unique = unique;
  a.rp = R < KP_MAX / bi ? R : KP_MAX / bi;
  a.sw = (a.rp * bi + 31) / 32 * 32;
  int warps = (a.M + 15) / 16;
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  const int tm = 16 * warps;
  dim3 grid((a.M + tm - 1) / tm, w_d, n);
  const int smem = smem_bytes(tm, bo, bv, a.rp, a.sw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bo) {
    case 16: return launch<2>(a, grid, 32 * warps, smem, st);
    case 32: return launch<4>(a, grid, 32 * warps, smem, st);
    case 64: return launch<8>(a, grid, 32 * warps, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
