// Exact int8 x int8 -> int32 GEMM for one VTA GEMM instruction.
//
// Replaces the TPU kernel src/repro/kernels/vta_gemm.py::blocked_gemm (body
// _gemm_kernel), which the JAX backend reaches through the "gemm" registry
// entry as w_d separate f32 matmuls of at most F32_EXACT_TERMS terms each.
//
// One launch computes every weight block of the instruction for every image
// of the batch:
//     out[n, j, m, c] = sum_k x[n, j, m, k] * w[j, k, c]      (c < 16)
// x (N, w_d, M, K) int8, w (Nw, w_d, K, 16) int8 with Nw in {1, N} (a weight
// scratchpad filled only from shared tensors has no batch axis: w_nstride 0),
// out (N, w_d, M, 16) int32.
//
// Bound on this card: the trunk's products are tiny (M <= 448, K <= 576,
// N = 16 columns): every instruction moves a few hundred KB at most, so the
// kernel is bound by bytes (and at trunk sizes by launch latency), never by
// integer throughput. The design is the plain tiled form: a block owns a
// 64-row stripe of one weight block, stages 64-deep K tiles of x and w in
// shared memory packed four int8 to an int32, and accumulates with __dp4a in
// int32 registers. Integer accumulation is exact with no 1024-term split;
// since the reference's f32 blocks are exact too, the two agree bit for bit.
// Tensor-core (mma / wgmma) tiles are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;        // rows of x per block
constexpr int KT = 64;        // K elements per shared-memory tile
constexpr int BN = 16;        // output columns (VTA block_out)
constexpr int THREADS = 256;  // 16 columns x 16 row groups, 4 rows each
constexpr int KQ = KT / 4;    // packed int32 words per tile row

__device__ __forceinline__ int pack4(const int8_t* p, int valid) {
  unsigned v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    unsigned byte = b < valid ? static_cast<unsigned>(static_cast<uint8_t>(p[b])) : 0u;
    v |= byte << (8 * b);
  }
  return static_cast<int>(v);
}

__global__ void __launch_bounds__(THREADS)
vta_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                int32_t* __restrict__ out, int w_d, int M, int K,
                long long w_nstride) {
  __shared__ int xs[TM][KQ + 1];
  __shared__ int ws[BN][KQ + 1];
  const int n = blockIdx.z, j = blockIdx.y, m0 = blockIdx.x * TM;
  const int8_t* xb = x + ((long long)n * w_d + j) * M * (long long)K;
  const int8_t* wb = w + n * w_nstride + (long long)j * K * BN;
  int32_t* ob = out + ((long long)n * w_d + j) * M * (long long)BN;
  const int tid = threadIdx.x;
  const int col = tid % BN, rg = tid / BN;
  const bool kvec = (K % 4) == 0 && (reinterpret_cast<uintptr_t>(x) % 4) == 0;
  int acc[4] = {0, 0, 0, 0};

  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int e = tid; e < TM * KQ; e += THREADS) {
      const int r = e / KQ, q = e % KQ;
      const int gm = m0 + r, gk = k0 + 4 * q;
      int v = 0;
      if (gm < M && gk < K) {
        const int8_t* p = xb + (long long)gm * K + gk;
        v = kvec ? *reinterpret_cast<const int*>(p) : pack4(p, K - gk);
      }
      xs[r][q] = v;
    }
    for (int e = tid; e < BN * KQ; e += THREADS) {
      const int c = e % BN, q = e / BN;
      unsigned v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int gk = k0 + 4 * q + b;
        if (gk < K)
          v |= static_cast<unsigned>(static_cast<uint8_t>(wb[(long long)gk * BN + c])) << (8 * b);
      }
      ws[c][q] = static_cast<int>(v);
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < KQ; ++q) {
      const int wv = ws[col][q];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = __dp4a(xs[rg + 16 * i][q], wv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + rg + 16 * i;
    if (row < M) ob[(long long)row * BN + col] = acc[i];
  }
}

}  // namespace

extern "C" int vta_gemm_launch(const void* x, const void* w, void* out, int n,
                               int w_d, int m, int k, long long w_nstride,
                               void* stream) {
  if (n <= 0 || w_d <= 0 || m <= 0) return 0;
  dim3 grid((m + TM - 1) / TM, w_d, n);
  vta_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), w_d, m, k, w_nstride);
  return static_cast<int>(cudaGetLastError());
}
