// Fused ALU stage-program interpreter: gather -> reduce -> scatter in one
// launch, for both the scratchpad-only chain and the DRAM-direct sweep.
//
// Replaces the TPU kernels src/repro/kernels/alu_sweep.py::pallas_chain
// (body eval_chain) and ::pallas_sweep (body eval_sweep). eval_chain is
// eval_sweep with every operand read from the acc scratchpad, no slabs and no
// store, so one kernel serves both.
//
// The stage program (the stage tuples of alu_sweep.py) is encoded by the host
// as int32 words in one device buffer `meta`, built once per chain and kept on
// the card, so a new stage program needs no new compile:
//   stages  n_stages x 4   [opcode, a, b, c]            (at offset 0)
//   slots   per operand 3  [kind 0=acc 1=local, rows offset, ncols]
//   slabs   n_slabs x 4    [first local row, rows, index offset, fill]
//   dst     g              destination acc rows (unique by chain legality)
//   store   g*lanes        flat output position per lane, -1 = no write
// plus the row vectors and slab index maps the offsets point at. A slab index
// of -1 is a masked lane (the slab's fill); a store position of -1 is a
// dropped lane: masked, or not the last writer of a duplicated position.
//
// One thread per (image n, chain row g, lane) walks the stages in registers.
// Sources are disjoint from the destination rows (chain legality), so the
// threads never race on acc; store positions are made unique on the host.
// int32 arithmetic wraps (done in unsigned), SHR is arithmetic with counts
// outside [0, 31] giving the sign fill, CLIP clamps to the host-computed
// abs(imm), stores clamp to [-128, 127] before narrowing to int8.
//
// Bound on this card: bytes. Each element does a handful of integer ops per
// operand read; the sweeps move int8 slabs and an int8 output (pool1) or a
// few acc rows (global average pool), all far below the compute rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SLABS = 8;
constexpr int THREADS = 256;

enum Stage { SEED_IMM = 0, SEED_COPY = 1, SEED_MAC = 2, READ_DST = 3, MAC = 4,
             RED = 5, SRC = 6, IMM = 7, CLIP = 8 };
enum Bin { ADD = 0, MAX = 1, MIN = 2, SHR = 3, MUL = 4 };

struct Slabs {
  const void* ptr[MAX_SLABS];
  long long nstride[MAX_SLABS];
  int esize[MAX_SLABS];
};

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ int binop(int op, int v, int s) {
  switch (op) {
    case ADD: return wadd(v, s);
    case MAX: return v > s ? v : s;
    case MIN: return v < s ? v : s;
    case SHR: return (s < 0 || s > 31) ? (v >> 31) : (v >> s);
    default:  return wmul(v, s);
  }
}

struct Ctx {
  const int32_t* acc;
  long long acc_base;
  const int32_t* meta;
  int off_slabs, n_slabs, lanes, lane, gi, n;
  const Slabs* sl;
};

__device__ int local_val(const Ctx& c, int r) {
  for (int s = 0; s < c.n_slabs; ++s) {
    const int32_t* d = c.meta + c.off_slabs + 4 * s;
    if (r >= d[0] && r < d[0] + d[1]) {
      const int pos = c.meta[d[2] + (r - d[0]) * c.lanes + c.lane];
      const bool narrow = c.sl->esize[s] == 1;
      if (pos < 0)  // the fill, taken in the tensor's dtype before widening
        return narrow ? static_cast<int>(static_cast<int8_t>(d[3])) : d[3];
      const long long at = c.n * c.sl->nstride[s] + pos;
      return narrow
          ? static_cast<int>(static_cast<const int8_t*>(c.sl->ptr[s])[at])
          : static_cast<const int32_t*>(c.sl->ptr[s])[at];
    }
  }
  return 0;  // unreachable: the host checks every local row against the slabs
}

// operand slot `slot`, tap t, for this thread's chain row
__device__ __forceinline__ int operand(const Ctx& c, int slot, int t) {
  const int32_t* d = c.meta + slot;
  const int ncols = d[2];
  const int row = c.meta[d[1] + t * ncols + (ncols == 1 ? 0 : c.gi)];
  if (d[0] == 0) return c.acc[c.acc_base + (long long)row * c.lanes + c.lane];
  return local_val(c, row);
}

__global__ void __launch_bounds__(THREADS)
alu_sweep_kernel(int32_t* __restrict__ acc, long long acc_nstride,
                 const int32_t* __restrict__ meta, int n_stages, int off_slabs,
                 int n_slabs, int off_dst, int off_store, int g, int lanes,
                 long long total, Slabs sl, int8_t* __restrict__ out,
                 long long out_nstride, int write_acc) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  Ctx c;
  c.lane = static_cast<int>(tid % lanes);
  c.gi = static_cast<int>((tid / lanes) % g);
  c.n = static_cast<int>(tid / ((long long)lanes * g));
  c.acc = acc;
  c.acc_base = c.n * acc_nstride;
  c.meta = meta;
  c.off_slabs = off_slabs;
  c.n_slabs = n_slabs;
  c.lanes = lanes;
  c.sl = &sl;
  const int dst = meta[off_dst + c.gi];
  int v = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int op = meta[4 * s], a = meta[4 * s + 1], b = meta[4 * s + 2],
              t_n = meta[4 * s + 3];
    switch (op) {
      case SEED_IMM: v = a; break;
      case SEED_COPY: v = operand(c, a, 0); break;
      case SEED_MAC: v = wmul(operand(c, a, 0), operand(c, b, 0)); break;
      case READ_DST: v = acc[c.acc_base + (long long)dst * lanes + c.lane]; break;
      case MAC:
        for (int t = 0; t < t_n; ++t)
          v = wadd(v, wmul(operand(c, a, t), operand(c, b, t)));
        break;
      case RED:
        for (int t = 0; t < t_n; ++t) v = binop(b, v, operand(c, a, t));
        break;
      case SRC: v = binop(b, v, operand(c, a, 0)); break;
      case IMM: v = binop(a, v, b); break;
      default: v = v < -b ? -b : (v > b ? b : v); break;  // CLIP, b = abs(imm)
    }
  }
  if (write_acc) acc[c.acc_base + (long long)dst * lanes + c.lane] = v;
  if (off_store >= 0) {
    const int pos = meta[off_store + c.gi * lanes + c.lane];
    if (pos >= 0)
      out[c.n * out_nstride + pos] =
          static_cast<int8_t>(v < -128 ? -128 : (v > 127 ? 127 : v));
  }
}

}  // namespace

extern "C" int alu_sweep_launch(void* acc, long long acc_nstride,
                                const void* meta, int n_stages, int off_slabs,
                                int n_slabs, int off_dst, int off_store, int g,
                                int lanes, int n, const void* const* slab_ptrs,
                                const long long* slab_nstride,
                                const int* slab_esize, void* out,
                                long long out_nstride, int write_acc,
                                void* stream) {
  if (n_slabs > MAX_SLABS) return static_cast<int>(cudaErrorInvalidValue);
  Slabs sl = {};
  for (int s = 0; s < n_slabs; ++s) {
    sl.ptr[s] = slab_ptrs[s];
    sl.nstride[s] = slab_nstride[s];
    sl.esize[s] = slab_esize[s];
  }
  const long long total = (long long)n * g * lanes;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  alu_sweep_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(acc), acc_nstride,
      static_cast<const int32_t*>(meta), n_stages, off_slabs, n_slabs, off_dst,
      off_store, g, lanes, total, sl, static_cast<int8_t*>(out), out_nstride,
      write_acc);
  return static_cast<int>(cudaGetLastError());
}
