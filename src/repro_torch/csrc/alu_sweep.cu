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
// The header (stages, slots, slab descriptors: the words before `dst`) is
// what every operand read consults. It comes with the launch as a kernel
// parameter, so it costs no load from device memory, and each block copies
// it, with the slab tensors' pointers, into shared memory once. A thread
// loads its item's dst row and store position once, at the start, where
// the loads overlap the first taps' loads (a dst table staged in shared
// memory would add a round trip and a barrier before them).
//
// S threads of a warp (S a power of two, at most 32) share one item (image
// n, chain row g, lane). A `red` or `mac` stage gives thread `sub` the taps
// t = sub, sub + S, ...; the S partials meet by warp shuffles. The host takes
// S > 1 only where every split stage is order-free in int32 (wrapping add,
// mac, max, min: kernels/alu_sweep.py::sweep_plan), so the result is the
// same bit for bit at any S. Every other stage runs in all S threads alike;
// thread sub 0 writes. Within a thread, taps go in groups of up to BATCH:
// every row-index load of the group issues, then every slab-position load,
// then the value loads, so a group costs three memory latencies, not three
// per tap. A `seed_copy` just before a `red` or `mac` stage fetches its
// operand with that stage's first group, in the same three latencies.
//
// Sources are disjoint from the destination rows (chain legality), so the
// threads never race on acc; store positions are made unique on the host.
// int32 arithmetic wraps (done in unsigned), SHR is arithmetic with counts
// outside [0, 31] giving the sign fill, CLIP clamps to the host-computed
// abs(imm), stores clamp to [-128, 127] before narrowing to int8.
//
// Bound on this card: latency. Each element does a handful of integer ops
// per operand read, and the sweeps move int8 slabs and an int8 output (pool1)
// or a few acc rows (global average pool), far below both rates; what costs
// is each tap's chain of dependent loads (row index -> slab position ->
// value). The split shortens each thread's chain and fills the card where
// a sweep has few items (the global average pool: one row).
#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SLABS = 8;
constexpr int THREADS = 256;
constexpr int MAX_HEAD = 64;    // header words a launch passes
constexpr int BATCH = 8;        // taps whose loads issue together

enum Stage { SEED_IMM = 0, SEED_COPY = 1, SEED_MAC = 2, READ_DST = 3, MAC = 4,
             RED = 5, SRC = 6, IMM = 7, CLIP = 8 };
enum Bin { ADD = 0, MAX = 1, MIN = 2, SHR = 3, MUL = 4 };

struct Slabs {
  const void* ptr[MAX_SLABS];
  long long nstride[MAX_SLABS];
  int esize[MAX_SLABS];
};

struct Head {
  int w[MAX_HEAD];
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

// the neutral element of an order-free split op (ADD, MAX, MIN)
__device__ __forceinline__ int identity(int op) {
  return op == MAX ? INT_MIN : op == MIN ? INT_MAX : 0;
}

struct Ctx {
  const int32_t* acc;
  long long acc_base;
  const int32_t* meta;
  const int* head;        // shared-memory copy of the header
  int off_slabs, n_slabs, lanes, lane, gi, n;
  const Slabs* sl;        // shared-memory copy of the slab tensors
};

// Up to BATCH taps of one operand slot: rows, then (local operands) slab
// and position, then values, each phase issued for every tap before the
// next phase starts.
struct Taps {
  int v[BATCH];   // row index, then slab position, then value
  int s[BATCH];   // slab of a local operand
};

__device__ __forceinline__ void tap_rows(const Ctx& c, int slot, int t0,
                                         int step, int cnt, Taps& x) {
  const int* d = c.head + slot;
  const int ncols = d[2];
  const int32_t* rows = c.meta + d[1] + (ncols == 1 ? 0 : c.gi);
#pragma unroll
  for (int u = 0; u < BATCH; ++u)
    if (u < cnt) x.v[u] = __ldg(rows + (t0 + u * step) * ncols);
}

__device__ __forceinline__ void tap_positions(const Ctx& c, int slot, int cnt,
                                              Taps& x) {
  if (c.head[slot] == 0) return;         // acc operand: the row is the place
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    if (u >= cnt) continue;
    const int r = x.v[u];
    int s = 0;
    for (; s < c.n_slabs - 1; ++s) {
      const int* d = c.head + c.off_slabs + 4 * s;
      if (r >= d[0] && r < d[0] + d[1]) break;
    }  // the host checked every local row against the slabs
    const int* d = c.head + c.off_slabs + 4 * s;
    x.s[u] = s;
    x.v[u] = __ldg(c.meta + d[2] + (r - d[0]) * c.lanes + c.lane);
  }
}

__device__ __forceinline__ void tap_values(const Ctx& c, int slot, int cnt,
                                           Taps& x) {
  if (c.head[slot] == 0) {
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (u < cnt)
        x.v[u] = c.acc[c.acc_base + (long long)x.v[u] * c.lanes + c.lane];
    return;
  }
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    if (u >= cnt) continue;
    const int s = x.s[u], pos = x.v[u];
    const bool narrow = c.sl->esize[s] == 1;
    if (pos < 0) {      // the fill, taken in the tensor's dtype before widening
      const int fill = c.head[c.off_slabs + 4 * s + 3];
      x.v[u] = narrow ? static_cast<int>(static_cast<int8_t>(fill)) : fill;
      continue;
    }
    const long long at = c.n * c.sl->nstride[s] + pos;
    x.v[u] = narrow
        ? static_cast<int>(__ldg(static_cast<const int8_t*>(c.sl->ptr[s]) + at))
        : __ldg(static_cast<const int32_t*>(c.sl->ptr[s]) + at);
  }
}

// one operand value (tap t) of this thread's item
__device__ __forceinline__ int operand(const Ctx& c, int slot, int t) {
  Taps x;
  tap_rows(c, slot, t, 1, 1, x);
  tap_positions(c, slot, 1, x);
  tap_values(c, slot, 1, x);
  return x.v[0];
}

// taps t0, t0 + step, ... (cnt of them) of slot a into x and, if b >= 0, of
// slot b into y; if seed >= 0, tap 0 of slot seed into *sv. Each phase is
// issued for all of them before the next.
__device__ __forceinline__ void fetch(const Ctx& c, int a, int b, int seed,
                                      int t0, int step, int cnt, Taps& x,
                                      Taps& y, int* sv) {
  Taps z;
  tap_rows(c, a, t0, step, cnt, x);
  if (b >= 0) tap_rows(c, b, t0, step, cnt, y);
  if (seed >= 0) tap_rows(c, seed, 0, 1, 1, z);
  tap_positions(c, a, cnt, x);
  if (b >= 0) tap_positions(c, b, cnt, y);
  if (seed >= 0) tap_positions(c, seed, 1, z);
  tap_values(c, a, cnt, x);
  if (b >= 0) tap_values(c, b, cnt, y);
  if (seed >= 0) {
    tap_values(c, seed, 1, z);
    *sv = z.v[0];
  }
}

// the S partials of one item combined by op, in every one of its S threads
__device__ __forceinline__ int split_reduce(int op, int part, int S) {
  int mine = part;
  for (int o = S / 2; o > 0; o >>= 1)
    mine = binop(op, mine, __shfl_xor_sync(0xffffffffu, mine, o));
  return mine;
}

__global__ void __launch_bounds__(THREADS)
alu_sweep_kernel(int32_t* __restrict__ acc, long long acc_nstride,
                 const int32_t* __restrict__ meta, int n_stages, int off_slabs,
                 int n_slabs, int off_dst, int off_store, int g, int lanes,
                 long long total, int S, Head hd, Slabs sl,
                 int8_t* __restrict__ out, long long out_nstride,
                 int write_acc) {
  __shared__ int head[MAX_HEAD];
  __shared__ Slabs ssl;
  for (int i = threadIdx.x; i < off_dst; i += THREADS) head[i] = hd.w[i];
  if (static_cast<int>(threadIdx.x) < n_slabs) {
    ssl.ptr[threadIdx.x] = sl.ptr[threadIdx.x];
    ssl.nstride[threadIdx.x] = sl.nstride[threadIdx.x];
    ssl.esize[threadIdx.x] = sl.esize[threadIdx.x];
  }

  // a group past the end runs the last item and writes nothing, so that
  // every thread of the warp reaches the shuffles
  const long long own =
      (long long)blockIdx.x * (THREADS / S) + threadIdx.x / S;
  const bool active = own < total;
  const long long item = active ? own : total - 1;
  const int sub = threadIdx.x % S;
  Ctx c;
  c.lane = static_cast<int>(item % lanes);
  const long long row = item / lanes;
  c.gi = static_cast<int>(row % g);
  c.n = static_cast<int>(row / g);
  c.acc = acc;
  c.acc_base = c.n * acc_nstride;
  c.meta = meta;
  c.head = head;
  c.off_slabs = off_slabs;
  c.n_slabs = n_slabs;
  c.lanes = lanes;
  c.sl = &ssl;
  const int dst = __ldg(meta + off_dst + c.gi);
  const int pos = off_store >= 0
      ? __ldg(meta + off_store + c.gi * lanes + c.lane) : -1;
  __syncthreads();
  int v = 0;
  int seed = -1;     // a seed_copy's slot, fetched with the next tap stage
  for (int st = 0; st < n_stages; ++st) {
    const int op = head[4 * st], a = head[4 * st + 1], b = head[4 * st + 2],
              t_n = head[4 * st + 3];
    switch (op) {
      case SEED_IMM: v = a; break;
      case SEED_COPY:
        if (st + 1 < n_stages &&
            (head[4 * st + 4] == RED || head[4 * st + 4] == MAC))
          seed = a;
        else
          v = operand(c, a, 0);
        break;
      case SEED_MAC: {
        Taps x, y;
        fetch(c, a, b, -1, 0, 1, 1, x, y, nullptr);
        v = wmul(x.v[0], y.v[0]);
        break;
      }
      case READ_DST:
        v = acc[c.acc_base + (long long)dst * lanes + c.lane];
        break;
      case MAC:          // v += sum_t a_t * b_t; split: one partial a thread
      case RED: {        // v = v op a_0 op a_1 ...; split: order-free ops only
        const bool mac = op == MAC;
        const int bin = mac ? ADD : b;
        int part = 0;
        int t0 = sub;
        bool first = true;
        do {
          int cnt = t0 < t_n ? (t_n - t0 + S - 1) / S : 0;
          if (cnt > BATCH) cnt = BATCH;
          Taps x, y;
          fetch(c, a, mac ? b : -1, first ? seed : -1, t0, S, cnt, x, y, &v);
          if (first) part = S == 1 ? v : identity(bin);
          first = false;
#pragma unroll
          for (int u = 0; u < BATCH; ++u)
            if (u < cnt)
              part = mac ? wadd(part, wmul(x.v[u], y.v[u]))
                         : binop(bin, part, x.v[u]);
          t0 += BATCH * S;
        } while (t0 < t_n);
        seed = -1;
        v = S == 1 ? part : binop(bin, v, split_reduce(bin, part, S));
        break;
      }
      case SRC: v = binop(b, v, operand(c, a, 0)); break;
      case IMM: v = binop(a, v, b); break;
      default: v = v < -b ? -b : (v > b ? b : v); break;  // CLIP, b = abs(imm)
    }
  }
  if (!active || sub != 0) return;
  if (write_acc) acc[c.acc_base + (long long)dst * lanes + c.lane] = v;
  if (pos >= 0)
    out[c.n * out_nstride + pos] =
        static_cast<int8_t>(v < -128 ? -128 : (v > 127 ? 127 : v));
}

}  // namespace

extern "C" int alu_sweep_launch(void* acc, long long acc_nstride,
                                const void* meta, int n_stages, int off_slabs,
                                int n_slabs, int off_dst, int off_store, int g,
                                int lanes, int n, int split,
                                const int* header,
                                const void* const* slab_ptrs,
                                const long long* slab_nstride,
                                const int* slab_esize, void* out,
                                long long out_nstride, int write_acc,
                                void* stream) {
  if (n_slabs > MAX_SLABS || off_dst > MAX_HEAD || split < 1 || split > 32 ||
      (split & (split - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Head hd;
  for (int i = 0; i < off_dst; ++i) hd.w[i] = header[i];
  Slabs sl = {};
  for (int s = 0; s < n_slabs; ++s) {
    sl.ptr[s] = slab_ptrs[s];
    sl.nstride[s] = slab_nstride[s];
    sl.esize[s] = slab_esize[s];
  }
  const long long total = (long long)n * g * lanes;
  if (total == 0) return 0;
  const int per_block = THREADS / split;
  const unsigned blocks =
      static_cast<unsigned>((total + per_block - 1) / per_block);
  alu_sweep_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(acc), acc_nstride,
      static_cast<const int32_t*>(meta), n_stages, off_slabs, n_slabs, off_dst,
      off_store, g, lanes, total, split, hd, sl, static_cast<int8_t*>(out),
      out_nstride, write_acc);
  return static_cast<int>(cudaGetLastError());
}
