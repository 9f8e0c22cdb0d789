"""PyTorch executor of the lowered tensor-op trace (port of vta/fsim_jax.py).

Executes exactly the trace ``vta/lowering.py`` produces, batched over a
leading image axis N: scratchpads are (N, depth, ...) tensors, per-image DRAM
tensors are flat (N, L) tensors, and tensors the batch shares (weights,
biases) are flat (L,) tensors with no N axis — gathers from them broadcast.

A trace is split once into entries whose index maps live on the device
(``_device_ops``, the port of ``fsim_jax._spec_of``, memoized on the Trace
per device and ``alu_fusion``), so a dispatch copies no index map, and the
entries into chunks (``_chunk_plan``, the port of ``fsim_jax._spec_chunks``:
at most ``chunk_cap`` entries, a compiler-marked fused segment whole). A
chunk is one dispatch: on the card one CUDA graph, captured on the first
dispatch of its (trace, batch, shared tensors) key and replayed after
(``TorchBackend``); ``kernel_launch_log`` counts dispatches and
``capture_log`` captures, per ``set_capture_scope`` label. Each entry runs
as (``_exec``):

  * ``gemm`` — the whole instruction through the ``"gemm"`` kernel
    (``csrc/vta_gemm.cu`` on the card): row gathers, products and the exact
    int32 add into acc, one launch for all weight blocks and all images. Its
    index vectors are int32. The per-group weight form (``w_d = 0`` in the
    JAX backend: the ResNet ``fc``) is the same entry with one weight block
    per group.
  * ``aluchain`` / ``alusweep`` — the fused stage programs through the
    ``"alu_chain"`` / ``"alu_sweep"`` kernels (``csrc/alu_sweep.cu``).
  * ``gather`` / ``alu`` / ``alufused`` / ``store`` / ``spill`` — PyTorch
    indexing on the device, as in the JAX backend.

Integer semantics match numpy bit for bit: int32 wraparound, arithmetic right
shift (counts outside [0, 31] give the sign fill), stores clamp to
[-128, 127] before the int8 cast, masked gather lanes take ``fill`` in the
tensor's dtype. Scatters whose indices lowering does not prove unique keep
the last writer, precomputed on the host; masked store lanes are filtered out
before the write. No entry synchronizes with the host or allocates by data,
which is what lets a chunk be captured.

``TorchBackend()`` runs on the card (``"cuda"`` kernels) and raises where
there is none; ``TorchBackend(device="cpu")`` runs the plain versions, the
same chunks eagerly through the same buffers. ``capture=False`` (or
``.uncaptured()``) is the route for a program that runs once, the
autotuner's verification of a candidate: the same chunks and kernels,
eagerly, with no plan, no graph and no device memo left on the Trace
(``uncaptured_runs`` counts its calls).

Serving workers (serve/workers.py) call one backend from several threads,
each on a CUDA stream of its own. So every memo a captured graph reads
(device entries, chunks, scalars, stage programs) is built once under a
lock and never replaced, a plan belongs to one ``set_capture_scope`` label
(a worker owns its buffers and graphs), a capture records its launches on
its own thread, and a plan entered from two streams orders them by an
event. A memo is filled by ``torch.tensor``/``.to`` from host memory, a
copy that blocks until it is done: that is what lets any stream read it
without waiting on the stream that built it.
"""
from __future__ import annotations

import collections
import copy
import functools
import itertools
import threading
import types
import weakref
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import add_launch_counts, recording_launches
from repro_torch.kernels.alu_sweep import SweepProgram, last_writer_positions
from repro_torch.kernels.registry import get_kernel
from repro_torch.vta.isa import AluOp, Buffer, VTAConfig
from repro_torch.vta.backend import lowered
from repro_torch.vta.lowering import (AluSweep, GatherLoad, GemmOp,
                                      ScatterStore, SpillStore, Trace,
                                      UopLoad, scatter_hints)
from repro_torch.vta.runtime import Program

_BUF_KEY = {int(Buffer.INP): "inp", int(Buffer.WGT): "wgt",
            int(Buffer.ACC): "acc"}
_BUF_DTYPE = {int(Buffer.INP): torch.int8, int(Buffer.WGT): torch.int8,
              int(Buffer.ACC): torch.int32}
_SCALARS: dict = {}
# guards every memo a captured graph reads (scalars, device entries, chunks,
# plans, trace keys): each entry is made once and never replaced, since a
# graph keeps the addresses of the tensors it was captured with
_MEMO_LOCK = threading.RLock()


def _scalar(value: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``value`` in ``dtype`` (wrapping) on ``device``, made
    once: a fresh one per op would be a host-to-device copy per op."""
    key = (value, dtype, str(device))
    with _MEMO_LOCK:
        t = _SCALARS.get(key)
        if t is None:
            t = _SCALARS[key] = torch.tensor(value).to(dtype).to(device)
    return t


# ---------------------------------------------------------------------------
# Host-side helpers (ports of fsim_jax's static proofs)
# ---------------------------------------------------------------------------
def _winners(idx: np.ndarray, mask: Optional[np.ndarray] = None):
    """(target indices, lane positions) that reproduce a sequential
    ``x[idx] = v`` with masked lanes dropped: the last writer of each index
    wins. Lane positions are None when every lane writes."""
    flat = np.asarray(idx).reshape(-1)
    unique = mask is None and scatter_hints(flat)[0]
    pos = last_writer_positions(flat, mask, unique)
    lanes = np.flatnonzero(pos >= 0)
    if len(lanes) == pos.size:
        return pos, None
    return pos[lanes], lanes


def _fuse_sweep(op: AluSweep):
    """``fsim_jax._fuse_sweep``: a multi-step ADD/MAX/MIN/MAC macro sweep
    whose steps all write the SAME destination grid from sources disjoint
    with it runs as one gather -> reduce -> scatter. Returns
    ``(alu_op, dst, srcs, src2)`` or None."""
    if op.use_imm or op.overwrite or len(op.steps) < 2:
        return None
    if op.alu_op not in (AluOp.MAC, AluOp.ADD, AluOp.MAX, AluOp.MIN):
        return None
    s0 = op.steps[0]
    for s in op.steps:
        if s.src is None or not np.array_equal(s.dst, s0.dst):
            return None
    dset = set(s0.dst.tolist())
    for s in op.steps:
        if dset.intersection(s.src.tolist()):
            return None
        if op.alu_op == AluOp.MAC and s.src2 in dset:
            return None
    srcs = np.stack([s.src for s in op.steps])          # (T, g)
    src2 = np.array([max(s.src2, 0) for s in op.steps], np.int32)
    return int(op.alu_op), s0.dst, srcs, src2


def _weight_blocks(rows: np.ndarray):
    """``fsim_jax._weight_blocks``: (distinct weight-index blocks, group
    permutation) for a GEMM whose per-group weight rows repeat, else None."""
    g = len(rows)
    same0 = (rows == rows[0]).all(axis=1)
    p = int(np.argmax(same0[1:])) + 1 if same0[1:].any() else g
    if p <= 16 and g % p == 0 and \
            bool((rows.reshape(g // p, p, -1) == rows[:p]).all()):
        perm = np.arange(g).reshape(g // p, p).T.reshape(-1)
        return rows[:p], perm
    wrows, inv = np.unique(rows, axis=0, return_inverse=True)
    counts = np.bincount(inv)
    if len(wrows) <= 16 and bool((counts == counts[0]).all()):
        return wrows, np.argsort(inv, kind="stable")
    return None


def _reduction_run(acc_idx: np.ndarray) -> int:
    """Largest R with ``acc_idx.reshape(-1, R)`` constant per row."""
    n = len(acc_idx)
    changes = np.flatnonzero(np.diff(acc_idx))
    R = int(changes[0]) + 1 if len(changes) else n
    if R <= 1 or n % R:
        return 1
    rows = acc_idx.reshape(-1, R)
    return R if bool((rows == rows[:, :1]).all()) else 1


def _sweep_program(c, hw: VTAConfig) -> SweepProgram:
    """Encode one lowered ``AluChain`` (scratchpad-only or DRAM-direct)."""
    lanes = (hw.batch, hw.block_out)
    if not (c.store is not None or c.slabs):
        return SweepProgram(c.stages, c.dst, [("acc", a) for a in c.args],
                            lane_shape=lanes, unique=c.unique)
    ops = []
    for src, arr in zip(c.arg_src, c.args):
        ops.append(("acc", arr) if isinstance(src, str) else ("local", src[1]))
    store = None
    if c.store is not None:
        st = c.store
        affine = starts = None
        if st.affine is not None:
            view_shape, perm, sizes, starts = st.affine
            affine = (view_shape, perm, sizes)
        store = (st.tensor, st.index, st.mask, st.unique, affine, starts)
    return SweepProgram(
        c.stages, c.dst, ops, lane_shape=lanes,
        slabs=tuple((t.tensor, t.index, t.mask, t.fill) for t in c.slabs),
        write_acc=c.write_acc, unique=c.unique, store=store)


# ---------------------------------------------------------------------------
# Trace -> host entries -> device entries
# ---------------------------------------------------------------------------
def _device_ops(trace: Trace, device: torch.device,
                alu_fusion: bool = True) -> list:
    """The trace as device entries: the port of ``fsim_jax._spec_of``,
    with every index map moved to ``device`` once and memoized on the Trace
    per (device, ``alu_fusion``) (serving replays one trace per dispatch).
    With ``alu_fusion`` every fusable AluSweep run lowering marked
    (``Trace.alu_chains``) is one ``aluchain``/``alusweep`` entry at its
    head op and the feeder gathers and absorbed stores it covers are gone
    (``Trace.elided``); without it every op is its own entry. Each entry is
    a tuple whose first element is its kind; scatters carry their
    last-writer winners (``_winners``). Built once, under the memo lock."""
    key = (str(device), alu_fusion)
    with _MEMO_LOCK:
        memo = trace.__dict__.setdefault("_torch_ops", {})
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = _build_ops(trace, device, alu_fusion)
    return hit


def _build_ops(trace: Trace, device: torch.device, alu_fusion: bool) -> list:
    """``_device_ops``' entries, built anew."""
    def ix(a):
        if a is None:
            return None
        return torch.from_numpy(np.asarray(a, np.int64).copy()).to(device)

    def ix32(a):
        return torch.from_numpy(np.asarray(a, np.int32).copy()).to(device)

    def put_args(idx, mask=None):
        tgt, lanes = _winners(idx, mask)
        return ix(tgt), ix(lanes)

    chains = trace.alu_chains if alu_fusion else ()
    heads = {c.members[0]: c for c in chains}
    members = {m for c in chains for m in c.members}
    elided = trace.elided if alu_fusion else frozenset()
    ops: list = []
    for i, op in enumerate(trace.ops):
        if op is None or isinstance(op, UopLoad):
            continue
        if i in elided:
            continue     # feeder gather / absorbed store of a direct sweep
        if i in members:
            c = heads.get(i)
            if c is None:
                continue              # executed by the head's chain kernel
            kind = "alusweep" if (c.store is not None or c.slabs) \
                else "aluchain"
            ops.append((kind, _sweep_program(c, trace.hw)))
        elif isinstance(op, GatherLoad):
            mask = None if op.mask is None else torch.from_numpy(
                op.mask.reshape(-1).copy()).to(device)
            ops.append(("gather", int(op.buffer), op.tensor, int(op.base),
                        ix(op.index.reshape(-1)), mask, int(op.fill),
                        tuple(op.index.shape)))
        elif isinstance(op, GemmOp):
            if op.reset:
                ops.append(("gemm_reset", ix(np.unique(op.acc_idx))))
                continue
            hw = trace.hw
            for idx, depth in ((op.acc_idx, hw.acc_depth),
                               (op.inp_idx, hw.inp_depth),
                               (op.wgt_idx, hw.wgt_depth)):
                if idx.size and (idx.min() < 0 or idx.max() >= depth):
                    # the CUDA kernel reads and writes where they point
                    raise ValueError("gemm row index outside its scratchpad")
            R = _reduction_run(op.acc_idx)
            uidx = op.acc_idx[::R]
            g = len(uidx)
            unique = len(np.unique(uidx)) == g
            grouped = _weight_blocks(op.wgt_idx.reshape(g, R))
            if grouped is not None:
                wrows, perm = grouped
                ops.append(("gemm", R, len(wrows), ix32(uidx[perm]),
                            ix32(op.inp_idx.reshape(g, R)[perm].reshape(-1)),
                            ix32(wrows.reshape(-1)), unique))
            else:
                # per-group weights (the fc): one weight block per group
                ops.append(("gemm", R, g, ix32(uidx), ix32(op.inp_idx),
                            ix32(op.wgt_idx), unique))
        elif isinstance(op, AluSweep):
            fused = _fuse_sweep(op)
            if fused is not None:
                alu_op, dst, srcs, src2 = fused
                ops.append(("alufused", alu_op, ix(dst), *put_args(dst),
                            ix(srcs), ix(src2)))
                continue
            steps = [(max(s.src2, 0), ix(s.dst), *put_args(s.dst), ix(s.src))
                     for s in op.steps]
            ops.append(("alu", int(op.alu_op), op.use_imm, int(op.imm),
                        op.overwrite, steps))
        elif isinstance(op, ScatterStore):
            ops.append(("store", op.tensor, int(op.base), op.index.shape[0],
                        *put_args(op.index, op.mask)))
        elif isinstance(op, SpillStore):
            ops.append(("spill", ix(op.src), *put_args(op.dst)))
        else:
            raise TypeError(type(op))
    return ops


# Whole-segment fusion runs a compiler-marked segment program
# (``Program.fused_segment``: a conv -> add -> clip pipeline, a resident
# spill chain) as ONE chunk, so one dispatch; longer programs fall back to
# the capped chunk sequence (``fsim_jax.SEGMENT_FUSION_MAX_OPS``).
SEGMENT_FUSION_MAX_OPS = 256


def _chunks(ops: list, cap: int = 24):
    """``fsim_jax._chunks``: blocks of at most ``cap`` entries, a block
    closed early at a ``store`` once half full."""
    block: list = []
    for e in ops:
        block.append(e)
        if len(block) >= cap or (e[0] == "store" and len(block) >= cap // 2):
            yield tuple(block)
            block = []
    if block:
        yield tuple(block)


def _chunk_plan(trace: Trace, device: torch.device, cap: int,
                alu_fusion: bool, segment_fusion: bool) -> list:
    """``fsim_jax._spec_chunks``: the trace's device entries split into
    dispatches, memoized on the Trace per (device, ``cap``,
    ``alu_fusion``, whole-segment). A fused segment of at most
    ``SEGMENT_FUSION_MAX_OPS`` entries is one chunk."""
    fuse_all = segment_fusion and trace.fused_segment
    key = (str(device), cap, alu_fusion, fuse_all)
    with _MEMO_LOCK:
        memo = trace.__dict__.setdefault("_torch_chunks", {})
        hit = memo.get(key)
        if hit is None:
            hit = memo[key] = _split_chunks(
                _device_ops(trace, device, alu_fusion), cap, fuse_all)
    return hit


def _split_chunks(ops: list, cap: int, fuse_all: bool) -> list:
    """``ops`` as dispatches: one chunk for a fused segment of at most
    ``SEGMENT_FUSION_MAX_OPS`` entries, else ``_chunks``."""
    if fuse_all and len(ops) <= SEGMENT_FUSION_MAX_OPS:
        return [tuple(ops)] if ops else []
    return list(_chunks(ops, cap))


def _put(arr, tgt, lanes, val) -> None:
    """``arr[:, idx] = val`` as a sequential scatter: ``tgt``/``lanes`` are
    ``_winners(idx)`` on the device."""
    arr[:, tgt] = val if lanes is None else val[:, lanes]


def _binop(alu_op: int, dst, src):
    if alu_op == int(AluOp.ADD):
        return dst + src
    if alu_op == int(AluOp.MAX):
        return torch.maximum(dst, src)
    if alu_op == int(AluOp.MIN):
        return torch.minimum(dst, src)
    if alu_op == int(AluOp.SHR):
        return torch.bitwise_right_shift(dst, src)
    if alu_op == int(AluOp.MUL):
        return dst * src
    raise ValueError(alu_op)


def _exec(ops: list, st: dict, gemm_impl: str, alu_impl: str) -> None:
    """Apply the device entries to ``st`` (scratchpads + flat tensors)."""
    acc = st["acc"]
    n = acc.shape[0]
    gemm = get_kernel("gemm", gemm_impl)
    chain = get_kernel("alu_chain", alu_impl)
    sweep = get_kernel("alu_sweep", alu_impl)
    tensors = st["tensors"]
    for e in ops:
        kind = e[0]
        if kind == "gather":
            _, buf, tensor, base, idx, m, fill, shape = e
            flat = tensors[tensor]
            src = flat[..., idx]
            if m is not None:
                src = torch.where(m.reshape(-1), src,
                                  _scalar(fill, src.dtype, src.device))
            src = src.reshape(src.shape[:-1] + shape)
            st[_BUF_KEY[buf]][:, base:base + shape[0]] = \
                src.to(_BUF_DTYPE[buf])
        elif kind == "gemm_reset":
            acc[:, e[1]] = _scalar(0, torch.int32, acc.device)
        elif kind == "gemm":
            _, R, w_d, uidx, inp_idx, wrows, unique = e
            gemm(acc, st["inp"], st["wgt"], uidx, inp_idx, wrows, R, w_d,
                 unique)
        elif kind == "alu":
            _, alu_op, use_imm, imm, overwrite, steps = e
            imm_t = _scalar(imm, torch.int32, acc.device)
            for src2, dst, tgt, lanes, src in steps:
                if alu_op == int(AluOp.MAC):
                    prod = acc[:, src] * acc[:, src2][:, None]
                    _put(acc, tgt, lanes,
                         prod if overwrite else acc[:, dst] + prod)
                    continue
                s = imm_t if use_imm else acc[:, src]
                if overwrite:
                    _put(acc, tgt, lanes, s.expand(acc[:, dst].shape))
                    continue
                d = acc[:, dst]
                if alu_op == int(AluOp.CLIP):
                    bound = abs(int(imm))
                    r = torch.clamp(d, -bound, bound)
                else:
                    r = _binop(alu_op, d, s)
                _put(acc, tgt, lanes, r)
        elif kind == "aluchain":
            chain(acc, e[1])
        elif kind == "alusweep":
            prog = e[1]
            flats = [tensors[t] for t in prog.slab_tensors]
            out = tensors[prog.store_tensor] if prog.store is not None \
                else None
            sweep(acc, prog, flats, out)
        elif kind == "alufused":
            _, alu_op, dst, tgt, lanes, srcs, src2 = e
            src = acc[:, srcs]                           # (N, T, g, BV, BO)
            if alu_op == int(AluOp.MAC):
                r = acc[:, dst] + (src * acc[:, src2][:, :, None]).sum(
                    1, dtype=torch.int64).to(torch.int32)
            elif alu_op == int(AluOp.ADD):
                r = acc[:, dst] + src.sum(1, dtype=torch.int64).to(
                    torch.int32)
            elif alu_op == int(AluOp.MAX):
                r = torch.maximum(acc[:, dst], src.amax(1))
            else:
                r = torch.minimum(acc[:, dst], src.amin(1))
            _put(acc, tgt, lanes, r)
        elif kind == "store":
            _, tensor, base, cnt, tgt, lanes = e
            vals = torch.clamp(acc[:, base:base + cnt], -128, 127) \
                .to(torch.int8).reshape(n, -1)
            _put(tensors[tensor], tgt, lanes, vals)
        elif kind == "spill":
            _, src, tgt, lanes = e
            vals = torch.clamp(acc[:, src], -128, 127).to(torch.int8)
            _put(st["inp"], tgt, lanes, vals)
        else:
            raise ValueError(kind)


# ---------------------------------------------------------------------------
# Dispatch accounting (the port of fsim_jax's trace and launch logs)
# ---------------------------------------------------------------------------
# One count per chunk dispatch: on the card one CUDA-graph replay (or, on a
# key's first dispatch, the eager run that precedes its capture); on the CPU
# one eager pass over the chunk. ``kernel_launch_log`` is the hook the
# fusion tests use to show a fused segment really is ONE dispatch.
_DISPATCHES = 0
_COUNT_LOCK = threading.Lock()

# Captures, keyed on (trace key, chunk index, arg shapes, batch, scope): a
# CUDA graph bakes in the addresses of its chunk's index tensors, so unlike
# an XLA executable it is never shared between two chunks of one spec. On
# the CPU a key counts once, at its first dispatch, as jit's trace-once
# does. Serving any number of batches at a bucket leaves every key at 1.
_CAPTURES: collections.Counter = collections.Counter()
_SCOPE = threading.local()
_TRACE_KEYS = itertools.count()
# scoped plans by their label: {label: {(id(trace's plans), key): plans}};
# an unscoped plan lives and dies with its Trace
_SCOPE_PLANS: dict = {}


def set_capture_scope(label: Optional[str]) -> Optional[str]:
    """Set this thread's capture-scope label (a serving worker's id; the
    counterpart of ``fsim_jax.set_xla_trace_scope``); returns the previous
    label so callers can restore it. ``None`` is unscoped, the default."""
    prev = getattr(_SCOPE, "label", None)
    _SCOPE.label = label
    return prev


def capture_scope() -> Optional[str]:
    return getattr(_SCOPE, "label", None)


def release_capture_scope(label: str) -> int:
    """Drop every plan made under the scope ``label`` (its buffers, graphs
    and graph memory pool go with the last reference): a retired worker's
    captures.
    The next dispatch of one of its keys under ``label`` captures again.
    Returns the number of plans dropped."""
    with _MEMO_LOCK:
        entries = _SCOPE_PLANS.pop(label, {})
        return sum(plans.pop(sig, None) is not None
                   for (_, sig), plans in entries.items())


def reset_capture_log() -> None:
    with _COUNT_LOCK:
        _CAPTURES.clear()


def capture_log() -> dict:
    """{(trace key, chunk index, arg shapes, batch, scope): captures} since
    the last ``reset_capture_log``. A value above 1 means a known chunk was
    captured again."""
    with _COUNT_LOCK:
        return dict(_CAPTURES)


def reset_kernel_launch_log() -> None:
    global _DISPATCHES
    with _COUNT_LOCK:
        _DISPATCHES = 0


def kernel_launch_log() -> int:
    """Chunk dispatches since the last ``reset_kernel_launch_log``."""
    return _DISPATCHES


def _count_dispatch() -> None:
    global _DISPATCHES
    with _COUNT_LOCK:
        _DISPATCHES += 1


# Runs of the uncaptured route (``TorchBackend(capture=False)``): one per
# ``run_batched``/``run`` call, however many chunks it dispatches
_UNCAPTURED_RUNS = 0


def reset_uncaptured_runs() -> None:
    global _UNCAPTURED_RUNS
    with _COUNT_LOCK:
        _UNCAPTURED_RUNS = 0


def uncaptured_runs() -> int:
    """Calls of the uncaptured route since ``reset_uncaptured_runs``."""
    return _UNCAPTURED_RUNS


def _arg_shapes(x) -> tuple:
    """Shapes of the index tensors of a chunk's entries, in order."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape),)
    if isinstance(x, (tuple, list)):
        return tuple(s for v in x for s in _arg_shapes(v))
    return ()


def _note_capture(trace: Trace, chunks: list, n: int) -> None:
    with _MEMO_LOCK:
        key = trace.__dict__.get("_torch_key")
        if key is None:
            key = trace.__dict__["_torch_key"] = next(_TRACE_KEYS)
    scope = capture_scope()
    with _COUNT_LOCK:
        for i, chunk in enumerate(chunks):
            _CAPTURES[(key, i, _arg_shapes(chunk), n, scope)] += 1


# CUDA streams given to owners (serving workers, capture threads), by
# ``cuda_stream`` handle: PyTorch hands its pooled streams out in turn, so a
# plain ``torch.cuda.Stream(device)`` can be one that another owner runs on,
# and that owner's work would then join this one's captures and break both
POOLED_STREAMS = 32          # PyTorch's pool of streams of one priority
_STREAM_LOCK = threading.Lock()
_STREAM_OWNERS: dict = {}    # cuda_stream handle -> owner label


def claim_stream(device: torch.device, owner: str) -> torch.cuda.Stream:
    """A stream of PyTorch's pool on ``device`` that no other owner holds,
    registered to ``owner`` until ``release_stream``: drawn from
    ``torch.cuda.Stream(device)`` until one is free. Raises when all
    ``POOLED_STREAMS`` are held."""
    with _STREAM_LOCK:
        for _ in range(POOLED_STREAMS):
            stream = torch.cuda.Stream(device)
            if stream.cuda_stream not in _STREAM_OWNERS:
                _STREAM_OWNERS[stream.cuda_stream] = owner
                return stream
        held = sorted(_STREAM_OWNERS.values())
    raise RuntimeError(f"{owner}: all {POOLED_STREAMS} pooled CUDA streams "
                       f"of {device} are held, by {held}")


def release_stream(stream: torch.cuda.Stream) -> None:
    """Give ``stream`` back: a later ``claim_stream`` may hand it out."""
    with _STREAM_LOCK:
        _STREAM_OWNERS.pop(stream.cuda_stream, None)


class _SideStream:
    """A thread's capture stream on one device, claimed at creation and
    released when the thread ends (its thread-local storage, the only
    holder, is dropped then)."""

    def __init__(self, device: torch.device):
        self.stream = claim_stream(
            device, f"capture thread {threading.current_thread().name}")
        weakref.finalize(self, release_stream, self.stream)


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream this thread captures on: its current stream (a serving
    worker's own), or, where that is the default stream, on which CUDA
    cannot capture, a side stream the thread claims once
    (``claim_stream``), so that it is no other owner's."""
    stream = torch.cuda.current_stream(device)
    if stream != torch.cuda.default_stream(device):
        return stream
    side = getattr(_SCOPE, "side_streams", None)
    if side is None:
        side = _SCOPE.side_streams = {}
    if device not in side:
        side[device] = _SideStream(device)
    return side[device].stream


# ---------------------------------------------------------------------------
# Static state of one (trace, batch, shared tensors) key
# ---------------------------------------------------------------------------
def _scratchpads(trace: Trace, hw: VTAConfig, n: int, shared: dict,
                 device: torch.device) -> dict:
    """Zeroed inp, wgt and acc scratchpads for ``n`` images: one wgt for
    the batch when every tensor gathered into it is shared (weights)."""
    wgt_src = trace.__dict__.get("_wgt_sources")
    if wgt_src is None:             # tensors gathered into WGT, once
        wgt_src = trace.__dict__["_wgt_sources"] = {
            op.tensor for op in trace.ops if isinstance(op, GatherLoad)
            and op.buffer == Buffer.WGT}
    nw = 1 if wgt_src <= set(shared) else n
    zeros = functools.partial(torch.zeros, device=device)
    return {"inp": zeros((n, hw.inp_depth, hw.batch, hw.block_in),
                         dtype=torch.int8),
            "wgt": zeros((nw, hw.wgt_depth, hw.block_out, hw.block_in),
                         dtype=torch.int8),
            "acc": zeros((n, hw.acc_depth, hw.batch, hw.block_out),
                         dtype=torch.int32)}


class _Plan:
    """The buffers every dispatch of one key runs in: the scratchpads and
    one (N, L) tensor per batched tensor, allocated once (outside any graph
    pool), plus the captured graphs and the chunks they were captured from
    (whose index tensors they read). A dispatch copies its inputs in, runs
    or replays the chunks and clones the stored tensors out, under
    ``lock``; on the card it first makes its stream wait for ``done``,
    which the last dispatch recorded after its clone, so a plan entered
    from two streams never has its buffers overwritten while still read.
    Shared tensors already on the device (weights) are read in place: the
    key holds their ``data_ptr``s, so new weights get a new plan. Any other
    shared input is copied into a buffer of its own."""

    def __init__(self, trace: Trace, hw: VTAConfig, n: int, batched: dict,
                 shared: dict, in_place: set, device: torch.device):
        self.inputs = {k: torch.empty((n, v[0].numel()), dtype=v.dtype,
                                      device=device)
                       for k, v in batched.items()}
        self.inputs.update({k: torch.empty(v.numel(), dtype=v.dtype,
                                           device=device)
                            for k, v in shared.items() if k not in in_place})
        self.in_place = in_place
        self.st = {**_scratchpads(trace, hw, n, shared, device),
                   "tensors": dict(self.inputs)}
        self.warm = False               # the first dispatch has run
        self.graphs: Optional[list] = None   # [(graph, launches)], card
        self.chunks: Optional[list] = None   # what the graphs captured
        self.pool = None
        self.lock = threading.Lock()
        self.done = torch.cuda.Event() if device.type == "cuda" else None

    def load(self, n: int, batched: dict, shared: dict) -> None:
        for k, v in batched.items():
            self.inputs[k].copy_(v.reshape(n, -1))
        for k, v in shared.items():
            if k in self.in_place:
                self.st["tensors"][k] = v.reshape(-1)
            else:
                self.inputs[k].copy_(v.reshape(-1))

    def unload(self) -> None:
        """Drop the references to in-place shared tensors, so a plan left
        behind by new weights keeps no old ones alive."""
        for k in self.in_place:
            self.st["tensors"].pop(k, None)


# ---------------------------------------------------------------------------
# The backend object
# ---------------------------------------------------------------------------
class TorchBackend:
    """PyTorch executor of the lowered trace, batched over images.

    ``device`` defaults to ``"cuda"`` with the hand-written kernels
    (``gemm_impl = alu_impl = "cuda"``) and raises when no CUDA device is
    present; ``device="cpu"`` runs the plain versions (``"torch"``).

    The knobs mirror ``fsim_jax.JaxBackend``: the trace runs as chunks of at
    most ``chunk_cap`` entries (``_chunk_plan``); ``alu_fusion`` runs each
    fused ALU chain as one stage-program kernel, ``segment_fusion`` a
    compiler-marked segment as one chunk. Both off is the per-op chunked
    baseline. On the card the first dispatch of a (trace, batch, shared
    tensors) key runs eagerly (warming every device-side cache: scalars,
    stage programs, the kernel build) and then captures each chunk as one
    CUDA graph into one memory pool of the key; every later dispatch copies
    its inputs into the key's buffers and replays the graphs in order. A
    capture that fails raises: there is no eager fallback on the card. On
    the CPU the same chunks run eagerly through the same buffers.

    ``capture=False`` is the uncaptured route, for programs that run once
    (the autotuner's verification of a candidate): each call builds the
    trace's entries and chunks anew and runs them eagerly, through the same
    kernels, in scratchpads of its own. It makes no plan, captures no
    graph and leaves nothing on the Trace that holds device memory, so
    what a call put on the device is freed when it returns.
    """

    name = "torch"

    def __init__(self, device: Optional[str] = None, chunk_cap: int = 24,
                 alu_fusion: bool = True, segment_fusion: bool = True,
                 capture: bool = True):
        device = torch.device(device or "cuda")
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the 'torch' backend runs on a CUDA device and none is "
                    "available; use TorchBackend(device='cpu') ('torch-cpu')")
            impl = "cuda"
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        elif device.type == "cpu":
            impl = "torch"
            self.name = "torch-cpu"
        else:
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.gemm_impl = impl
        self.alu_impl = impl
        self.chunk_cap = chunk_cap
        self.alu_fusion = alu_fusion
        self.segment_fusion = segment_fusion
        self.capture = capture

    def uncaptured(self) -> "TorchBackend":
        """This backend's knobs on the uncaptured route (``self`` when it
        is on it already)."""
        if not self.capture:
            return self
        be = copy.copy(self)
        be.capture = False
        return be

    def chunks(self, trace: Trace) -> list:
        """The trace's chunks under this backend's knobs: one dispatch
        each."""
        return _chunk_plan(trace, self.device, self.chunk_cap,
                           self.alu_fusion, self.segment_fusion)

    def _tensor(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v
        return torch.from_numpy(np.array(v))     # a copy, never a view

    def _plan(self, trace: Trace, hw: VTAConfig, n: int, batched: dict,
              shared: dict, in_place: set) -> _Plan:
        """The key's plan, made on its first dispatch. One plan lives per
        (capture scope, trace, batch, tensors' dtypes): each serving worker
        owns its buffers and graphs, and a key that moves to another worker
        is captured again there, once. Only new in-place shared tensors
        (new weights) replace a plan, graphs and pool with it."""
        sig = (capture_scope(), str(self.device), self.chunk_cap,
               self.alu_fusion, self.segment_fusion, n,
               tuple(sorted((k, v.dtype) for k, v in batched.items())),
               tuple(sorted((k, v.dtype) for k, v in shared.items())))
        ptrs = tuple(sorted((k, v.data_ptr()) for k, v in shared.items()
                            if k in in_place))
        with _MEMO_LOCK:
            plans = trace.__dict__.setdefault("_torch_plans", {})
            hit = plans.get(sig)
            if hit is None or hit[0] != ptrs:
                hit = plans[sig] = (ptrs, _Plan(trace, hw, n, batched, shared,
                                                in_place, self.device))
                if sig[0] is not None:
                    _SCOPE_PLANS.setdefault(sig[0], {})[(id(plans), sig)] = \
                        plans
        return hit[1]

    def _run_chunk(self, st: dict, chunks: list, i: int) -> None:
        if i == 0:
            # every dispatch starts from zeroed scratchpads, as numpy's FSim
            # and the reference's jnp.zeros do; inside chunk 0's graph
            for k in ("inp", "wgt", "acc"):
                st[k].zero_()
        _exec(chunks[i], st, self.gemm_impl, self.alu_impl)

    def _capture(self, plan: _Plan, chunks: list) -> None:
        """One CUDA graph per chunk, into the plan's memory pool, on
        ``_capture_stream``. Each graph keeps the kernel launches its capture recorded
        on this thread (the wrappers count them as they run, into
        ``recording_launches``; another thread's launches never enter) and
        adds them to the counters on each replay; the capture itself counts
        none. The eager run is waited for on this thread's stream only:
        other workers' streams run on. By ``CUDAGraph.capture_begin``, not
        ``torch.cuda.graph``, which would collect garbage and empty the
        allocator's cache at every chunk."""
        plan.pool = torch.cuda.graph_pool_handle()
        torch.cuda.current_stream(self.device).synchronize()
        graphs = []
        with torch.cuda.stream(_capture_stream(self.device)):
            for i in range(len(chunks)):
                g = torch.cuda.CUDAGraph()
                with recording_launches() as launches:
                    g.capture_begin(pool=plan.pool,
                                    capture_error_mode="thread_local")
                    try:
                        self._run_chunk(plan.st, chunks, i)
                    except BaseException:
                        try:
                            g.capture_end()
                        except RuntimeError:
                            pass                # the chunk's error wins
                        raise
                    g.capture_end()
                graphs.append((g, launches))
        plan.chunks = chunks
        plan.graphs = graphs

    def _run_once(self, trace: Trace, hw: VTAConfig, batched: dict,
                  shared: dict) -> dict:
        """The uncaptured route: the trace's entries and chunks built for
        this call only (``_build_ops``, never ``_device_ops``' memo), run
        eagerly in fresh scratchpads and fresh copies of the inputs, whose
        stored tensors are returned."""
        batched = {k: self._tensor(v) for k, v in batched.items()}
        n = next(iter(batched.values())).shape[0]
        dev = self.device
        ops = _build_ops(trace, dev, self.alu_fusion)
        chunks = _split_chunks(ops, self.chunk_cap,
                               self.segment_fusion and trace.fused_segment)
        st = _scratchpads(trace, hw, n, shared, dev)
        st["tensors"] = {k: v.reshape(n, -1).to(dev, copy=True)
                         for k, v in batched.items()}
        st["tensors"].update({k: self._tensor(v).reshape(-1).to(dev)
                              for k, v in shared.items()})
        global _UNCAPTURED_RUNS
        with _COUNT_LOCK:
            _UNCAPTURED_RUNS += 1
        for i in range(len(chunks)):
            _count_dispatch()
            self._run_chunk(st, chunks, i)
        return {t: st["tensors"][t].reshape(batched[t].shape)
                for t in trace.tensors_written}

    def _execute(self, trace: Trace, hw: VTAConfig, batched: dict,
                 shared: Optional[dict] = None) -> dict:
        """``batched``: tensors with a leading batch axis N; ``shared``:
        single tensors every image reads (never stores into). Returns the
        stored tensors as (N, ...) tensors on the device, never the plan's
        own buffers."""
        shared = shared or {}
        assert not (set(trace.tensors_written) & set(shared)), \
            "programs must not store into shared tensors"
        if not self.capture:
            return self._run_once(trace, hw, batched, shared)
        # shared tensors the caller keeps on the device are read in place;
        # anything else is copied in, so a fresh host array per call still
        # meets the same plan
        in_place = {k for k, v in shared.items()
                    if isinstance(v, torch.Tensor) and v.device == self.device
                    and v.is_contiguous()}
        batched = {k: self._tensor(v) for k, v in batched.items()}
        shared = {k: self._tensor(v) for k, v in shared.items()}
        n = next(iter(batched.values())).shape[0]
        chunks = self.chunks(trace)
        plan = self._plan(trace, hw, n, batched, shared, in_place)
        with plan.lock:
            if plan.done is not None:
                torch.cuda.current_stream(self.device).wait_event(plan.done)
            plan.load(n, batched, shared)
            st = plan.st
            if plan.graphs is None:
                if not plan.warm:
                    _note_capture(trace, chunks, n)
                for i in range(len(chunks)):
                    _count_dispatch()
                    self._run_chunk(st, chunks, i)
            else:
                for g, launches in plan.graphs:
                    _count_dispatch()
                    g.replay()
                    add_launch_counts(launches)
            outs = {t: st["tensors"][t].clone().reshape(batched[t].shape)
                    for t in trace.tensors_written}
            if plan.done is not None:
                plan.done.record(torch.cuda.current_stream(self.device))
            if not plan.warm:
                plan.warm = True
                if self.device.type == "cuda":
                    try:
                        self._capture(plan, chunks)
                    except BaseException:
                        plan.warm = False   # the next dispatch captures again
                        raise
            plan.unload()
        return outs

    # -- Backend protocol --------------------------------------------------
    def run(self, prog: Program, hw: VTAConfig, dram: dict) -> None:
        """One image, in place on the caller's numpy ``dram`` dict."""
        shapes = {k: np.asarray(v).shape for k, v in dram.items()}
        trace = lowered(prog, hw, shapes)
        outs = self._execute(trace, hw,
                             {k: np.asarray(v)[None] for k, v in dram.items()})
        for name, val in outs.items():
            dram[name][...] = val[0].cpu().numpy()

    def run_batched(self, prog: Program, hw: VTAConfig, *, shared: dict,
                    batched: dict) -> dict:
        """N images; ``shared``/``batched`` hold numpy arrays or tensors.
        Returns ``{stored tensor: (N, ...) tensor on this backend's
        device}``; the caller's arrays are never written."""
        shapes = {k: tuple(v.shape) for k, v in shared.items()}
        shapes.update({k: tuple(v.shape[1:]) for k, v in batched.items()})
        trace = lowered(prog, hw, shapes)
        return self._execute(trace, hw, batched, shared)

    # -- divergence debugging (vta/trace.py) -------------------------------
    def run_stepped(self, prog: Program, hw: VTAConfig, dram: dict,
                    hook) -> None:
        """``fsim_jax.JaxBackend.run_stepped``: one instruction at a time,
        each op its own singleton chunk run eagerly (never captured, never
        counted), calling ``hook(step, insn, state)`` after each; ``state``
        exposes numpy ``inp``/``wgt``/``acc``/``uop`` snapshots shaped like
        the numpy FSim's, so vta/trace.py digests every backend alike."""
        shapes = {k: np.asarray(v).shape for k, v in dram.items()}
        trace = lowered(prog, hw, shapes)
        dev = self.device
        st = {"inp": torch.zeros((1, hw.inp_depth, hw.batch, hw.block_in),
                                 dtype=torch.int8, device=dev),
              "wgt": torch.zeros((1, hw.wgt_depth, hw.block_out,
                                  hw.block_in), dtype=torch.int8, device=dev),
              "acc": torch.zeros((1, hw.acc_depth, hw.batch, hw.block_out),
                                 dtype=torch.int32, device=dev),
              "tensors": {k: torch.tensor(np.asarray(v), device=dev)
                          .reshape(1, -1) for k, v in dram.items()}}
        uop = np.zeros((hw.uop_depth, 3), np.int64)
        for step, (insn, op) in enumerate(zip(trace.insns, trace.ops)):
            if isinstance(op, UopLoad):
                uop[op.base:op.base + len(op.values)] = op.values
            elif op is not None:
                mini = Trace(hw=hw, insns=[insn], ops=[op], touches=[])
                _exec(_device_ops(mini, dev), st, self.gemm_impl,
                      self.alu_impl)
            if hook is not None:
                hook(step, insn, types.SimpleNamespace(
                    inp=st["inp"][0].cpu().numpy(),
                    wgt=st["wgt"][0].cpu().numpy(),
                    acc=st["acc"][0].cpu().numpy(), uop=uop))
        for name in trace.tensors_written:
            dram[name][...] = st["tensors"][name].reshape(
                np.asarray(dram[name]).shape).cpu().numpy()
