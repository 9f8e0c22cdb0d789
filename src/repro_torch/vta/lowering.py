"""Lower a Program into a flat, typed tensor-op trace (the backend IR).

The instruction stream the scheduler emits is *architectural*: loads and
stores carry stringly-typed ``meta`` dicts describing the DRAM-side tensor
slice, GEMM/ALU instructions index a uop scratchpad whose contents depend on
the uop loads that executed before them. Historically every consumer
re-interpreted those metas independently — ``fsim`` to execute them,
``scheduler.insn_dram_bytes`` to bill them, the graph compiler's resid/spill
paths to special-case them. This module is the single lowering point:

  * the **uop buffer is resolved statically** — lowering replays the uop
    loads in program order, so every GEMM/ALU op in the trace carries fully
    materialized scratchpad index vectors and no backend needs uop state;
  * every data load/store becomes a **gather/scatter with explicit flat
    index maps** into the named DRAM tensor (padding = a mask + fill value,
    clamped edges = a mask that drops lanes), so a backend is just "apply
    this index arithmetic" — numpy fancy-indexing (``fsim``) and
    ``jax.jit``-compiled XLA gathers (``fsim_jax``) execute the *same*
    trace and must agree bit for bit;
  * every op declares the **scratchpad ranges it reads and writes**
    (``Touch``), which drives ``run_tsim``'s RAW/WAW hazard checker and the
    trace-divergence tooling (vta/trace.py).

``lower`` needs the DRAM tensor shapes (they are runtime inputs, not part of
the Program); ``lower_ranges`` computes only the per-instruction Touch list
and needs no shapes — that is the cheap pass tsim's hazard checker uses.

``insn_dram_bytes`` lives here as the canonical DRAM-traffic accounting
(scheduler/tsim import it), so the widening-load and on-chip-spill rules are
stated exactly once.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.vta.isa import (AluInsn, AluOp, Buffer, GemmInsn, LoadInsn,
                           StoreInsn, VTAConfig)
from repro_torch.vta.runtime import Program

# f32 accumulation of int8·int8 products is exact while every partial sum
# stays below 2^24: products are <= 127*128 < 2^14, so blocks of up to 2^10
# contraction terms are safe (2^10 * 2^14 = 2^24). Shared by every backend
# (and the numpy oracle) that contracts int8 operands through f32 matmuls —
# the bit-exactness contract depends on all of them agreeing on this bound.
F32_EXACT_TERMS = 1024


# ---------------------------------------------------------------------------
# DRAM traffic accounting (single source of truth; scheduler/tsim import it)
# ---------------------------------------------------------------------------
def insn_dram_bytes(insn, hw: VTAConfig) -> int:
    """Bytes this instruction moves over the DRAM interface."""
    if isinstance(insn, LoadInsn):
        per_tile = {Buffer.INP: hw.inp_tile_bytes, Buffer.WGT: hw.wgt_tile_bytes,
                    Buffer.ACC: hw.acc_tile_bytes, Buffer.UOP: hw.uop_bytes,
                    Buffer.OUT: hw.out_tile_bytes}[insn.buffer]
        if insn.buffer == Buffer.ACC and getattr(insn, "meta", {}).get("kind") in \
                ("dw_patch", "resid"):
            per_tile = hw.batch * hw.block_out * hw.inp_bytes  # widening load
        return insn.dram_tiles() * per_tile
    if isinstance(insn, StoreInsn):
        if insn.on_chip:
            return 0        # scratchpad spill: no DRAM traffic at all
        return insn.tiles() * hw.out_tile_bytes
    return 0


# ---------------------------------------------------------------------------
# Typed trace ops
# ---------------------------------------------------------------------------
@dataclass
class TraceOp:
    step: int                        # index into Program.order


@dataclass
class UopLoad(TraceOp):
    """Uop-buffer refill. Backends need no uop state (GEMM/ALU indices are
    resolved at lowering time); the numpy fsim still materializes the buffer
    so state digests cover it."""
    base: int = 0
    values: np.ndarray = None        # (n, 3) resolved uop rows


@dataclass
class GatherLoad(TraceOp):
    """DRAM -> scratchpad: ``buf[base:base+n] = dram[tensor].flat[index]``
    with ``fill`` where ``mask`` is False (hardware padding)."""
    buffer: Buffer = Buffer.INP
    tensor: str = ""
    base: int = 0
    index: np.ndarray = None         # (n, R, C) int32 flat indices
    mask: Optional[np.ndarray] = None  # bool, False -> fill
    fill: int = 0
    dram_bytes: int = 0


@dataclass
class GemmOp(TraceOp):
    acc_idx: np.ndarray = None       # (iters,) flat scratchpad indices
    inp_idx: np.ndarray = None
    wgt_idx: np.ndarray = None
    reset: bool = False


@dataclass
class AluStepOp:
    """One uop of an ALU macro-op, vectorized over the lp0 x lp1 grid.
    Steps execute in sequence (batched vectors may chain through a shared
    destination, e.g. the depthwise MAC accumulation)."""
    dst: np.ndarray                  # (g,) acc indices
    src: Optional[np.ndarray]        # (g,) acc indices, None for imm-only ops
    src2: int = -1                   # MAC latched operand address


@dataclass
class AluSweep(TraceOp):
    alu_op: AluOp = AluOp.ADD
    use_imm: bool = False
    imm: int = 0
    overwrite: bool = False
    steps: list = field(default_factory=list)   # [AluStepOp]


@dataclass
class ScatterStore(TraceOp):
    """Narrow acc rows to int8 and scatter into the DRAM tensor:
    ``dram[tensor].flat[index] = clip(acc[base:base+n])`` where mask holds
    (False lanes are clamped edge positions and are dropped)."""
    tensor: str = ""
    base: int = 0
    index: np.ndarray = None         # (n, BV, BO) int32 flat indices
    mask: Optional[np.ndarray] = None
    dram_bytes: int = 0


@dataclass
class SpillStore(TraceOp):
    """On-chip spill: narrowed acc rows land in the INP scratchpad in the
    consumer's layout (row-level index maps, no DRAM traffic)."""
    src: np.ndarray = None           # (n,) acc row indices
    dst: np.ndarray = None           # (n,) inp row indices


@dataclass
class Touch:
    """Scratchpad ranges one instruction reads/writes: {buffer: (lo, hi)}."""
    reads: tuple = ()                # ((Buffer, lo, hi), ...)
    writes: tuple = ()


@dataclass
class DirectSlab:
    """One feeder GatherLoad re-executed INSIDE the fused sweep kernel:
    ``index``/``mask`` are the gather's own (n, BV, BO) maps, so the DRAM
    gather volume is byte-for-byte what the original load moved — the win
    is that the slab value stays local to the kernel (registers / one XLA
    fusion) instead of round-tripping through the acc scratchpad, whose
    update-slice write and row-gather reads dominate bandwidth-bound
    depthwise/pool layers. A chain's slabs concatenate along rows in
    order; ``("local", rows)`` operand slots index the concatenation."""
    tensor: str
    index: np.ndarray
    mask: Optional[np.ndarray]
    fill: int


@dataclass
class DirectStore:
    """A ScatterStore absorbed into the chain: the kernel clips the chain
    value to int8 and scatters it straight into the DRAM tensor. ``index``
    (g, BV, BO) is the store's index map permuted into chain-dst order.

    ``affine`` is set when the index map decomposes into a constant-stride
    block (``_affine_block``): ``(view_shape, perm, sizes, starts)`` such
    that reshaping the flat tensor to ``view_shape`` and writing the value
    block (axes permuted by ``perm``, reshaped to ``sizes``) at ``starts``
    is elementwise-identical to the scatter — the kernel then uses a
    contiguous ``dynamic_update_slice`` instead of an elementwise scatter,
    which XLA's CPU backend serializes."""
    tensor: str
    index: np.ndarray
    mask: Optional[np.ndarray]
    unique: bool
    sorted: bool
    affine: Optional[tuple] = None


@dataclass
class AluChain:
    """A run of >= 2 consecutive AluSweep ops proven legal to execute as ONE
    fused gather -> reduce -> scatter kernel (kernels/alu_sweep.py).

    Legality (checked by ``_mark_alu_chains``): every step of every member
    writes the SAME unique-indexed destination rows ``dst``; every source
    row (and MAC latched operand) is disjoint from ``dst``, so no stage
    observes a row the chain writes — deferring the single scatter to the
    end is observationally identical to the sequential per-op scatters. An
    overwrite op is legal only as the chain seed (single step); a
    non-overwrite seed reads the destination first (``read_dst``).

    ``stages``/``args`` follow the kernels/alu_sweep.py stage encoding:
    stages are hashable tuples (they ride in the jit static spec), args are
    the index arrays the stages consume positionally.

    ``_mark_direct`` may additionally prove the chain *DRAM-direct*: the
    feeder GatherLoads that produced its operand rows move into the kernel
    as ``slabs`` (gathered once each — same DRAM volume as the loads they
    replace — then concatenated into a kernel-local buffer); each entry of
    ``arg_src`` is either ``"acc"`` (read the scratchpad, as before) or
    ``("local", rows)`` (row-index the local slab buffer); ``store``
    absorbs the following ScatterStore so the sweep writes its output
    tensor directly; ``write_acc`` is False when nothing reads the chain's
    acc rows afterwards, making the whole sweep a pure
    DRAM -> reduce -> DRAM kernel with no scratchpad traffic at all.
    ``covers`` is the op-index span (lo, hi) including any elided feeder
    gathers and the absorbed store, used for divergence attribution.
    """
    members: tuple                   # op indices of the member AluSweeps
    dst: np.ndarray                  # (g,) int32 destination acc rows
    stages: tuple
    args: tuple                      # np.ndarray operands, in stage order
    unique: bool = True              # scatter hints for dst
    sorted: bool = False
    slabs: tuple = ()                # (DirectSlab, ...) in local-row order
    arg_src: tuple = ()              # per args entry: "acc"|("local", rows)
    store: Optional[DirectStore] = None
    write_acc: bool = True
    covers: Optional[tuple] = None   # (lo, hi) attribution span


@dataclass
class Trace:
    hw: VTAConfig
    insns: list                      # Program.order (parallel to ops)
    ops: list                        # TraceOp | None (FINISH / no-op)
    touches: list                    # Touch per instruction
    tensors_read: tuple = ()
    tensors_written: tuple = ()
    alu_chains: tuple = ()           # (AluChain, ...) fusable sweep runs
    fused_segment: bool = False      # compiler marked prog whole-segment
    elided: frozenset = frozenset()  # op idxs subsumed by direct chains


def scatter_hints(idx: np.ndarray) -> tuple:
    """(unique, sorted) flags for XLA scatter fast paths, proven statically
    from the concrete index vector (all index maps are lowering-time
    constants)."""
    if len(idx) <= 1:
        return True, True
    d = np.diff(idx)
    srt = bool((d >= 0).all())
    if srt:
        return bool((d > 0).all()), True
    s = np.sort(idx)                 # ~3x cheaper than np.unique
    return bool((np.diff(s) > 0).all()), False


_ALU_NAME = {AluOp.ADD: "add", AluOp.MAX: "max", AluOp.MIN: "min",
             AluOp.SHR: "shr", AluOp.MUL: "mul"}


def _chain_contrib(op: AluSweep, dset: set):
    """(stages, args) this non-overwrite AluSweep adds to a chain whose
    destination set is ``dset``, or None when fusing it would change the
    sequential semantics."""
    T = len(op.steps)
    if op.alu_op == AluOp.MAC:
        if op.use_imm:
            return None
        for s in op.steps:
            if s.src is None or dset.intersection(s.src.tolist()) \
                    or s.src2 < 0 or s.src2 in dset:
                return None
        srcs = np.stack([s.src for s in op.steps])
        src2 = np.array([s.src2 for s in op.steps], np.int32)
        return (("mac", T),), (srcs, src2)
    if op.alu_op == AluOp.CLIP:      # imm-bound clamp; src is never read
        return (("imm", "clip", int(op.imm)),) * T, ()
    name = _ALU_NAME.get(op.alu_op)
    if name is None:
        return None
    if op.use_imm:
        return (("imm", name, int(op.imm)),) * T, ()
    for s in op.steps:
        if s.src is None or dset.intersection(s.src.tolist()):
            return None
    if name in ("add", "max", "min") and T >= 2:
        return (("red", name, T),), (np.stack([s.src for s in op.steps]),)
    # order-sensitive ops (shr/mul) and singleton reduces: one stage per step
    return (("src", name),) * T, tuple(s.src for s in op.steps)


def _chain_start(i: int, op: AluSweep):
    """Open a chain at op index ``i``, or None when the op can't seed one."""
    if not op.steps:
        return None
    dst = op.steps[0].dst
    for s in op.steps:
        if not np.array_equal(s.dst, dst):
            return None
    uniq, srt = scatter_hints(dst)
    if not uniq:                     # duplicate dst rows: keep sequential
        return None
    dset = set(dst.tolist())
    if op.overwrite:
        if len(op.steps) != 1:
            return None
        s = op.steps[0]
        if op.alu_op == AluOp.MAC:
            if s.src is None or dset.intersection(s.src.tolist()) \
                    or s.src2 < 0 or s.src2 in dset:
                return None
            stages = (("seed_mac",),)
            args = [s.src, np.array([s.src2], np.int32)]
        elif op.use_imm or op.alu_op == AluOp.CLIP:
            stages = (("seed_imm", int(op.imm)),)
            args = []
        else:
            if s.src is None or dset.intersection(s.src.tolist()):
                return None
            stages = (("seed_copy",),)
            args = [s.src]
    else:
        contrib = _chain_contrib(op, dset)
        if contrib is None:
            return None
        stages = (("read_dst",),) + contrib[0]
        args = list(contrib[1])
    return {"members": [i], "dst": dst, "dset": dset,
            "stages": list(stages), "args": args, "uniq": uniq, "srt": srt}


def _mark_alu_chains(ops: list) -> tuple:
    """Scan the op stream for fusable AluSweep runs (see ``AluChain``).

    UopLoads and FINISH are neutral (they never touch acc, and the spec
    skips them anyway); every other op kind closes the open chain. Runs of
    fewer than 2 member ops are dropped — single sweeps stay on the
    per-op path (fsim_jax fuses their steps internally where legal).
    """
    chains: list = []
    cur = None

    def close():
        nonlocal cur
        if cur is not None and len(cur["members"]) >= 2:
            chains.append(AluChain(
                members=tuple(cur["members"]), dst=cur["dst"],
                stages=tuple(cur["stages"]), args=tuple(cur["args"]),
                unique=cur["uniq"], sorted=cur["srt"]))
        cur = None

    for i, op in enumerate(ops):
        if op is None or isinstance(op, UopLoad):
            continue
        if not isinstance(op, AluSweep):
            close()
            continue
        if cur is not None and not op.overwrite and op.steps and \
                all(np.array_equal(s.dst, cur["dst"]) for s in op.steps):
            contrib = _chain_contrib(op, cur["dset"])
            if contrib is not None:
                cur["members"].append(i)
                cur["stages"].extend(contrib[0])
                cur["args"].extend(contrib[1])
                continue
        close()
        cur = _chain_start(i, op)
    close()
    return tuple(chains)


# ---------------------------------------------------------------------------
# DRAM-direct sweep proving (the "fused gather -> reduce -> scatter" half of
# the chain story): a chain whose operand rows were produced by plain
# GatherLoads can read the source tensors directly through the composed
# index maps, and a chain whose destination rows feed exactly one following
# ScatterStore can write that tensor directly — eliding the scratchpad
# round-trip that dominates bandwidth-bound depthwise/pool layers.
# ---------------------------------------------------------------------------
def _op_touch(op):
    """(reads, writes) acc-row sets of one op in the per-op (unfused) view."""
    if isinstance(op, GatherLoad):
        if op.buffer == Buffer.ACC:
            return set(), set(range(op.base, op.base + op.index.shape[0]))
        return set(), set()
    if isinstance(op, GemmOp):
        rows = set(op.acc_idx.tolist())
        return (set() if op.reset else set(rows)), rows
    if isinstance(op, AluSweep):
        r, w = set(), set()
        for s in op.steps:
            if s.src is not None:
                r |= set(s.src.tolist())
            if s.src2 >= 0:
                r.add(int(s.src2))
            if not op.overwrite:
                r |= set(s.dst.tolist())
            w |= set(s.dst.tolist())
        return r, w
    if isinstance(op, ScatterStore):
        return set(range(op.base, op.base + op.index.shape[0])), set()
    if isinstance(op, SpillStore):
        return set(op.src.tolist()), set()
    return set(), set()


def _resolve_rows(rows: np.ndarray, ops: list, writer: np.ndarray,
                  ver: dict, ver_at: dict, slab_off: dict):
    """Remap ``rows`` (acc row indices, any shape) into the chain's local
    slab space: every producing gather becomes a slab (registered in
    ``slab_off``, gather op idx -> local row offset, extended here in
    first-use order) and each row maps to ``offset + (row - gather.base)``.
    Returns ``(("local", rows_local), source op idxs)`` or None when any
    row's producer is not a still-valid plain ACC gather."""
    ws = np.unique(writer[rows])
    if len(ws) == 0 or int(ws[0]) < 0:
        return None
    gs = {int(w): ops[int(w)] for w in ws}
    if not all(isinstance(g, GatherLoad) and g.buffer == Buffer.ACC
               for g in gs.values()):
        return None
    for w, g in gs.items():          # tensor rewritten since the load?
        if ver_at[w] != ver.get(g.tensor, 0):
            return None
    rl = np.zeros(rows.shape, np.int32)
    rw = writer[rows]
    for w, g in gs.items():
        if w not in slab_off:
            slab_off[w] = sum(ops[k].index.shape[0] for k in slab_off)
        sel = rw == w
        rl[sel] = slab_off[w] + (rows[sel] - g.base)
    return ("local", rl), set(gs)


def _absorb_store(ops: list, mk: int, dset: set):
    """The ScatterStore a chain ending at op ``mk`` may absorb: the first
    one whose slab is exactly the chain's dst rows, with nothing in between
    touching those rows or the store's tensor. Returns (store idx, write_acc)
    or (None, True)."""
    touched = set()
    j = mk + 1
    absorb = None
    while j < len(ops):
        op = ops[j]
        if op is None or isinstance(op, UopLoad):
            j += 1
            continue
        if isinstance(op, ScatterStore) and \
                set(range(op.base, op.base + op.index.shape[0])) == dset:
            if op.tensor not in touched:
                absorb = j
            break
        r, w = _op_touch(op)
        if (r | w) & dset:
            break
        if isinstance(op, (GatherLoad, ScatterStore)):
            touched.add(op.tensor)
        j += 1
    if absorb is None:
        return None, True
    # acc write still needed iff someone reads dst before it's overwritten
    remaining = set(dset)
    for k in range(absorb + 1, len(ops)):
        op = ops[k]
        if op is None or isinstance(op, UopLoad):
            continue
        r, w = _op_touch(op)
        if r & remaining:
            return absorb, True
        remaining -= w
        if not remaining:
            break
    return absorb, False


def _affine_block(idx: np.ndarray, n: int):
    """Decompose a constant index map into a strided block of the flat
    tensor: returns ``(view_shape, perm, sizes, starts)`` — reshape the
    flat (n,) tensor to ``view_shape`` and the block lands contiguously at
    ``starts`` — or None when the map is not constant-stride per axis, the
    strides don't nest (each must divide the next-coarser one, innermost
    1), or the block crosses an axis boundary. All inputs are lowering-time
    constants, so the proof is exact, not heuristic."""
    axes = []
    for ax in range(idx.ndim):
        if idx.shape[ax] == 1:
            continue
        d = np.diff(idx, axis=ax)
        s = int(d.flat[0])
        if s <= 0 or not (d == s).all():
            return None
        axes.append((s, idx.shape[ax], ax))
    if not axes or sorted(s for s, _, _ in axes)[0] != 1:
        return None
    axes.sort(key=lambda t: -t[0])
    view, starts, sizes, perm = [], [], [], []
    prev, t = n, int(idx.flat[0])
    for s, sz, ax in axes:
        if prev % s:
            return None
        dim = prev // s
        st_i = t // s
        t -= st_i * s
        if st_i + sz > dim:
            return None
        view.append(dim)
        starts.append(st_i)
        sizes.append(sz)
        perm.append(ax)
        prev = s
    perm += [ax for ax in range(idx.ndim) if idx.shape[ax] == 1]
    return tuple(view), tuple(perm), tuple(sizes), tuple(starts)


def _mark_direct(ops: list, chains: tuple, acc_depth: int,
                 shapes: dict) -> tuple:
    """Annotate chains with DRAM-direct operands/stores and compute the op
    indices (feeder gathers, absorbed stores) the fused path elides.

    Three passes: (1) forward, resolving each chain's operand rows through
    the last-writer map while tracking tensor versions (a store to the
    source tensor between gather and chain invalidates composition);
    (2) per resolved chain, absorb the following store when legal;
    (3) forward liveness — a feeder gather is elided only when *every*
    acc read of its rows happens through a direct chain's composed map.
    """
    if not chains:
        return chains, frozenset()
    heads = {c.members[0]: c for c in chains}
    member_set = {m for c in chains for m in c.members}

    writer = np.full(acc_depth, -1, np.int64)
    ver: dict = {}
    ver_at: dict = {}
    resolved: dict = {}
    for i, op in enumerate(ops):
        if op is None or isinstance(op, UopLoad):
            continue
        if i in heads:
            c = heads[i]
            if c.stages[0][0] != "read_dst":     # dst seeds read no acc
                arg_src, sources, slab_off = [], set(), {}
                for a in c.args:
                    r = _resolve_rows(np.asarray(a), ops, writer, ver,
                                      ver_at, slab_off)
                    if r is None:
                        arg_src.append("acc")
                    else:
                        arg_src.append(r[0])
                        sources |= r[1]
                if slab_off:
                    resolved[i] = {"arg_src": tuple(arg_src),
                                   "sources": sources,
                                   "slab_ops": tuple(slab_off)}
        if isinstance(op, GatherLoad) and op.buffer == Buffer.ACC:
            writer[op.base:op.base + op.index.shape[0]] = i
            ver_at[i] = ver.get(op.tensor, 0)
        elif isinstance(op, GemmOp):
            writer[op.acc_idx] = i
        elif isinstance(op, AluSweep):
            for s in op.steps:
                writer[s.dst] = i
        elif isinstance(op, ScatterStore):
            ver[op.tensor] = ver.get(op.tensor, 0) + 1

    absorbed: dict = {}                          # head -> store op idx
    write_acc: dict = {}
    for head, info in resolved.items():
        c = heads[head]
        dset = set(c.dst.tolist())
        sidx, wacc = _absorb_store(ops, c.members[-1], dset)
        if sidx is not None:
            absorbed[head] = sidx
        write_acc[head] = wacc

    # liveness: which feeder gathers still have an acc reader
    writer2 = np.full(acc_depth, -1, np.int64)
    needed: set = set()

    def note(rows):
        for w in np.unique(writer2[np.asarray(rows, np.int64)]):
            if w >= 0:
                needed.add(int(w))

    absorbed_stores = set(absorbed.values())
    for i, op in enumerate(ops):
        if op is None or isinstance(op, UopLoad):
            continue
        if i in member_set:
            if i not in heads:
                continue                         # reads happen at the head
            c = heads[i]
            info = resolved.get(i)
            if c.stages[0][0] == "read_dst":
                note(c.dst)
            if info:
                for a, s in zip(c.args, info["arg_src"]):
                    if isinstance(s, str):
                        note(np.asarray(a).ravel())
            else:
                for a in c.args:
                    note(np.asarray(a).ravel())
            writer2[c.dst] = i
            continue
        if isinstance(op, ScatterStore) and i in absorbed_stores:
            continue                             # read via the chain kernel
        r, w = _op_touch(op)
        if r:
            note(sorted(r))
        if w:
            writer2[sorted(w)] = i

    sources_all = set()
    for info in resolved.values():
        sources_all |= info["sources"]
    elided = (sources_all - needed) | absorbed_stores

    out = []
    for c in chains:
        head = c.members[0]
        info = resolved.get(head)
        if info is None:
            out.append(c)
            continue
        st = None
        lo, hi = head, c.members[-1]
        if head in absorbed:
            s = ops[absorbed[head]]
            loc = c.dst - s.base
            sidx = s.index[loc]
            smask = s.mask[loc] if s.mask is not None else None
            uniq, srt = scatter_hints(sidx.reshape(-1))
            aff = None
            if smask is None and s.tensor in shapes:
                aff = _affine_block(sidx, int(np.prod(shapes[s.tensor])))
            st = DirectStore(tensor=s.tensor, index=sidx, mask=smask,
                             unique=uniq, sorted=srt, affine=aff)
            hi = max(hi, absorbed[head])
        mine = info["sources"] & elided
        if mine:
            lo = min(lo, min(mine))
        slabs = tuple(
            DirectSlab(tensor=ops[w].tensor, index=ops[w].index,
                       mask=ops[w].mask, fill=int(ops[w].fill))
            for w in info["slab_ops"])
        out.append(dataclasses.replace(
            c, slabs=slabs, arg_src=info["arg_src"], store=st,
            write_acc=write_acc.get(head, True), covers=(lo, hi)))
    return tuple(out), frozenset(elided)


def enclosing_kernel(trace: Trace, step: int):
    """The fused kernel the JAX fast path would execute insn ``step``
    inside: ``("aluchain", lo, hi)`` when the step falls in a fused ALU
    chain (the span includes elided feeder gathers and an absorbed store),
    ``("segment", 0, last)`` for a whole-segment-fused program, else None.
    vta/trace.py uses this to localize a stepped-mode divergence to the
    fused kernel that covers it."""
    for c in trace.alu_chains:
        lo, hi = c.covers if c.covers is not None \
            else (c.members[0], c.members[-1])
        if lo <= step <= hi:
            return ("aluchain", lo, hi)
    if trace.fused_segment:
        return ("segment", 0, len(trace.ops) - 1)
    return None


# ---------------------------------------------------------------------------
# Index-map builders (one per meta kind; the only place metas are decoded)
# ---------------------------------------------------------------------------
def _strides(shape) -> list:
    st = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        st[i] = st[i + 1] * shape[i + 1]
    return st


def _ax(a: np.ndarray, axis: int, ndim: int) -> np.ndarray:
    """Reshape a 1-D array so it broadcasts along ``axis`` of an ndim grid."""
    shape = [1] * ndim
    shape[axis] = len(a)
    return a.reshape(shape)


def _load_default_tensor(kind: str) -> str:
    return {"inp": "inp", "wgt": "wgt", "bias": "bias", "dw_patch": "inp",
            "dw_wgt": "dw_wgt", "resid": None}[kind]


def _gather_index(insn: LoadInsn, hw: VTAConfig, shape):
    """(index, mask, fill) for a data load; index is (n, R, C) into the
    flattened DRAM tensor, mask is None when every lane is in bounds."""
    meta = insn.meta
    kind = meta["kind"]
    BV, BI, BO = hw.batch, hw.block_in, hw.block_out
    if kind == "inp":
        B, C, H, W = shape
        sB, sC, sH, sW = _strides(shape)
        tb, tci, ih, iw = meta["tb"], meta["tci"], meta["ih"], meta["iw"]
        y = meta["y0"] + np.arange(ih)
        x = meta["x0"] + np.arange(iw)
        idx = (_ax((meta["b0"] + np.arange(tb)) * BV, 0, 6)
               + _ax(np.arange(BV), 4, 6)) * sB \
            + (_ax((meta["ci0"] + np.arange(tci)) * BI, 1, 6)
               + _ax(np.arange(BI), 5, 6)) * sC \
            + _ax(np.clip(y, 0, H - 1), 2, 6) * sH \
            + _ax(np.clip(x, 0, W - 1), 3, 6) * sW
        valid = _ax((y >= 0) & (y < H), 2, 6) & _ax((x >= 0) & (x < W), 3, 6)
        n = tb * tci * ih * iw
        mask = None if valid.all() else \
            np.broadcast_to(valid, idx.shape).reshape(n, BV, BI)
        return idx.reshape(n, BV, BI), mask, 0
    if kind == "wgt":
        sF, sC, sKH, sKW = _strides(shape)
        tco, tci, kh, kw = meta["tco"], meta["tci"], meta["kh"], meta["kw"]
        idx = (_ax((meta["co0"] + np.arange(tco)) * BO, 0, 6)
               + _ax(np.arange(BO), 4, 6)) * sF \
            + (_ax((meta["ci0"] + np.arange(tci)) * BI, 1, 6)
               + _ax(np.arange(BI), 5, 6)) * sC \
            + _ax(np.arange(kh), 2, 6) * sKH \
            + _ax(np.arange(kw), 3, 6) * sKW
        return idx.reshape(tco * tci * kh * kw, BO, BI), None, 0
    if kind == "bias":
        tb, tco = meta["tb"], meta["tco"]
        idx = _ax(np.zeros(tb, np.int64), 0, 4) \
            + _ax((meta["co0"] + np.arange(tco)) * BO, 1, 4) \
            + _ax(np.zeros(BV, np.int64), 2, 4) + _ax(np.arange(BO), 3, 4)
        return np.broadcast_to(idx, (tb, tco, BV, BO)) \
            .reshape(tb * tco, BV, BO).copy(), None, 0
    if kind == "dw_patch":
        B, C, H, W = shape
        sB, sC, sH, sW = _strides(shape)
        ih, iw = meta["ih"], meta["iw"]
        y = meta["y0"] + np.arange(ih)
        x = meta["x0"] + np.arange(iw)
        idx = (meta["b0"] * BV + _ax(np.arange(BV), 2, 4)) * sB \
            + (meta["c0"] * BO + _ax(np.arange(BO), 3, 4)) * sC \
            + _ax(np.clip(y, 0, H - 1), 0, 4) * sH \
            + _ax(np.clip(x, 0, W - 1), 1, 4) * sW
        valid = _ax((y >= 0) & (y < H), 0, 4) & _ax((x >= 0) & (x < W), 1, 4)
        n = ih * iw
        mask = None if valid.all() else \
            np.broadcast_to(valid, idx.shape).reshape(n, BV, BO)
        return idx.reshape(n, BV, BO), mask, meta.get("pad_value", 0)
    if kind == "resid":
        sB, sC, sH, sW = _strides(shape)
        tb, tco, th, tw = meta["tb"], meta["tco"], meta["th"], meta["tw"]
        idx = (_ax((meta["b0"] + np.arange(tb)) * BV, 0, 6)
               + _ax(np.arange(BV), 4, 6)) * sB \
            + (_ax((meta["co0"] + np.arange(tco)) * BO, 1, 6)
               + _ax(np.arange(BO), 5, 6)) * sC \
            + _ax(meta["y0"] + np.arange(th), 2, 6) * sH \
            + _ax(meta["x0"] + np.arange(tw), 3, 6) * sW
        return idx.reshape(tb * tco * th * tw, BV, BO), None, 0
    if kind == "dw_wgt":
        sC, sKH, sKW = _strides(shape)
        kh, kw = meta["kh"], meta["kw"]
        idx = (meta["c0"] * BO + _ax(np.arange(BO), 3, 4)) * sC \
            + _ax(np.arange(kh), 0, 4) * sKH + _ax(np.arange(kw), 1, 4) * sKW
        idx = idx + _ax(np.zeros(BV, np.int64), 2, 4)
        return np.broadcast_to(idx, (kh, kw, BV, BO)) \
            .reshape(kh * kw, BV, BO).copy(), None, 0
    raise ValueError(kind)


def _scatter_index(insn: StoreInsn, hw: VTAConfig, shape):
    """(index, mask) for a DRAM store (n, BV, BO)."""
    meta = insn.meta
    BV, BO = hw.batch, hw.block_out
    if meta["kind"] == "out":
        sB, sC, sH, sW = _strides(shape)
        tb, tco, th, tw = meta["tb"], meta["tco"], meta["th"], meta["tw"]
        idx = (_ax((meta["b0"] + np.arange(tb)) * BV, 0, 6)
               + _ax(np.arange(BV), 4, 6)) * sB \
            + (_ax((meta["co0"] + np.arange(tco)) * BO, 1, 6)
               + _ax(np.arange(BO), 5, 6)) * sC \
            + _ax(meta["y0"] + np.arange(th), 2, 6) * sH \
            + _ax(meta["x0"] + np.arange(tw), 3, 6) * sW
        return idx.reshape(tb * tco * th * tw, BV, BO), None
    if meta["kind"] == "dw_out":
        B, C, OH, OW = shape
        sB, sC, sH, sW = _strides(shape)
        th, tw = meta["th"], meta["tw"]
        y = meta["y0"] + np.arange(th)
        x = meta["x0"] + np.arange(tw)
        idx = (meta["b0"] * BV + _ax(np.arange(BV), 2, 4)) * sB \
            + (meta["c0"] * BO + _ax(np.arange(BO), 3, 4)) * sC \
            + _ax(np.clip(y, 0, OH - 1), 0, 4) * sH \
            + _ax(np.clip(x, 0, OW - 1), 1, 4) * sW
        valid = _ax(y < OH, 0, 4) & _ax(x < OW, 1, 4)
        n = th * tw
        mask = None if valid.all() else \
            np.broadcast_to(valid, idx.shape).reshape(n, BV, BO)
        return idx.reshape(n, BV, BO), mask
    raise ValueError(meta["kind"])


def _load_rows(insn: LoadInsn) -> int:
    """Scratchpad entries a data load writes (its sram footprint)."""
    meta = getattr(insn, "meta", None)
    if meta is None:
        return insn.tiles()
    if meta["kind"] == "inp":
        return meta["tb"] * meta["tci"] * meta["ih"] * meta["iw"]
    return insn.tiles()


# ---------------------------------------------------------------------------
# GEMM / ALU index resolution (uop buffer replayed statically)
# ---------------------------------------------------------------------------
def _gemm_indices(insn: GemmInsn, uops: np.ndarray):
    l0 = np.arange(insn.lp0)[:, None, None]
    l1 = np.arange(insn.lp1)[None, :, None]
    out = []
    for col, f0, f1 in ((0, insn.acc_f0, insn.acc_f1),
                        (1, insn.inp_f0, insn.inp_f1),
                        (2, insn.wgt_f0, insn.wgt_f1)):
        out.append((uops[None, None, :, col] + l0 * f0 + l1 * f1)
                   .reshape(-1).astype(np.int32))
    return out


def _alu_steps(insn: AluInsn, uops: np.ndarray) -> list:
    l0 = np.arange(insn.lp0)[:, None]
    l1 = np.arange(insn.lp1)[None, :]
    dst_g = (l0 * insn.dst_f0 + l1 * insn.dst_f1).reshape(-1)
    src_g = (l0 * insn.src_f0 + l1 * insn.src_f1).reshape(-1)
    steps = []
    for (a, i, w) in uops:
        if insn.alu_op == AluOp.MAC:
            steps.append(AluStepOp(dst=(int(a) + dst_g).astype(np.int32),
                                   src=(int(i) + src_g).astype(np.int32),
                                   src2=int(w)))
        elif insn.use_imm:
            steps.append(AluStepOp(dst=(int(a) + dst_g).astype(np.int32),
                                   src=None))
        else:
            steps.append(AluStepOp(dst=(int(a) + dst_g).astype(np.int32),
                                   src=(int(i) + src_g).astype(np.int32)))
    return steps


def _env(lo: int, hi: int, f0: int, f1: int, lp0: int, lp1: int):
    """[lo, hi) envelope swept by base range + the lp0 x lp1 factor grid.
    Factors are encode-checked non-negative, so the extremes are corners."""
    return lo, hi + (lp0 - 1) * f0 + (lp1 - 1) * f1


def _touch_of(insn, hw: VTAConfig, uops: Optional[np.ndarray]) -> Touch:
    if isinstance(insn, LoadInsn):
        if insn.buffer == Buffer.UOP:
            return Touch(writes=((Buffer.UOP, insn.sram_base,
                                  insn.sram_base + insn.x_size),))
        n = _load_rows(insn)
        return Touch(writes=((insn.buffer, insn.sram_base,
                              insn.sram_base + n),))
    if isinstance(insn, StoreInsn):
        n = insn.tiles()
        reads = ((Buffer.ACC, insn.sram_base, insn.sram_base + n),)
        if insn.on_chip:
            dst, stride = insn.meta["dst"], insn.meta["dst_stride"]
            hi = dst + (insn.y_size - 1) * stride + insn.x_size
            return Touch(reads=reads, writes=((Buffer.INP, dst, hi),))
        return Touch(reads=reads)
    if isinstance(insn, GemmInsn):
        a0, a1 = int(uops[:, 0].min()), int(uops[:, 0].max()) + 1
        acc = (Buffer.ACC,) + _env(a0, a1, insn.acc_f0, insn.acc_f1,
                                   insn.lp0, insn.lp1)
        if insn.reset:
            return Touch(writes=(acc,))
        i0, i1 = int(uops[:, 1].min()), int(uops[:, 1].max()) + 1
        w0, w1 = int(uops[:, 2].min()), int(uops[:, 2].max()) + 1
        return Touch(
            reads=((Buffer.INP,) + _env(i0, i1, insn.inp_f0, insn.inp_f1,
                                        insn.lp0, insn.lp1),
                   (Buffer.WGT,) + _env(w0, w1, insn.wgt_f0, insn.wgt_f1,
                                        insn.lp0, insn.lp1),
                   acc),            # accumulate: read-modify-write
            writes=(acc,))
    if isinstance(insn, AluInsn):
        d0, d1 = int(uops[:, 0].min()), int(uops[:, 0].max()) + 1
        dst = (Buffer.ACC,) + _env(d0, d1, insn.dst_f0, insn.dst_f1,
                                   insn.lp0, insn.lp1)
        reads = []
        if insn.alu_op == AluOp.MAC or not insn.use_imm:
            s0, s1 = int(uops[:, 1].min()), int(uops[:, 1].max()) + 1
            reads.append((Buffer.ACC,) + _env(s0, s1, insn.src_f0,
                                              insn.src_f1, insn.lp0, insn.lp1))
        if insn.alu_op == AluOp.MAC:
            reads.append((Buffer.ACC, int(uops[:, 2].min()),
                          int(uops[:, 2].max()) + 1))
        if not insn.overwrite:
            reads.append(dst)
        return Touch(reads=tuple(reads), writes=(dst,))
    return Touch()


# ---------------------------------------------------------------------------
# The lowering passes
# ---------------------------------------------------------------------------
class _UopReplay:
    """Static replay of the uop scratchpad across the instruction stream."""

    def __init__(self, prog: Program, hw: VTAConfig):
        self.buf = np.zeros((hw.uop_depth, 3), np.int64)
        self.mem = np.array(
            [(u.acc_idx, u.inp_idx, u.wgt_idx) for u in prog.uop_mem],
            np.int64).reshape(-1, 3)

    def load(self, insn: LoadInsn) -> np.ndarray:
        n = insn.x_size
        vals = self.mem[insn.dram_base:insn.dram_base + n]
        self.buf[insn.sram_base:insn.sram_base + n] = vals
        return vals

    def window(self, bgn: int, end: int) -> np.ndarray:
        return self.buf[bgn:end].copy()


def lower(prog: Program, hw: VTAConfig, shapes: dict) -> Trace:
    """Full lowering: Program + DRAM tensor shapes -> typed tensor-op trace.

    ``shapes`` maps tensor names to array shapes (the dram dict's shapes);
    only tensors the program actually touches need to be present.
    """
    replay = _UopReplay(prog, hw)
    ops: list = []
    touches: list = []
    read, written = [], []

    def shape_of(tensor: str):
        if tensor not in shapes:
            raise KeyError(f"program references DRAM tensor {tensor!r} "
                           f"missing from dram dict (has {sorted(shapes)})")
        return shapes[tensor]

    for step, insn in enumerate(prog.order):
        uops = None
        if isinstance(insn, LoadInsn):
            if insn.buffer == Buffer.UOP:
                vals = replay.load(insn)
                ops.append(UopLoad(step=step, base=insn.sram_base,
                                   values=vals))
            else:
                meta = getattr(insn, "meta", None)
                assert meta is not None, "data loads need meta"
                tensor = meta.get("tensor") or _load_default_tensor(meta["kind"])
                idx, mask, fill = _gather_index(insn, hw, shape_of(tensor))
                if tensor not in read:
                    read.append(tensor)
                ops.append(GatherLoad(step=step, buffer=insn.buffer,
                                      tensor=tensor, base=insn.sram_base,
                                      index=idx.astype(np.int32), mask=mask,
                                      fill=fill,
                                      dram_bytes=insn_dram_bytes(insn, hw)))
        elif isinstance(insn, GemmInsn):
            uops = replay.window(insn.uop_bgn, insn.uop_end)
            acc_i, inp_i, wgt_i = _gemm_indices(insn, uops)
            ops.append(GemmOp(step=step, acc_idx=acc_i, inp_idx=inp_i,
                              wgt_idx=wgt_i, reset=insn.reset))
        elif isinstance(insn, AluInsn):
            uops = replay.window(insn.uop_bgn, insn.uop_end)
            ops.append(AluSweep(step=step, alu_op=insn.alu_op,
                                use_imm=insn.use_imm, imm=insn.imm,
                                overwrite=insn.overwrite,
                                steps=_alu_steps(insn, uops)))
        elif isinstance(insn, StoreInsn):
            if insn.on_chip:
                dst, stride = insn.meta["dst"], insn.meta["dst_stride"]
                r = np.arange(insn.y_size)[:, None]
                j = np.arange(insn.x_size)[None, :]
                ops.append(SpillStore(
                    step=step,
                    src=(insn.sram_base + r * insn.x_size + j)
                    .reshape(-1).astype(np.int32),
                    dst=(dst + r * stride + j).reshape(-1).astype(np.int32)))
            else:
                tensor = insn.meta.get("tensor", "out")
                idx, mask = _scatter_index(insn, hw, shape_of(tensor))
                if tensor not in written:
                    written.append(tensor)
                ops.append(ScatterStore(step=step, tensor=tensor,
                                        base=insn.sram_base,
                                        index=idx.astype(np.int32), mask=mask,
                                        dram_bytes=insn_dram_bytes(insn, hw)))
        else:
            ops.append(None)         # FINISH
        touches.append(_touch_of(insn, hw, uops))
    chains, elided = _mark_direct(ops, _mark_alu_chains(ops), hw.acc_depth,
                                  shapes)
    return Trace(hw=hw, insns=list(prog.order), ops=ops, touches=touches,
                 tensors_read=tuple(read), tensors_written=tuple(written),
                 alu_chains=chains, elided=elided,
                 fused_segment=bool(getattr(prog, "fused_segment", False)))


def lower_cached(prog: Program, hw: VTAConfig, shapes: dict) -> Trace:
    """``lower``, memoized on the Program object per (hw, relevant shapes).

    Serving dispatches the same Program thousands of times with a handful
    of distinct shape sets (one per batch bucket's tensor layout — the
    per-image shapes, not the batch size, so usually exactly one); paying
    index-map construction once per distinct set keeps lowering off the
    dispatch hot path. The cache lives on the Program instance itself, so
    it dies with the program and never aliases across programs.
    """
    memo = prog.__dict__.setdefault("_lowered", {})
    key = (hw, tuple(sorted((t, tuple(s)) for t, s in shapes.items())))
    hit = memo.get(key)
    if hit is None:
        hit = memo[key] = lower(prog, hw, shapes)
    return hit


def lower_ranges(prog: Program, hw: VTAConfig) -> list:
    """Per-instruction scratchpad Touch list only (no DRAM shapes needed) —
    the cheap pass behind ``run_tsim(check_hazards=True)``."""
    replay = _UopReplay(prog, hw)
    touches = []
    for insn in prog.order:
        uops = None
        if isinstance(insn, LoadInsn) and insn.buffer == Buffer.UOP:
            replay.load(insn)
        elif isinstance(insn, (GemmInsn, AluInsn)):
            uops = replay.window(insn.uop_bgn, insn.uop_end)
        touches.append(_touch_of(insn, hw, uops))
    return touches
