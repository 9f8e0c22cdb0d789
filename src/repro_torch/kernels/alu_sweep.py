"""Fused ALU stage programs: one CUDA kernel for chains and DRAM-direct sweeps.

Replaces ``repro/kernels/alu_sweep.py::pallas_chain`` (body ``eval_chain``)
and ``::pallas_sweep`` (body ``eval_sweep``). The stage encoding is the JAX
package's (plain data; see that module's docstring):

  ``("seed_imm", imm)`` ``("seed_copy",)`` ``("seed_mac",)`` ``("read_dst",)``
  ``("mac", T)`` ``("red", name, T)`` ``("src", name)`` ``("imm", name, imm)``

Everything here is batched over a leading image axis N: acc is
(N, depth, BV, BO) int32, a slab's flat DRAM tensor is (N, L) — or (L,) for a
tensor the batch shares — and the store's flat tensor is (N, L). Index
vectors carry no N axis. Unlike the functional JAX versions, both the kernel
and the plain versions update acc and the output tensor in place (the
executor owns them) and return them.

``SweepProgram`` is one lowered chain, encoded once on the host: the int32
``meta`` buffer ``csrc/alu_sweep.cu`` interprets (uploaded once per device)
and the index tensors the plain versions use. ``alu_chain`` / ``alu_sweep``
are the kernel's wrappers: CUDA tensors launch the kernel and count it in
``LAUNCHES``; CPU tensors take ``eval_chain_plain`` / ``eval_sweep_plain``,
line-for-line ports of the JAX versions.

``sweep_plan`` picks how many threads of a warp share one item of a launch
(the kernel's tap split S): more where a sweep has few items, so that the
grid fills the card, and 1 wherever a split stage's op depends on the order
of its taps. ``max_split`` is the largest S a program takes.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.registry import register_kernel

LAUNCHES = {"alu_chain": 0, "alu_sweep": 0}
# guards every program's device copies: a CUDA graph captured by one
# thread holds their addresses, so another thread must never replace them
_DEV_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _binop(name: str, v, s):
    if name == "add":
        return v + s
    if name == "max":
        return torch.maximum(v, s)
    if name == "min":
        return torch.minimum(v, s)
    if name == "shr":
        return torch.bitwise_right_shift(v, s)
    if name == "mul":
        return v * s
    raise ValueError(name)


def _i32(x: int, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=device)


def _sum32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 sum with wraparound (int64 sum, then modular narrowing)."""
    return x.sum(dim, dtype=torch.int64).to(torch.int32)


def _last_writer(idx: torch.Tensor, keep: Optional[torch.Tensor],
                 size: int) -> torch.Tensor:
    """Bool mask of the lanes that write last to their position among the
    kept lanes: a sequential scatter's result with duplicate indices."""
    pos = torch.arange(idx.numel(), device=idx.device)
    if keep is not None:
        pos = torch.where(keep, pos, torch.full_like(pos, -1))
    last = torch.full((size,), -1, dtype=pos.dtype, device=idx.device)
    last.scatter_reduce_(0, idx, pos, "amax")
    return last[idx] == pos


def _put(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
         unique: bool) -> None:
    """``arr[:, idx] = val`` in place, last writer winning on duplicates."""
    if not unique:
        keep = _last_writer(idx, None, arr.shape[1])
        idx, val = idx[keep], val[:, keep]
    arr[:, idx] = val


def _run_stages(acc, dst, stages, vals):
    """Reduce a stage program over pre-gathered operand VALUES (the JAX
    ``_run_stages`` with a leading image axis)."""
    it = iter(vals)
    v = None
    for st in stages:
        kind = st[0]
        if kind == "read_dst":
            v = acc[:, dst]
        elif kind == "seed_imm":
            v = torch.full_like(acc[:, dst], int(st[1]))
        elif kind == "seed_copy":
            v = next(it)
        elif kind == "seed_mac":                # (N,g,...) * (N,1,...)
            v = next(it) * next(it)
        elif kind == "mac":
            srcs = next(it)                     # (N, T, g, BV, BO) | per-tap
            src2 = next(it)                     # (N, T, BV, BO)
            if isinstance(srcs, list):
                for t, s in enumerate(srcs):
                    v = v + s * src2[:, t, None]
            else:
                v = v + _sum32(srcs * src2[:, :, None], 1)
        elif kind == "red":
            s = next(it)                        # (N, T, g, BV, BO)
            name = st[1]
            if isinstance(s, list):
                for x in s:
                    v = _binop(name, v, x)
            elif name == "add":
                v = v + _sum32(s, 1)
            elif name == "max":
                v = torch.maximum(v, s.amax(1))
            else:
                v = torch.minimum(v, s.amin(1))
        elif kind == "src":
            v = _binop(st[1], v, next(it))
        elif kind == "imm":
            name, imm = st[1], st[2]
            if name == "clip":
                bound = abs(int(imm))
                v = torch.clamp(v, -bound, bound)
            else:
                v = _binop(name, v, _i32(int(imm), v.device))
        else:
            raise ValueError(kind)
    return v


def eval_chain_plain(acc, dst, stages, args, *, unique: bool = False):
    """Evaluate one stage program against ``acc`` (N, depth, BV, BO) int32
    in place; ``dst`` (g,) and ``args`` are index tensors consumed by the
    stages. Returns acc."""
    v = _run_stages(acc, dst, stages, [acc[:, a] for a in args])
    _put(acc, dst, v, unique)
    return acc


def eval_sweep_plain(acc, dst, stages, ops_args, *, slabs=(),
                     write_acc: bool = True, unique: bool = False,
                     out_flat=None, store_idx=None, store_mask=None,
                     store_unique: bool = False, store_affine=None):
    """The DRAM-direct sweep (JAX ``eval_sweep``), batched and in place.

    ``slabs`` entries ``(flat, idx, mask, fill)``; ``ops_args`` entries
    ``("acc", rows)`` or ``("local", rows)``; ``store_idx`` holds the block
    starts when ``store_affine`` is given, else the (g, BV, BO) flat
    positions (``store_mask`` False lanes drop). Returns ``(acc, out_flat)``.
    """
    n = acc.shape[0]
    parts = []
    for flat, idx, mask, fill in slabs:
        s = flat[..., idx]
        if mask is not None:
            s = torch.where(mask, s, torch.tensor(fill).to(s.dtype))
        if s.dim() == idx.dim():            # a tensor the batch shares
            s = s.expand(n, *s.shape)
        parts.append(s)
    local = None
    if parts:
        if len({p.dtype for p in parts}) > 1:
            parts = [p.to(torch.int32) for p in parts]
        local = parts[0] if len(parts) == 1 else torch.cat(parts, 1)

    def val(d):
        if d[0] == "acc":
            return acc[:, d[1]]
        return local[:, d[1]].to(torch.int32)

    def taps(d):
        if d[0] == "acc":
            return [acc[:, r] for r in d[1]]
        return [local[:, r].to(torch.int32) for r in d[1]]

    si = iter(ops_args)
    vals = []
    for st in stages:
        k = st[0]
        if k == "seed_copy" or k == "src":
            vals.append(val(next(si)))
        elif k == "seed_mac":
            vals.append(val(next(si)))
            vals.append(val(next(si)))
        elif k == "mac":
            vals.append(taps(next(si)))
            vals.append(val(next(si)))
        elif k == "red":
            vals.append(val(next(si)))

    v = _run_stages(acc, dst, stages, vals)
    if write_acc:
        _put(acc, dst, v, unique)
    if out_flat is not None:
        vals = torch.clamp(v, -128, 127).to(out_flat.dtype)
        if store_affine is not None:
            view_shape, perm, sizes = store_affine
            block = vals.permute(0, *[p + 1 for p in perm]).reshape(n, *sizes)
            view = out_flat.view(n, *view_shape)
            starts = [int(s) for s in store_idx]
            view[(slice(None),) + tuple(slice(s, s + z) for s, z in
                                        zip(starts, sizes))] = block
        else:
            idx = store_idx.reshape(-1)
            vals = vals.reshape(n, -1)
            keep = None if store_mask is None else store_mask.reshape(-1)
            if not store_unique:
                last = _last_writer(idx, keep, out_flat.shape[-1])
                keep = last if keep is None else keep & last
            if keep is not None:
                idx, vals = idx[keep], vals[:, keep]
            out_flat[:, idx] = vals
    return acc, out_flat


# ---------------------------------------------------------------------------
# The encoded stage program
# ---------------------------------------------------------------------------
_OPC = {"seed_imm": 0, "seed_copy": 1, "seed_mac": 2, "read_dst": 3,
        "mac": 4, "red": 5, "src": 6, "imm": 7}
_CLIP = 8
_BIN = {"add": 0, "max": 1, "min": 2, "shr": 3, "mul": 4}
# operand slots each stage consumes, in order
_SLOTS = {"seed_copy": 1, "src": 1, "seed_mac": 2, "mac": 2, "red": 1}


def _affine_positions(affine, starts, shape) -> np.ndarray:
    """Flat position of every chain value (shape ``(g, BV, BO)``) under an
    affine block store: the block of ``view_shape`` at ``starts`` holds
    ``vals.transpose(perm).reshape(sizes)``."""
    view_shape, perm, sizes = affine
    strides = np.ones(len(view_shape), np.int64)
    for i in range(len(view_shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * view_shape[i + 1]
    pos = np.zeros(sizes, np.int64)
    for k, (s, z) in enumerate(zip(starts, sizes)):
        ax = [1] * len(sizes)
        ax[k] = z
        pos = pos + ((s + np.arange(z)) * strides[k]).reshape(ax)
    tshape = [shape[p] for p in perm]
    return pos.reshape(tshape).transpose(np.argsort(perm))


def last_writer_positions(index, mask, unique: bool) -> np.ndarray:
    """Flat scatter positions with -1 for dropped lanes: masked, or not the
    last writer of a duplicated position (a sequential scatter's winner).
    ``unique`` says the positions are known distinct."""
    idx = index.reshape(-1).astype(np.int64)
    keep = np.ones(idx.shape, bool) if mask is None else mask.reshape(-1)
    if not unique:
        lanes = np.flatnonzero(keep)
        rev = lanes[::-1]
        _, first = np.unique(idx[rev], return_index=True)
        keep = np.zeros_like(keep)
        keep[rev[first]] = True
    return np.where(keep, idx, -1)


class SweepProgram:
    """One fused chain, encoded once for the kernel and the plain versions.

    ``operands``: ``("acc" | "local", rows)`` per stage operand slot;
    ``slabs``: ``(tensor, index, mask, fill)`` feeder gathers; ``store``:
    ``(tensor, index, mask, unique, affine, starts)`` or None, with
    ``affine`` ``(view_shape, perm, sizes)`` or None.
    """

    def __init__(self, stages: tuple, dst: np.ndarray, operands: list, *,
                 lane_shape: tuple, slabs: tuple = (), write_acc: bool = True,
                 unique: bool = True, store: Optional[tuple] = None):
        self.stages = tuple(stages)
        self.dst = np.asarray(dst, np.int32)
        self.operands = [(k, np.asarray(r)) for k, r in operands]
        self.slabs = tuple(slabs)
        self.write_acc = write_acc
        self.unique = unique
        self.store = store
        self.lane_shape = tuple(lane_shape)
        self.lanes = int(np.prod(self.lane_shape))
        self.g = len(self.dst)
        if not unique:
            raise ValueError("fused chains need unique destination rows")
        self.meta, self.offsets = self._encode()
        self._dev: dict = {}

    @property
    def slab_tensors(self) -> tuple:
        return tuple(s[0] for s in self.slabs)

    @property
    def store_tensor(self) -> Optional[str]:
        return None if self.store is None else self.store[0]

    def _encode(self):
        head, body = [], []
        n_stage_words = 4 * len(self.stages)
        n_slot_words = 3 * len(self.operands)
        off_slabs = n_stage_words + n_slot_words
        off_dst = off_slabs + 4 * len(self.slabs)
        off_store = off_dst + self.g
        cursor = off_store + (self.g * self.lanes if self.store else 0)

        def place(arr) -> int:
            nonlocal cursor
            at = cursor
            body.append(np.asarray(arr, np.int64).reshape(-1))
            cursor += body[-1].size
            return at

        slots = []
        it = iter(range(len(self.operands)))
        n_local = sum(int(s[1].shape[0]) for s in self.slabs)
        stage_words = []
        for st in self.stages:
            kind = st[0]
            sl = [next(it) for _ in range(_SLOTS.get(kind, 0))]
            for j, i in enumerate(sl):
                src, rows = self.operands[i]
                # a mac / seed_mac second operand is one row per tap
                per_tap = kind in ("mac", "seed_mac") and j == 1
                if rows.ndim == 2:
                    ncols = rows.shape[1]
                else:
                    ncols = 1 if per_tap else rows.size
                if src == "local" and rows.size and \
                        int(rows.max()) >= n_local:
                    raise ValueError("local operand row outside the slabs")
                slots.append((0 if src == "acc" else 1, place(rows), ncols))
            base = n_stage_words
            addr = [base + 3 * i for i in sl]
            if kind == "seed_imm":
                stage_words.append((_OPC[kind], int(st[1]), 0, 0))
            elif kind in ("seed_copy", "src"):
                b = _BIN[st[1]] if kind == "src" else 0
                stage_words.append((_OPC[kind], addr[0], b, 0))
            elif kind == "seed_mac":
                stage_words.append((_OPC[kind], addr[0], addr[1], 0))
            elif kind == "read_dst":
                stage_words.append((_OPC[kind], 0, 0, 0))
            elif kind == "mac":
                stage_words.append((_OPC[kind], addr[0], addr[1], int(st[1])))
            elif kind == "red":
                stage_words.append((_OPC[kind], addr[0], _BIN[st[1]],
                                    int(st[2])))
            elif kind == "imm":
                if st[1] == "clip":
                    stage_words.append((_CLIP, 0, abs(int(st[2])), 0))
                else:
                    stage_words.append((_OPC[kind], _BIN[st[1]],
                                        int(st[2]), 0))
            else:
                raise ValueError(kind)
        if next(it, None) is not None:
            raise ValueError("more operands than the stages consume")
        slab_words, row0 = [], 0
        # the extents every pointer the kernel gets must cover
        acc_rows = [self.dst] + [r for k, r in self.operands if k == "acc"]
        self.extent = {"acc": 1 + max(int(np.max(r)) for r in acc_rows
                                      if np.size(r)),
                       "slabs": [], "store": 0}
        for _, index, mask, fill in self.slabs:
            idx = index.astype(np.int64)
            if mask is not None:
                idx = np.where(mask, idx, -1)
            slab_words.append((row0, index.shape[0], place(idx), int(fill)))
            self.extent["slabs"].append(1 + int(idx.max(initial=-1)))
            row0 += index.shape[0]
        for w in stage_words:
            head.extend(w)
        for w in slots:
            head.extend(w)
        for w in slab_words:
            head.extend(w)
        head.extend(self.dst.tolist())
        if self.store is not None:
            _, index, mask, s_unique, affine, starts = self.store
            if affine is not None:
                store_pos = _affine_positions(affine, starts,
                                              (self.g,) + self.lane_shape)
            else:
                store_pos = last_writer_positions(index, mask, s_unique)
            head.extend(np.asarray(store_pos).reshape(-1).tolist())
            self.extent["store"] = 1 + int(np.max(store_pos, initial=-1))
        meta = np.concatenate([np.asarray(head, np.int64)] + body) \
            if body else np.asarray(head, np.int64)
        if meta.size and (meta.max() > 2**31 - 1 or meta.min() < -2**31):
            raise ValueError("stage program does not fit int32")
        offsets = {"n_stages": len(self.stages), "off_slabs": off_slabs,
                   "off_dst": off_dst,
                   "off_store": off_store if self.store is not None else -1}
        return meta.astype(np.int32), offsets

    def device_meta(self, device) -> torch.Tensor:
        key = ("meta", str(device))
        with _DEV_LOCK:
            t = self._dev.get(key)
            if t is None:
                t = self._dev[key] = torch.from_numpy(
                    self.meta.copy()).to(device)
        return t

    def tensors(self, device) -> dict:
        """The index tensors the plain versions take, on ``device``, once."""
        key = ("plain", str(device))
        with _DEV_LOCK:
            hit = self._dev.get(key)
            if hit is None:
                hit = self._dev[key] = self._plain_tensors(device)
        return hit

    def _plain_tensors(self, device) -> dict:
        def long(a):
            return torch.from_numpy(np.asarray(a, np.int64).copy()).to(device)

        def boolean(a):
            return None if a is None else \
                torch.from_numpy(np.asarray(a, bool).copy()).to(device)

        out = {"dst": long(self.dst),
               "ops": [(k, long(r)) for k, r in self.operands],
               "slabs": [(long(i), boolean(m), f)
                         for _, i, m, f in self.slabs]}
        if self.store is not None:
            _, index, mask, s_unique, affine, starts = self.store
            out["store"] = dict(
                store_unique=s_unique, store_affine=affine,
                store_idx=list(starts) if affine is not None else long(index),
                store_mask=None if affine is not None else boolean(mask))
        return out


def chain_plain(acc, prog: SweepProgram):
    t = prog.tensors(acc.device)
    return eval_chain_plain(acc, t["dst"], prog.stages,
                            [r for _, r in t["ops"]], unique=prog.unique)


def sweep_plain(acc, prog: SweepProgram, flats=(), out_flat=None):
    t = prog.tensors(acc.device)
    slabs = [(flat, i, m, f) for flat, (i, m, f) in zip(flats, t["slabs"])]
    kw = t.get("store", {}) if out_flat is not None else {}
    return eval_sweep_plain(acc, t["dst"], prog.stages, t["ops"], slabs=slabs,
                            write_acc=prog.write_acc, unique=prog.unique,
                            out_flat=out_flat, **kw)


# ---------------------------------------------------------------------------
# The tap split
# ---------------------------------------------------------------------------
SPLIT_OPS = ("add", "max", "min")   # red ops whose taps may meet in any order
MAX_SPLIT = 32                      # threads of one warp
MAX_HEAD = 64                       # header words a launch passes
FILL_THREADS = 132 * 256            # one 256-thread block for each H100 SM


def max_split(prog: SweepProgram) -> int:
    """The largest tap split ``prog`` takes: the largest power of two up to
    its longest ``red``/``mac`` stage (at most 32), or 1 when it has none or
    a ``red`` stage whose op is not order-free in int32 (wrapping add, mac,
    max and min are)."""
    taps = []
    for st in prog.stages:
        if st[0] == "mac":
            taps.append(int(st[1]))
        elif st[0] == "red":
            if st[1] not in SPLIT_OPS:
                return 1
            taps.append(int(st[2]))
    s = 1
    while taps and 2 * s <= min(max(taps), MAX_SPLIT):
        s *= 2
    return s


def sweep_plan(prog: SweepProgram, n: int) -> int:
    """The tap split of ``prog`` at batch ``n``: doubled from 1 while the
    launch's threads (items x split) stay below ``FILL_THREADS``, up to
    ``max_split``. The trunk's global average pool (one row of 16 lanes) at
    batch 8 takes 32, 16 blocks instead of one; its pool1 tiles take 4."""
    cap = max_split(prog)
    items = n * prog.g * prog.lanes
    s = 1
    while s < cap and items * s < FILL_THREADS:
        s *= 2
    return s


# ---------------------------------------------------------------------------
# The kernel's wrappers
# ---------------------------------------------------------------------------
def _fn():
    fn = _build.library("alu_sweep").alu_sweep_launch
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, ll, vp, i, i, i, i, i, i, i, i, i, vp, vp, vp, vp,
                       vp, ll, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(acc, prog: SweepProgram, flats, out_flat,
            split: Optional[int] = None) -> None:
    dev = acc.device
    if acc.dtype != torch.int32 or acc.dim() != 4 or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous (N, depth, BV, BO) int32 "
                         "tensor")
    n, depth, bv, bo = acc.shape
    if bv * bo != prog.lanes:
        raise ValueError(f"acc lanes {bv * bo} != program lanes {prog.lanes}")
    if depth < prog.extent["acc"]:
        raise ValueError(f"acc depth {depth} < rows the program reads or "
                         f"writes ({prog.extent['acc']})")
    if len(flats) != len(prog.slabs):
        raise ValueError(f"{len(prog.slabs)} slab tensors expected, "
                         f"got {len(flats)}")
    ptrs, strides, esz = [], [], []
    for f in flats:
        if f.device != dev or not f.is_contiguous() or \
                f.dtype not in (torch.int8, torch.int32) or \
                f.dim() not in (1, 2) or (f.dim() == 2 and f.shape[0] != n):
            raise ValueError("slab tensors must be contiguous int8/int32 "
                             "(N, L) or shared (L,) tensors on acc's device")
        if f.shape[-1] < prog.extent["slabs"][len(ptrs)]:
            raise ValueError("a slab tensor is shorter than its index map")
        ptrs.append(f.data_ptr())
        strides.append(0 if f.dim() == 1 else f.shape[1])
        esz.append(f.element_size())
    out_ptr, out_stride = None, 0
    if prog.store is not None:
        if out_flat is None or out_flat.device != dev or \
                out_flat.dtype != torch.int8 or out_flat.dim() != 2 or \
                out_flat.shape[0] != n or not out_flat.is_contiguous():
            raise ValueError("the store takes a contiguous (N, L) int8 "
                             "tensor on acc's device")
        if out_flat.shape[1] < prog.extent["store"]:
            raise ValueError("the store tensor is shorter than its index map")
        for f in flats:
            if f.untyped_storage().data_ptr() == \
                    out_flat.untyped_storage().data_ptr():
                raise ValueError("the store tensor aliases a slab tensor")
        out_ptr, out_stride = out_flat.data_ptr(), out_flat.shape[1]
    if split is None:
        split = sweep_plan(prog, n)
    elif split not in (1, 2, 4, 8, 16, 32) or split > max_split(prog):
        raise ValueError(f"tap split {split} is not a power of two up to "
                         f"this program's {max_split(prog)}")
    k = len(flats)
    o = prog.offsets
    if o["off_dst"] > MAX_HEAD:
        raise ValueError(f"stage program header of {o['off_dst']} words > "
                         f"{MAX_HEAD}")
    meta = prog.device_meta(dev)
    header = prog._dev.get("header")
    if header is None:           # the stages, slots and slab descriptors
        header = prog._dev["header"] = (ctypes.c_int * max(o["off_dst"], 1))(
            *prog.meta[:o["off_dst"]].tolist())
    status = _fn()(
        acc.data_ptr(), depth * bv * bo, meta.data_ptr(), o["n_stages"],
        o["off_slabs"], k, o["off_dst"], o["off_store"], prog.g, prog.lanes,
        n, split, header, (ctypes.c_void_p * max(k, 1))(*ptrs),
        (ctypes.c_longlong * max(k, 1))(*strides),
        (ctypes.c_int * max(k, 1))(*esz), out_ptr, out_stride,
        int(prog.write_acc), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "alu_sweep")


def alu_chain(acc, prog: SweepProgram, *, split: Optional[int] = None):
    """Chain wrapper: CUDA acc launches ``csrc/alu_sweep.cu`` (all operands
    from acc, no store) with tap split ``split`` (default ``sweep_plan``);
    CPU acc takes ``eval_chain_plain``."""
    if not acc.is_cuda:
        return chain_plain(acc, prog)
    if prog.slabs or prog.store is not None:
        raise ValueError("alu_chain takes scratchpad-only programs")
    _launch(acc, prog, (), None, split)
    count_launch(LAUNCHES, "alu_chain")
    return acc


def alu_sweep(acc, prog: SweepProgram, flats=(), out_flat=None, *,
              split: Optional[int] = None):
    """Sweep wrapper: CUDA acc launches ``csrc/alu_sweep.cu`` with tap split
    ``split`` (default ``sweep_plan``); CPU acc takes ``eval_sweep_plain``.
    Returns ``(acc, out_flat)``, both updated in place."""
    if not acc.is_cuda:
        return sweep_plain(acc, prog, flats, out_flat)
    _launch(acc, prog, tuple(flats), out_flat, split)
    count_launch(LAUNCHES, "alu_sweep")
    return acc, out_flat


register_kernel("alu_chain", "cuda", alu_chain)
register_kernel("alu_chain", "torch", chain_plain)
register_kernel("alu_sweep", "cuda", alu_sweep)
register_kernel("alu_sweep", "torch", sweep_plain)
