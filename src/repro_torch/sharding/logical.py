"""Logical axis rules with divisibility-adaptive mesh mapping, on
``torch.distributed``; the port of ``repro/sharding/logical.py``.

Tensors throughout the model code carry *logical* dim names; a rules table maps
each logical name to zero or more mesh axes. The mapping is applied only when a
mesh context is active (set by the launcher / dry-run) and only when the dim
size is divisible by the product of the mapped mesh-axis sizes — otherwise the
mapping *falls back* (drops trailing axes until divisible). This keeps every
assigned architecture shardable on the fixed production mesh even when e.g.
qwen2.5's 40 heads don't divide the 16-way model axis.

The tables, ``_rank``, ``_resolve`` and ``spec`` are the reference's, the spec
type changed: a ``PartitionSpec`` here is a tuple of ``None | str | tuple[str,
...]``, equal entry by entry to the JAX package's. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (or any object with
``axis_names`` and ``devices.shape``, enough for ``spec``), and a sharding is
a DTensor placement list: ``spec_placements`` turns a spec into one, a dim
mapped to axis ``a`` giving ``Shard(dim)`` on ``a``, a dim mapped to
``("pod", "data")`` ``Shard(dim)`` on both, pod-major as GSPMD splits it, and
every other mesh dim ``Replicate()``.

Under ``use_rules`` with a ``DeviceMesh``, a plain tensor that meets a DTensor
in an op (rope tables, positions, masks, ``torch.arange``) is taken as
replicated (``implicit_replication``): those are the same on every rank.

This table is itself a search space: ``core/sharding_search.py`` (SPS)
enumerates rule tables (min communication bytes subject to per-device HBM
capacity).
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

# Logical dim vocabulary used across the model code.
LOGICAL_DIMS = (
    "batch", "seq", "d_model", "d_ff", "heads", "kv_heads", "head_dim",
    "vocab", "experts", "expert_cap", "moe_d_ff", "lru", "layers", "codebooks",
    "kv_seq", "conv_w", "low_rank",
)

# Default rule table: DP over (pod, data), TP over model, FSDP of the
# contraction dim over data. `None` entries are explicitly unsharded.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),           # sequence parallelism for the residual stream;
                                 # loses to heads/d_ff/vocab by priority inside
                                 # attention/MLP/loss tensors
    "kv_seq": ("data",),         # decode KV caches: seq-shard when batch can't use data
    "d_model": ("data",),        # FSDP: weights' d_model dim sharded over data
    "d_ff": ("model",),
    "moe_d_ff": ("model",),      # claimed only when "experts" can't take model
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),      # fallback TP when heads/kv_heads don't divide
    "vocab": ("model",),
    "experts": ("model",),
    "expert_cap": (),
    "lru": ("model",),
    "layers": (),
    "codebooks": (),
    "conv_w": (),
    "low_rank": (),
}

# Axis-assignment priority: earlier names claim mesh axes first (independent
# of their position in the tensor). E.g. q (batch, seq, heads, head_dim):
# "heads" outranks "seq", so heads take the model axis and seq stays full
# inside attention, while the residual stream (no heads dim) is seq-sharded —
# Megatron-style TP+SP emerging from one declarative table.
#
# Weights vs activations rank "head_dim" differently: for weights it is the
# TP fallback when head counts don't divide (qwen2.5's 40 heads); for
# activations a head_dim-sharded attention contraction would all-reduce full
# (seq x seq) logits, so sequence sharding must win instead.
PRIORITY_WEIGHTS = (
    "experts", "heads", "kv_heads", "vocab", "d_ff", "moe_d_ff", "lru",
    "head_dim", "batch", "kv_seq", "seq", "d_model", "expert_cap", "layers",
    "codebooks", "conv_w", "low_rank",
)
PRIORITY_ACTS = (
    "experts", "heads", "kv_heads", "vocab", "d_ff", "moe_d_ff", "lru",
    "batch", "kv_seq", "seq", "head_dim", "d_model", "expert_cap", "layers",
    "codebooks", "conv_w", "low_rank",
)


class PartitionSpec(tuple):
    """A tensor's mesh axes, dim by dim: ``None`` (unsharded), an axis name,
    or a tuple of axis names (major first). Equal to a tuple, and to the
    JAX package's ``PartitionSpec``, of the same entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> tuple:
    """(axis names, sizes) of a ``DeviceMesh`` or of a duck-typed mesh with
    ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), tuple(mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.devices.shape)


def spec_placements(spec: Sequence, mesh) -> list:
    """The DTensor placements of ``spec`` over ``mesh``: ``Shard(dim)`` on
    each mesh dim a tensor dim maps to, ``Replicate()`` on every other and
    on every mesh dim of size 1 (one rank holds the whole dim either way,
    and DTensor refuses some views of a dim sharded even over one rank).
    Raises on an axis the mesh lacks, one named twice, or a multi-axis
    entry out of the mesh's order (DTensor splits a dim over several mesh
    dims major first, in mesh order)."""
    names, sizes = mesh_axes(mesh)
    out, used = [Replicate()] * len(names), set()
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"spec {tuple(spec)}: axis not in mesh {names}")
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: axes {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            if i in used:
                raise ValueError(f"spec {tuple(spec)}: axis {names[i]} "
                                 f"used twice")
            used.add(i)
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: the port's ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: PartitionSpec

    def placements(self) -> list:
        return spec_placements(self.spec, self.mesh)


def _rank(name: Optional[str], *, is_act: bool) -> int:
    table = PRIORITY_ACTS if is_act else PRIORITY_WEIGHTS
    try:
        return table.index(name)
    except ValueError:
        return len(table)


@dataclass
class LogicalRules:
    mesh: object
    rules: dict[str, tuple[str, ...]] = field(default_factory=lambda: dict(DEFAULT_RULES))
    # Activation rules may differ from weight rules (e.g. sequence parallelism
    # for activations while weights stay FSDP-sharded).
    act_overrides: dict[str, tuple[str, ...]] = field(default_factory=dict)

    def axis_size(self, axis: str) -> int:
        return dict(zip(*mesh_axes(self.mesh))).get(axis, 1)

    def _resolve(self, name: Optional[str], dim_size: int, *, is_act: bool) -> Optional[tuple]:
        if name is None:
            return None
        table = self.rules
        if is_act and name in self.act_overrides:
            axes = self.act_overrides[name]
        else:
            axes = table.get(name, ())
        axis_names = mesh_axes(self.mesh)[0]
        axes = tuple(a for a in axes if a in axis_names)
        # divisibility fallback: drop trailing axes until the dim divides
        while axes:
            prod = 1
            for a in axes:
                prod *= self.axis_size(a)
            if prod > 0 and dim_size % prod == 0:
                break
            axes = axes[:-1]
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    def spec(self, names: Sequence[Optional[str]], shape: Sequence[int], *,
             is_act: bool = False) -> PartitionSpec:
        assert len(names) == len(shape), (names, shape)
        used: set = set()
        parts: list = [None] * len(names)
        # dims claim mesh axes in PRIORITY order, not positional order
        order = sorted(range(len(names)),
                       key=lambda i: _rank(names[i], is_act=is_act))
        for i in order:
            n, s = names[i], shape[i]
            r = self._resolve(n, s, is_act=is_act)
            if r is not None:
                axes = r if isinstance(r, tuple) else (r,)
                # drop already-claimed axes (keep the surviving prefix)
                free = []
                for a in axes:
                    if a in used:
                        break
                    free.append(a)
                # re-check divisibility on the surviving prefix
                if free:
                    prod = 1
                    for a in free:
                        prod *= self.axis_size(a)
                    if s % prod != 0:
                        free = []
                if not free:
                    r = None
                else:
                    used.update(free)
                    r = tuple(free) if len(free) > 1 else free[0]
            parts[i] = r
        return PartitionSpec(*parts)

    def sharding(self, names: Sequence[Optional[str]], shape: Sequence[int], *,
                 is_act: bool = False) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(names, shape, is_act=is_act))


_ctx = threading.local()


def set_rules(rules: Optional[LogicalRules]):
    _ctx.rules = rules


def get_rules() -> Optional[LogicalRules]:
    return getattr(_ctx, "rules", None)


def clear_rules():
    _ctx.rules = None


@contextlib.contextmanager
def use_rules(rules: Optional[LogicalRules]):
    """``rules`` active in the block; with a ``DeviceMesh``, plain tensors
    meeting DTensors are taken as replicated (``implicit_replication``)."""
    prev = get_rules()
    set_rules(rules)
    try:
        with contextlib.ExitStack() as stack:
            if rules is not None and hasattr(rules.mesh, "mesh_dim_names"):
                stack.enter_context(implicit_replication())
            yield rules
    finally:
        set_rules(prev)


def lshard(x, *names):
    """Apply a logical sharding constraint to activation ``x``: the identity
    without an active rules context, so model code runs unchanged on one
    device; under rules, ``x`` (a DTensor) redistributed to the placements
    of its names, and its gradient too (``_Constrain``): the counterpart of
    ``with_sharding_constraint``, whose transpose constrains the cotangent.
    Raises on a plain tensor under rules: the caller distributes its
    inputs."""
    r = get_rules()
    if r is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"lshard{names}: a plain tensor under logical rules; "
                        f"distribute the step's inputs over the mesh")
    return constrain(x, r.sharding(names, x.shape, is_act=True).placements())


def constrain(x, placements):
    """DTensor ``x`` in ``placements``, and its gradient in them too."""
    placements = tuple(placements)
    if not x.requires_grad:
        return _placed(x, placements)
    return _Constrain.apply(x, placements)


def _placed(x, placements):
    return x if tuple(x.placements) == placements else \
        x.redistribute(x.device_mesh, placements)


class _Constrain(torch.autograd.Function):
    """DTensor ``x`` in ``placements``, and its gradient in them too. A
    ``DTensor.redistribute`` alone sends the gradient back to ``x``'s own
    placements, and where ``x`` is already in place, leaves it as the
    backward made it: DTensor then picks each backward op's input moves
    alone (a ``Partial`` of the whole logits' gradient, say)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return _placed(x, placements).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _placed(g, ctx.placements), None


def _replicated(x, keep):
    """DTensor ``x`` with every mesh dim ``i`` whose placement ``p`` fails
    ``keep(i, p, n)`` replicated, ``n`` the product of the sizes of the
    mesh dims up to ``i`` that shard the same tensor dim as ``p``."""
    pl, seen = list(x.placements), {}
    for i, p in enumerate(pl):
        if p.is_shard():
            seen[p.dim] = seen.get(p.dim, 1) * x.device_mesh.size(i)
            if not keep(p, seen[p.dim]):
                pl[i] = Replicate()
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def split_dim(x, dim: int, sizes: tuple):
    """``x`` with ``dim`` split into ``sizes`` (a ``view``). A DTensor has
    the mesh dims that shard ``dim`` unevenly for ``sizes[0]`` replicated
    first (DTensor keeps a split dim's sharding on its leading part only),
    and its gradient is merged back by ``merge_dims``."""
    dim %= x.dim()
    if isinstance(x, DTensor):
        return _SplitDim.apply(x, dim, tuple(sizes))
    return x.view(tuple(x.shape[:dim]) + tuple(sizes)
                  + tuple(x.shape[dim + 1:]))


def merge_dims(x, dim: int, n: int = 2):
    """``x`` with the ``n`` dims from ``dim`` merged into one (a
    ``reshape``). A DTensor has the mesh dims that shard any but the first
    of them, or the first unevenly, replicated first (DTensor merges dims
    only where the leading one alone is sharded, and some of its versions
    refuse to redistribute inside a view), and its gradient is split back
    by ``split_dim``."""
    dim %= x.dim()
    if isinstance(x, DTensor):
        return _MergeDims.apply(x, dim, n)
    return x.reshape(tuple(x.shape[:dim]) + (-1,) + tuple(x.shape[dim + n:]))


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes):
        ctx.dim, ctx.n = dim, len(sizes)
        x = _replicated(x, lambda p, n: p.dim != dim or sizes[0] % n == 0)
        return x.view(tuple(x.shape[:dim]) + sizes + tuple(x.shape[dim + 1:]))

    @staticmethod
    def backward(ctx, g):
        return merge_dims(g, ctx.dim, ctx.n), None, None


class _MergeDims(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + n])
        x = _replicated(x, lambda p, k: not dim < p.dim < dim + n and (
            p.dim != dim or x.shape[dim] % k == 0))
        return x.reshape(tuple(x.shape[:dim]) + (-1,)
                         + tuple(x.shape[dim + n:]))

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None, None


def _gathered(w, x):
    """Weight ``w`` (d, n), a DTensor, placed for ``x @ w`` mesh dim by mesh
    dim where ``x`` (a DTensor) shards its rows (a dim but its last) on
    some mesh dim, as FSDP with tensor parallelism places it: replicated
    where ``x`` shards its rows and ``w`` shards d (the FSDP gather GSPMD
    inserts) or n (one mesh dim cannot split the output twice); n split
    where both are replicated, as far as it divides (column-parallel, a
    local slice: DTensor, finding no cost either way, would compute the
    whole product on every rank). Its gradient returns to ``w``'s
    placements by the redistribution's backward, a reduce-scatter. The
    other mesh dims, and an ``x`` whose rows are whole (a decode of one
    sequence), are DTensor's to choose. Left to itself, DTensor picks each
    op's cheapest input move alone: for the head it moved ``x`` to shard d
    and made a ``Partial`` of the whole (tokens, vocab) logits, 16 times
    the logits' shard, to reduce-scatter."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return w
    last, mesh = x.dim() - 1, w.device_mesh
    rows = [q.is_shard() and q.dim != last for q in x.placements]
    if not any(rows):
        return w
    pl = [Replicate() if p.is_shard() and r else p
          for p, r in zip(w.placements, rows)]
    split = math.prod(mesh.size(i) for i, p in enumerate(pl) if p.is_shard(1))
    for i, (p, q) in enumerate(zip(pl, x.placements)):
        n = mesh.size(i)
        if p.is_replicate() and q.is_replicate() and n > 1 \
                and w.shape[1] % (split * n) == 0:
            pl[i], split = Shard(1), split * n
    if pl == list(w.placements):
        return w
    return w.redistribute(mesh, pl)


def _whole_contraction(x, w):
    """DTensor ``x`` gathered over each mesh dim that shards its last dim
    where DTensor ``w`` leaves d whole: DTensor would take a slice of
    ``w`` and make the product a ``Partial`` there, which some of its
    versions cannot add to a sharded tensor (a bias over the heads). A
    row-parallel ``w``, sharded on d where ``x`` is, keeps its ``Partial``
    product."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return x
    last = x.dim() - 1
    return _placed(x, tuple(Replicate() if q.is_shard(last)
                            and not p.is_shard(0) else q
                            for p, q in zip(w.placements, x.placements)))


def linear(x, w):
    """``x @ w``, ``x`` (..., d) and ``w`` (d, n): ``torch.matmul``. A
    DTensor ``x`` of more than two dims has its leading dims merged first
    and split after (``merge_dims``, ``split_dim``): ``torch.matmul`` folds
    them by a view, which DTensor refuses where a later one (a sharded
    sequence) is sharded. A DTensor ``w`` is placed as ``_gathered`` says,
    then ``x`` as ``_whole_contraction`` says."""
    if not isinstance(x, DTensor) or x.dim() <= 2:
        w = _gathered(w, x)
        return torch.matmul(_whole_contraction(x, w), w)
    lead = tuple(x.shape[:-1])
    x = merge_dims(x, 0, len(lead))
    w = _gathered(w, x)
    return split_dim(torch.matmul(_whole_contraction(x, w), w), 0, lead)


def logical_sharding(names, shape, *, is_act=False) -> Optional[NamedSharding]:
    r = get_rules()
    if r is None:
        return None
    return r.sharding(names, shape, is_act=is_act)
