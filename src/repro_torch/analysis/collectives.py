"""Collective-byte accounting for the roofline, from dispatch: the port of
``repro/analysis/hlo.py::CollectiveStats`` and ``parse_collectives``.

The reference parses the compiled HLO text; the port has no compiled module.
``CollectiveCounter`` is a ``TorchDispatchMode`` that lets DTensor run first
(it returns ``NotImplemented`` for DTensor arguments, as ``CommDebugMode``
does) and so sees the functional collectives (``_c10d_functional``) that
DTensor issues on each rank's local tensors. It keeps the reference's kinds
(all-gather, all-reduce, reduce-scatter, all-to-all, collective-permute) and
its convention: operand bytes, not result bytes, per device (the local
shapes); a collective and its ``wait_tensor`` count once. It adds
``bytes_by_axis``, keyed by the mesh dim name of the collective's group.
On a CPU mesh (the dry-run's) DTensor moves a shard from one tensor dim to
another by an all-gather and a local chunk (gloo has no all-to-all), which
counts as the all-gather it is, of the same operand. The reference's
``shape_bytes`` parses HLO type strings and has no counterpart here.

With ``explain=True`` each collective is also filed under its cause
(``by_cause``): the op whose argument DTensor redistributed, that
argument's placements before and after, and the innermost line of the
port's own code on the stack (``redistribution_cause``).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
              "c10d_functional", "_dtensor")
# functional collective op name -> the reference's kind
KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",      # DTensor's, off a CPU mesh
}
NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
# the counters' own frames, which are on the stack of every collective
COUNTER_FILES = ("analysis/collectives.py", "launch/dryrun.py")


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)
    bytes_by_axis: dict = field(default_factory=dict)
    by_cause: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def add(self, kind: str, nbytes: int, axis: str,
            cause: str | None = None) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        self.bytes_by_axis[axis] = self.bytes_by_axis.get(axis, 0) + nbytes
        if cause is not None:
            row = self.by_cause.setdefault(
                (kind, axis, cause), {"kind": kind, "axis": axis,
                                      "cause": cause, "count": 0, "bytes": 0})
            row["count"] += 1
            row["bytes"] += nbytes

    def to_dict(self) -> dict:
        out = {"total_bytes": self.total_bytes,
               "bytes_by_kind": dict(self.bytes_by_kind),
               "count_by_kind": dict(self.count_by_kind),
               "bytes_by_axis": dict(self.bytes_by_axis)}
        if self.by_cause:
            out["by_cause"] = sorted(self.by_cause.values(),
                                     key=lambda r: -r["bytes"])
        return out


def tensor_bytes(x) -> int:
    """Bytes of a tensor, or of the tensors in a list or tuple."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


def group_axes(mesh) -> dict:
    """{process group name: mesh dim name} of ``mesh``'s dims."""
    if mesh is None:
        return {}
    return {mesh.get_group(d).group_name: d for d in mesh.mesh_dim_names}


def collective_kind(func):
    """The reference's kind of a functional collective op (any other
    collective under its own name), else None."""
    if getattr(func, "namespace", None) not in NAMESPACES:
        return None
    name = func._overloadpacket.__name__
    if func.namespace == "_dtensor":         # DTensor's own ops: one of them
        return KIND_OF.get(name)
    return None if name in NOT_COLLECTIVES else KIND_OF.get(name, name)


def _placements(spec) -> str:
    return "[" + ", ".join(map(str, spec.placements)) + "]"


def redistribution_cause() -> str:
    """The cause of the collective being dispatched, read off the
    interpreter's stack: ``"<op> <before> -> <after> @ <line>"``, the op
    whose argument DTensor redistributes (``redistribute`` for an explicit
    ``DTensor.redistribute``, ``(backward)`` for its gradient), the
    argument's placements before and after, and the innermost frame of the
    port's own code (none in a backward the autograd engine runs). It reads
    the local names of ``torch.distributed.tensor``'s private functions
    ``redistribute_local_tensor`` and ``redistribute_local_args``: a
    diagnostic, off unless asked for."""
    f, move, op, where = sys._getframe(1), None, None, None
    while f is not None:
        code, loc = f.f_code, f.f_locals
        if move is None and code.co_name == "redistribute_local_tensor":
            spec = loc["current_spec"]
            move = (f"{tuple(spec.shape)} {_placements(spec)} -> "
                    f"{_placements(loc['target_spec'])}")
        elif move is not None and op is None:
            if code.co_name == "redistribute_local_args":
                schema = loc.get("suggested_input_schema")
                op = str(getattr(schema, "op", "?"))
            elif code.co_qualname.startswith("Redistribute."):
                op = "redistribute" + (" (backward)"
                                       if code.co_name == "backward" else "")
        if where is None and "repro_torch" in code.co_filename and not \
                code.co_filename.endswith(COUNTER_FILES):
            where = (f"{code.co_filename.split('repro_torch/')[-1]}:"
                     f"{f.f_lineno} {code.co_name}")
        f = f.f_back
    return f"{op or '?'} {move or '?'} @ {where or '-'}"


class CollectiveCounter(TorchDispatchMode):
    """Records every functional collective dispatched in the block, on the
    local tensors, into ``stats``; ``mesh`` names the axes of its groups
    (a group of no mesh dim counts under its own name); ``explain`` files
    each under its cause too (``redistribution_cause``)."""

    def __init__(self, mesh=None, explain: bool = False):
        super().__init__()
        self.stats = CollectiveStats()
        self._axes = group_axes(mesh)
        self._explain = explain

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented     # DTensor desugars into local ops
        out = func(*args, **kwargs)
        self.on_local_op(func, args, kwargs, out)
        return out

    def on_local_op(self, func, args, kwargs, out) -> None:
        kind = collective_kind(func)
        if kind is None:
            return
        group = next((a for a in reversed(args) if isinstance(a, str)),
                     kwargs.get("group_name", "?"))
        self.stats.add(kind, tensor_bytes(args[0]),
                       self._axes.get(group, str(group)),
                       redistribution_cause() if self._explain else None)
