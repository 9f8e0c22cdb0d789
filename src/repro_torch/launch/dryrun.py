"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on a fake
256- or 512-rank mesh; the port of ``repro/launch/dryrun.py``.

For each cell, on the fake process group (one process, rank 0 of 256 or
512, collectives that return at once) and the production mesh, the params,
optimizer state and inputs are meta DTensors placed by the logical rules
(no memory), and the step runs once under ``DeviceCost``, a dispatch mode
below DTensor that sees each op on rank 0's local shards. It prints/dumps,
all per device and from local shapes:

  * ``flops_per_device``: the flop formulas of ``torch.utils.flop_counter``
    (and of the attention ops) on the local shapes; an op on replicated
    tensors counts whole, a sharded one its shard;
  * ``hbm_bytes_per_device``: local operand and result bytes of every
    dispatched op that is not a view: the eager program's traffic, larger
    than XLA's count for the reference, which fuses element-wise chains;
  * ``collectives``: operand bytes of every functional collective DTensor
    issues (``analysis/collectives.py``), by kind and by mesh axis;
  * ``memory``: arguments, outputs, outputs that are arguments' storage
    (``alias``), and ``temp``, the peak of local bytes allocated during
    the step and alive at once (tracked per storage: each op's new storage
    adds its bytes, and a ``weakref.finalize`` on its tensors takes them
    off when the last one dies), less the fresh outputs.
    ``peak_est_bytes`` = arguments + outputs + temp - alias, the
    reference's formula: arguments plus the peak of live allocations.

The port loops over groups and microbatches in Python, so its counts cover
every layer and every microbatch already: ``analysis/roofline.py`` applies
no depth extrapolation and no ``x grad_accum``. ``--depth d1|d2`` stays
only to cut a cell's time. ``--save-hlo`` has no counterpart (there is no
compiled module). ``lower_s`` is the time to build the abstract arguments,
``compile_s`` the step's wall time. An op DTensor has no rule for ends the
cell with ``"error"`` naming it, as the reference's sweep records a failed
cell.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      [--multi-pod] [--depth full|d1|d2] [--out out.json] [--set k=v] \\
      [--explain-collectives]
  python -m repro_torch.launch.dryrun --list-cells
"""
import argparse
import json
import math
import sys
import time
import traceback
import weakref

import torch
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro_torch.analysis.collectives import (CollectiveCounter,
                                              collective_kind, tensor_bytes)

EXPLAIN_TOP = 16      # causes printed with --explain-collectives
# ops that move no data of their own
NO_TRAFFIC = ("aten::detach", "aten::empty", "aten::empty_strided",
              "aten::empty_like", "aten::new_empty", "aten::lift_fresh",
              "aten::alias")


def runnable_cells() -> list[tuple[str, str]]:
    """The assigned (arch x shape) grid, with the long_500k skip rule."""
    from repro_torch.configs import ARCHS, SHAPES
    cells = []
    for arch, cfg in ARCHS.items():
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.long_context_capable:
                continue   # pure full-attention archs skip (DESIGN.md §4)
            cells.append((arch, shape))
    return cells


def parse_overrides(pairs: list[str]) -> dict:
    """--set key=value config overrides (int/float/bool/str inferred)."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in ("true", "True", "false", "False"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def build_cell(arch: str, shape_name: str, depth: str, overrides=None):
    from repro_torch.configs import ARCHS, SHAPES
    cfg = ARCHS[arch]
    if overrides:
        cfg = cfg.replace(**overrides)
    if depth != "full":
        k = {"d1": 1, "d2": 2}[depth]
        cfg = cfg.replace(n_layers=len(cfg.pattern) * k, unroll_layers=True)
    return cfg, SHAPES[shape_name]


def local_tensors(tree) -> list:
    """The rank's local tensors of the tensors in ``tree`` (a DTensor's
    shard, a plain tensor itself)."""
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    from torch.multiprocessing.reductions import StorageWeakRef
    return StorageWeakRef(t.untyped_storage()).cdata


def _is_fake(tree) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in pytree_leaves(tree))


class DeviceCost(CollectiveCounter):
    """Per-device flops, HBM bytes, collectives and live local bytes of the
    ops dispatched in the block (the module docstring). ``arguments``: the
    step's arguments, whose storages are not allocations of the step. Ops
    DTensor runs on fake tensors to propagate shapes are not counted."""

    def __init__(self, mesh, arguments, explain: bool = False):
        super().__init__(mesh, explain)
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}
        self._arg_keys = {_storage_key(t) for t in local_tensors(arguments)}

    def on_local_op(self, func, args, kwargs, out) -> None:
        if _is_fake((args, kwargs, out)):
            return
        if collective_kind(func) is not None:
            super().on_local_op(func, args, kwargs, out)
        else:
            f = self._flops_of.get(func._overloadpacket)
            if f is not None:
                self.flops += f(*args, **kwargs, out_val=out)
            if not func.is_view and func._schema.name not in NO_TRAFFIC:
                self.hbm_bytes += sum(
                    tensor_bytes(t) for t in pytree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._arg_keys:
            return
        ref = self._refs.get(key)
        if ref is None:
            ref = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += ref[1]
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._refs[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def alias_bytes(self, outputs) -> int:
        return sum(tensor_bytes(t) for t in local_tensors(outputs)
                   if _storage_key(t) in self._arg_keys)


def error_text(e: BaseException) -> str:
    """``e`` as a cell's ``"error"``: its type and message, which for a
    sharding failure names the op, and the innermost line of the port's own
    code it passed through, which names the op otherwise."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if "repro_torch" in f.filename]
    where = ""
    if frames:
        f = frames[-1]
        where = (f" [at {f.filename.split('repro_torch')[-1].lstrip('/')}:"
                 f"{f.lineno} {f.line}]")
    return (f"{type(e).__name__}: {e}"[:1600] + where)[:2000]


def mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             depth: str = "full", verbose: bool = True,
             overrides: dict | None = None,
             rule_overrides: dict | None = None,
             explain: bool = False) -> dict:
    """One cell on a fake process group of the production mesh's size
    (started here unless one is running), its numbers per device (the
    module docstring). ``overrides``: config fields; ``rule_overrides``:
    entries of the logical rule table (SPS's candidates); ``explain``:
    the collectives by cause too (``collectives.by_cause``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (PRODUCTION_SHAPES,
                                         destroy_process_group,
                                         init_process_group,
                                         make_production_mesh)
    from repro_torch.launch.specs import input_specs
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.logical import LogicalRules, use_rules
    from repro_torch.serve.session import make_decode_step, make_prefill_step
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (abstract_opt_state, abstract_params,
                                        make_train_step)

    cfg, shape = build_cell(arch, shape_name, depth, overrides)
    mesh_shape = PRODUCTION_SHAPES[multi_pod][0]
    n_chips = math.prod(mesh_shape)
    started = not dist.is_initialized()
    if started:
        init_process_group("fake", n_chips)
    result = {
        "arch": arch, "shape": shape_name, "depth": depth,
        "mesh": mesh_name(mesh_shape), "chips": n_chips,
        "n_groups": cfg.n_groups, "n_layers": cfg.n_layers,
        "pattern": list(cfg.pattern),
    }
    try:
        # a fake group's ranks hold meta tensors only: no card is needed
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = LogicalRules(mesh)
        rules.rules.update(rule_overrides or {})
        t0 = time.time()
        with use_rules(rules):
            model = build_model(cfg)
            specs = input_specs(model, shape_name, rules)
            params = abstract_params(model, rules)
            if shape.kind == "train":
                step = make_train_step(model, AdamWConfig())
                args = (params, abstract_opt_state(model, rules),
                        specs["batch"])
            elif shape.kind == "prefill":
                step = make_prefill_step(model)
                args = (params, specs["batch"])
            else:
                step = make_decode_step(model)
                args = (params, specs["batch"], specs["caches"],
                        specs["pos"])
            t_lower = time.time() - t0
            # before the step: a decode step replaces its recurrent states
            # in the caches it was given (``Model.decode``)
            arg_b = sum(tensor_bytes(t) for t in local_tensors(args))
            cost = DeviceCost(mesh, args, explain)
            try:
                with cost, torch.set_grad_enabled(shape.kind == "train"):
                    out = step(*args)
            except Exception as e:   # an op without a rule: data, as in sweep
                result["error"] = error_text(e)
                if verbose:
                    print(f"[dryrun] {arch} x {shape_name} "
                          f"({result['mesh']}, {depth}): FAILED "
                          f"{result['error'][:400]}")
                return result
            t_step = time.time() - t0 - t_lower
    finally:
        if started:
            destroy_process_group()

    out_b = sum(tensor_bytes(t) for t in local_tensors(out))
    alias_b = cost.alias_bytes(out)
    temp_b = max(0, cost.peak - (out_b - alias_b))
    colls = cost.stats
    result.update({
        "flops_per_device": float(cost.flops),
        "hbm_bytes_per_device": float(cost.hbm_bytes),
        "collectives": colls.to_dict(),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "peak_est_bytes": arg_b + out_b + temp_b - alias_b,
        },
        "lower_s": round(t_lower, 2), "compile_s": round(t_step, 2),
    })
    if verbose:
        gib = 2 ** 30
        print(f"[dryrun] {arch} x {shape_name} ({result['mesh']}, {depth}): "
              f"STEP OK in {t_step:.1f}s")
        print(f"  memory: args={arg_b/gib:.2f}GiB out={out_b/gib:.2f}GiB "
              f"temp={temp_b/gib:.2f}GiB alias={alias_b/gib:.2f}GiB")
        print(f"  cost: flops/dev={result['flops_per_device']:.3e} "
              f"bytes/dev={result['hbm_bytes_per_device']:.3e}")
        print(f"  collectives: {colls.total_count} ops, "
              f"{colls.total_bytes/2**20:.1f} MiB/dev "
              f"{colls.bytes_by_kind} by axis {colls.bytes_by_axis}")
        for row in result["collectives"].get("by_cause", [])[:EXPLAIN_TOP]:
            print(f"    {row['bytes']:.4e} B {row['count']:5d}x "
                  f"{row['kind']} on {row['axis']}: {row['cause']}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--depth", default="full", choices=("full", "d1", "d2"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--list-cells", action="store_true")
    ap.add_argument("--explain-collectives", action="store_true",
                    help="file each collective under the op and the "
                         "redistribution that caused it")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (repeatable)")
    args = ap.parse_args(argv)

    if args.list_cells:
        for a, s in runnable_cells():
            print(f"{a} {s}")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required")
    res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   depth=args.depth,
                   overrides=parse_overrides(args.overrides),
                   explain=args.explain_collectives)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return 1 if "error" in res else 0


if __name__ == "__main__":
    sys.exit(main())
