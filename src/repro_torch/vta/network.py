"""Network-level compilation + cycle accounting (end-to-end workloads, §IV.E-F).

``run_network`` accepts either a legacy ``list[Layer]`` (evaluated strictly
per layer, as before) or a ``Graph`` (vta/graph.py). Graphs go through the
graph compiler (vta/compiler.py): the network is partitioned into segments,
residual adds are fused into their producing convs, and producer→consumer
edges whose tensors fit on-chip never touch DRAM. Single-node segments take
the exact per-layer path — including the ``layer_cache`` fast path that the
DSE engine leans on — so the fallback is byte-for-byte the old pipeline.

For every multi-node segment the report also evaluates the members'
*unfused* baselines (through the same cache), which yields per-segment
``dram_bytes_saved`` and baseline cycles — the numbers behind the paper-
style "graph-level lowering earns its bandwidth back" comparison.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Union

from repro_torch.core.stages import stage
from repro_torch.core.tps import Tiling, heuristic_conv_tiling
from repro_torch.vta.graph import Graph, Node
from repro_torch.vta.isa import VTAConfig
from repro_torch.vta.schedule_cache import (KnownScheduleFailure, add_key,
                                            alu_key, conv_key)
from repro_torch.vta.scheduler import (Schedule, schedule_add, schedule_conv,
                                       schedule_depthwise, schedule_pool)
from repro_torch.vta.tsim import run_tsim
from repro_torch.vta.workloads import Layer, pad_for_blocking


@dataclass
class LayerReport:
    name: str
    kind: str
    cycles: int = 0
    dram_bytes: int = 0
    macs: int = 0
    on_cpu: bool = False
    tiling: Optional[Tiling] = None
    counts: dict = field(default_factory=dict)
    util: dict = field(default_factory=dict)
    bytes_by_buffer: dict = field(default_factory=dict)
    segment: int = -1            # index into NetworkReport.segments
    fused: bool = False          # folded into the segment head's program
    chosen_tile: Optional[dict] = None   # autotuner's committed tile
    tuning_gain: int = 0         # cycles saved vs the heuristic tiling

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "cycles": self.cycles,
                "dram_bytes": self.dram_bytes, "macs": self.macs,
                "on_cpu": self.on_cpu, "segment": self.segment,
                "fused": self.fused, "chosen_tile": self.chosen_tile,
                "tuning_gain": self.tuning_gain}


@dataclass
class SegmentReport:
    index: int
    layers: list                 # member node names
    cycles: int = 0
    dram_bytes: int = 0
    baseline_cycles: int = 0     # sum of unfused member evaluations
    baseline_dram_bytes: int = 0
    dram_bytes_saved: int = 0    # baseline - actual (multi segments)
    onchip_bytes: int = 0        # bytes that moved scratchpad-to-scratchpad
    fused_adds: list = field(default_factory=list)
    resident_edges: list = field(default_factory=list)

    @property
    def multi(self) -> bool:
        return len(self.layers) > 1

    def to_dict(self) -> dict:
        return {"index": self.index, "layers": self.layers,
                "cycles": self.cycles, "dram_bytes": self.dram_bytes,
                "baseline_cycles": self.baseline_cycles,
                "baseline_dram_bytes": self.baseline_dram_bytes,
                "dram_bytes_saved": self.dram_bytes_saved,
                "onchip_bytes": self.onchip_bytes,
                "fused_adds": list(self.fused_adds),
                "resident_edges": list(self.resident_edges)}


@dataclass
class NetworkReport:
    name: str
    hw: VTAConfig
    layers: list = field(default_factory=list)
    segments: list = field(default_factory=list)

    @property
    def total_cycles(self) -> int:
        return sum(l.cycles for l in self.layers if not l.on_cpu)

    @property
    def total_dram_bytes(self) -> int:
        return sum(l.dram_bytes for l in self.layers if not l.on_cpu)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers if not l.on_cpu)

    @property
    def dram_bytes_saved(self) -> int:
        return sum(s.dram_bytes_saved for s in self.segments)

    @property
    def tuning_cycles_saved(self) -> int:
        return sum(l.tuning_gain for l in self.layers)

    @property
    def tuned_layers(self) -> int:
        return sum(1 for l in self.layers if l.chosen_tile is not None)

    def summary(self) -> dict:
        return {"network": self.name, "cycles": self.total_cycles,
                "dram_bytes": self.total_dram_bytes, "macs": self.total_macs,
                "macs_per_cycle": self.total_macs / max(1, self.total_cycles),
                "vta_layers": sum(1 for l in self.layers if not l.on_cpu),
                "cpu_layers": sum(1 for l in self.layers if l.on_cpu),
                "dram_bytes_saved": self.dram_bytes_saved,
                "n_segments": len(self.segments),
                "fused_segments": sum(1 for s in self.segments if s.multi),
                "tuned_layers": self.tuned_layers,
                "tuning_cycles_saved": self.tuning_cycles_saved}

    def per_layer(self) -> list[dict]:
        return [l.to_dict() for l in self.layers]

    def per_segment(self) -> list[dict]:
        return [s.to_dict() for s in self.segments]


def plan_layer_tiles(layer: Layer, hw: VTAConfig, tuner, *,
                     prefer_db: bool = True, dedup_loads: bool = False):
    """Autotuner plan for one layer, or None (untuned kind / no tuner).

    Kind gating lives in ``tuner.plan`` (autotune.TUNABLE_KINDS) — one
    source of truth for which layer kinds are searchable.
    """
    if tuner is None:
        return None
    wl = pad_for_blocking(layer.wl, hw)
    return tuner.plan(layer.kind, wl, hw, post_op=layer.post_op,
                      bias=layer.bias, prefer_db=prefer_db,
                      dedup_loads=dedup_loads)


def schedule_layer(layer: Layer, hw: VTAConfig, *, prefer_db: bool = True,
                   dedup_loads: bool = False,
                   tiling_fn=None, tuner=None,
                   plan=None) -> Optional[Schedule]:
    """Lower one layer. ``plan`` (a precomputed TuneResult from
    ``plan_layer_tiles``) takes precedence; else ``tuner`` computes one."""
    wl = pad_for_blocking(layer.wl, hw)
    if plan is None and tiling_fn is None:
        plan = plan_layer_tiles(layer, hw, tuner, prefer_db=prefer_db,
                                dedup_loads=dedup_loads)
    if layer.kind in ("conv", "dense"):
        tiling = tiling_fn(wl, hw) if tiling_fn is not None else None
        if tiling is None and plan is not None:
            tiling = plan.tile
        if tiling is None:
            tiling = heuristic_conv_tiling(wl, hw, prefer_db=prefer_db)
        return schedule_conv(wl, tiling, hw, post_op=layer.post_op,
                             dedup_loads=dedup_loads, bias=layer.bias)
    alu_tile = tuple(plan.tile) if plan is not None else None
    if layer.kind == "depthwise":
        return schedule_depthwise(wl, hw, post_op=layer.post_op,
                                  tile=alu_tile)
    if layer.kind in ("maxpool", "avgpool"):
        return schedule_pool(wl, hw, mode=layer.kind[:3], tile=alu_tile)
    if layer.kind == "add":
        return schedule_add(wl, hw)
    raise ValueError(layer.kind)


def layer_key(layer: Layer, hw: VTAConfig, *, prefer_db: bool = True,
              dedup_loads: bool = False, tuner=None):
    """Hashable identity of a (layer shape, schedule knobs, hw) evaluation.

    The layer *name* is excluded: repeated shapes inside a network (and across
    networks in one sweep) share one schedule + tsim run. The autotuner's
    ``tag`` (search-space knobs) joins the key — tuned and untuned
    evaluations of the same shape must never collide in a shared cache.

    The config enters as its two projections — ``hw.schedule_key()`` +
    ``hw.cost_key()`` — rather than the config object: together they
    cover every field (the projections partition VTAConfig, tested), and
    keeping them separate makes the staged sharing explicit: entries of
    cost-only variants differ in the cost half only, and the schedule
    half is exactly what the ScheduleStore keys programs on.
    """
    return (layer.kind, replace(layer.wl, name=""), layer.post_op, layer.bias,
            hw.schedule_key(), hw.cost_key(), prefer_db, dedup_loads,
            tuner.tag if tuner is not None else None)


def _layer_macs(layer: Layer) -> int:
    """Residual adds are ALU work, not MACs."""
    return 0 if layer.kind == "add" else layer.wl.macs


def _layer_build(layer: Layer, hw: VTAConfig, *, plan, prefer_db,
                 dedup_loads, validate):
    """(store key, build thunk) for one layer's schedule — the build
    identity the ScheduleStore shares across cost-only config variants.
    Reproduces ``schedule_layer``'s tile selection exactly."""
    wl = pad_for_blocking(layer.wl, hw)
    wl_id = replace(wl, name="")
    sk = hw.schedule_key()
    if layer.kind in ("conv", "dense"):
        tiling = plan.tile if plan is not None \
            else heuristic_conv_tiling(wl, hw, prefer_db=prefer_db)
        key = conv_key(wl_id, layer.post_op, layer.bias, dedup_loads, sk,
                       tiling, validate)
        build = lambda: schedule_conv(wl, tiling, hw, post_op=layer.post_op,
                                      dedup_loads=dedup_loads,
                                      bias=layer.bias)
    elif layer.kind == "depthwise":
        tile = tuple(plan.tile) if plan is not None else None
        key = alu_key("depthwise", wl_id, layer.post_op, sk, tile, validate)
        build = lambda: schedule_depthwise(wl, hw, post_op=layer.post_op,
                                           tile=tile)
    elif layer.kind in ("maxpool", "avgpool"):
        tile = tuple(plan.tile) if plan is not None else None
        key = alu_key(layer.kind, wl_id, layer.post_op, sk, tile, validate)
        build = lambda: schedule_pool(wl, hw, mode=layer.kind[:3], tile=tile)
    elif layer.kind == "add":
        key = add_key(wl_id, sk, validate)
        build = lambda: schedule_add(wl, hw)
    else:
        raise ValueError(layer.kind)
    return key, build


def _eval_single(layer: Layer, hw: VTAConfig, *, prefer_db, dedup_loads,
                 validate_encoding, tiling_fn, layer_cache,
                 tuner=None, schedules=None) -> tuple:
    """(cycles, dram_bytes, tiling, counts, util, bytes_by_buffer,
    tune_info), cached. ``tune_info`` is None on the untuned path, else
    {"chosen_tile", "tuning_gain"} from the autotuner's committed plan.

    With ``schedules`` (a vta/schedule_cache.ScheduleStore) the
    schedule+lower+encode work and the tsim structural pass are shared
    across configs that differ only in cost parameters; each variant
    replays its own cycle cost (bit-identical to the direct path).
    """
    key = None
    if layer_cache is not None and tiling_fn is None:
        key = layer_key(layer, hw, prefer_db=prefer_db,
                        dedup_loads=dedup_loads, tuner=tuner)
        hit = layer_cache.get(key)
        if hit is not None:
            return hit
    plan = None
    if tiling_fn is None and tuner is not None:
        plan = plan_layer_tiles(layer, hw, tuner, prefer_db=prefer_db,
                                dedup_loads=dedup_loads)
    tune_info = None
    if plan is not None:
        tune_info = {"chosen_tile": plan.tile_dict(),
                     "tuning_gain": plan.tuning_gain}
    if schedules is not None and tiling_fn is None:
        skey, build = _layer_build(layer, hw, plan=plan, prefer_db=prefer_db,
                                   dedup_loads=dedup_loads,
                                   validate=validate_encoding)
        try:
            ent = schedules.entry(skey, build, hw,
                                  validate=validate_encoding, persist=True)
        except KnownScheduleFailure:
            # regenerate the exact per-variant exception (its message may
            # embed this config's repr) — the rebuild throws early
            sched = build()
            if validate_encoding:
                sched.program.validate_encoding()
            raise RuntimeError(
                "cached schedule failure did not reproduce")   # pragma: no cover
        with stage("tsim_cost"):
            ts = ent.cost_model.cost(hw)
        val = (ts.total_cycles, ts.dram_bytes, ent.tiling, ts.counts,
               ts.utilization(), dict(ent.dram_bytes), tune_info)
    else:
        sched = schedule_layer(layer, hw, prefer_db=prefer_db,
                               dedup_loads=dedup_loads, tiling_fn=tiling_fn,
                               plan=plan)
        if validate_encoding:
            sched.program.validate_encoding()
        with stage("tsim_cost"):
            ts = run_tsim(sched.program, hw)
        val = (ts.total_cycles, ts.dram_bytes, sched.tiling, ts.counts,
               ts.utilization(), dict(sched.dram_bytes), tune_info)
    if key is not None:
        layer_cache[key] = val
    return val


def _segment_key(seg, hw: VTAConfig, prefer_db: bool, dedup_loads: bool,
                 tuner=None):
    """Segment identity for the cache: the plan is a deterministic function
    of member shapes + hw + knobs (including the autotuner's search knobs —
    tuned fused heads change the program), so member identities suffice.
    Segments with layer-less members (concat) are not cached."""
    if any(n.layer is None for n in seg.nodes):
        return None
    members = tuple((n.kind, replace(n.layer.wl, name=""), n.layer.post_op,
                     n.layer.bias) for n in seg.nodes)
    return ("seg", members, hw, prefer_db, dedup_loads,
            tuner.tag if tuner is not None else None)


def _as_segments(layers, hw: VTAConfig, *, prefer_db, dedup_loads, fusion,
                 residency, tiling_fn, tuner=None):
    """Normalize input (Graph or list[Layer]) to a list of Segments."""
    from repro_torch.vta.compiler import Segment, compile_graph
    if isinstance(layers, Graph):
        # graphs always go through the compiler: even with the optimizations
        # off it must lower concat nodes, which have no per-layer fallback
        opt = tiling_fn is None
        return compile_graph(layers, hw, prefer_db=prefer_db,
                             dedup_loads=dedup_loads,
                             fusion=fusion and opt,
                             residency=residency and opt,
                             tuner=tuner if opt else None)
    nodes = [Node(name=l.wl.name, kind=l.kind,
                  shape=(l.wl.b, l.wl.fo, l.wl.oh, l.wl.ow), layer=l)
             for l in layers]
    return [Segment(nodes=[n]) for n in nodes]


def run_network(name: str, layers: Union[Graph, list], hw: VTAConfig, *,
                prefer_db: bool = True, dedup_loads: bool = False,
                validate_encoding: bool = False,
                tiling_fn=None, layer_cache: Optional[dict] = None,
                fusion: bool = True, residency: bool = True,
                tuner=None, backend: Optional[str] = "torch",
                schedules=None) -> NetworkReport:
    """Compile + tsim a network. ``layers`` may be a Graph (graph compiler:
    fused segments, scratchpad residency) or a list of Layers (strict
    per-layer path). With ``layer_cache`` (any mutable mapping), identical
    layer shapes — and identical fused segments — reuse prior tsim results;
    repeat blocks dominate deep ResNets. ``tuner`` (vta/autotune.LayerTuner)
    replaces the heuristic tilings with tsim-searched ones per layer;
    ``backend`` (vta/backend.py registry name, the card's ``"torch"`` by
    default; ``None`` keeps the tuner's own) selects the execution
    backend its winner verification runs on — every backend is bit-exact
    by contract, so results are identical and only wall-clock changes.
    ``schedules`` (vta/schedule_cache.ScheduleStore) shares scheduled
    programs + tsim cost models across configs that agree on
    ``hw.schedule_key()`` — results stay bit-identical, cost-only config
    variants skip straight to costing."""
    if backend is not None and tuner is not None:
        tuner = tuner.with_backend(backend)
    report = NetworkReport(name=name, hw=hw)
    segments = _as_segments(layers, hw, prefer_db=prefer_db,
                            dedup_loads=dedup_loads, fusion=fusion,
                            residency=residency, tiling_fn=tiling_fn,
                            tuner=tuner)
    eval_kw = dict(prefer_db=prefer_db, dedup_loads=dedup_loads,
                   validate_encoding=validate_encoding, tiling_fn=tiling_fn,
                   layer_cache=layer_cache, tuner=tuner,
                   schedules=schedules)
    def emit_single(node, si):
        layer = node.layer
        sr = SegmentReport(index=si, layers=[layer.wl.name])
        lr = LayerReport(name=layer.wl.name, kind=node.kind,
                         macs=_layer_macs(layer), on_cpu=node.on_cpu,
                         segment=si)
        if not node.on_cpu:
            (lr.cycles, lr.dram_bytes, lr.tiling, lr.counts, lr.util,
             lr.bytes_by_buffer, tune_info) = _eval_single(layer, hw,
                                                           **eval_kw)
            if tune_info is not None:
                lr.chosen_tile = tune_info["chosen_tile"]
                lr.tuning_gain = tune_info["tuning_gain"]
            sr.cycles = sr.baseline_cycles = lr.cycles
            sr.dram_bytes = sr.baseline_dram_bytes = lr.dram_bytes
        report.layers.append(lr)
        report.segments.append(sr)

    for seg in segments:
        si = len(report.segments)
        if not seg.multi:
            emit_single(seg.nodes[0], si)
            continue

        # compiled segment: one program, tsim'd as a whole (cached)
        key = None
        if layer_cache is not None and tiling_fn is None:
            key = _segment_key(seg, hw, prefer_db, dedup_loads, tuner)
        hit = layer_cache.get(key) if key is not None else None
        if hit is not None:
            seg_cycles, seg_dram, counts, util, onchip = hit
        else:
            if validate_encoding:
                seg.program.validate_encoding()
            with stage("tsim_cost"):
                ts = run_tsim(seg.program, hw)
            seg_cycles, seg_dram = ts.total_cycles, ts.dram_bytes
            counts, util = ts.counts, ts.utilization()
            onchip = seg.dram_bytes.get("onchip", 0)
            if key is not None:
                layer_cache[key] = (seg_cycles, seg_dram, counts, util, onchip)
        baselines = [(seg_cycles, seg_dram) if n.layer is None
                     else _eval_single(n.layer, hw, **eval_kw)[:2]
                     for n in seg.nodes]
        base_cycles = sum(b[0] for b in baselines)
        base_dram = sum(b[1] for b in baselines)
        if seg_cycles > base_cycles or seg_dram > base_dram:
            # profitability check: the fused plan lost to the per-layer
            # baseline (e.g. the acc-halved tiling cost outweighs the fused
            # add) — demote to plain per-layer evaluation
            for node in seg.nodes:
                emit_single(node, len(report.segments))
            continue
        sr = SegmentReport(index=si, layers=seg.names,
                           fused_adds=list(seg.fused_adds),
                           resident_edges=list(seg.resident_edges),
                           cycles=seg_cycles, dram_bytes=seg_dram,
                           onchip_bytes=onchip,
                           baseline_cycles=base_cycles,
                           baseline_dram_bytes=base_dram,
                           dram_bytes_saved=base_dram - seg_dram)
        for mi, node in enumerate(seg.nodes):
            lr = LayerReport(name=node.name, kind=node.kind,
                             macs=0 if node.layer is None
                             else _layer_macs(node.layer), segment=si,
                             fused=mi > 0)
            if mi == 0:     # segment totals attributed to the head
                lr.cycles, lr.dram_bytes = seg_cycles, seg_dram
                lr.counts, lr.util = counts, util
                if seg.head_tune is not None:
                    lr.chosen_tile = seg.head_tune["chosen_tile"]
                    lr.tuning_gain = seg.head_tune["tuning_gain"]
            report.layers.append(lr)
        report.segments.append(sr)
    return report
