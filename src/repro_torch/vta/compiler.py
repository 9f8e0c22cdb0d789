"""Graph-level VTA compiler: segments, fusion and scratchpad residency.

The per-layer pipeline lowers one layer at a time with a mandatory
store→DRAM→load round trip between every pair of layers. This module treats
the *network graph* as the unit of optimization instead, the way the
TVM/VTA flow earns its memory bandwidth back (Moreau et al.,
arXiv:1807.04188; Chung & Abdelrahman, arXiv:2203.04015):

  * the graph is partitioned into **segments** — runs of consecutive nodes
    compiled into ONE Program, so the runtime's dependency tokens overlap
    load/compute/store *across layer boundaries*;
  * **residual-add fusion**: a conv whose only consumer is an ``add`` node
    absorbs it — the skip tensor tile is ACC-loaded next to the conv's
    resident output tile, ALU-ADDed and re-clipped. The add's separate DRAM
    pass (read conv-out + read skip + write out, on top of the conv's own
    store) collapses into one extra read, saving two full passes over the
    activation;
  * **inter-layer scratchpad residency**: when a producer's entire output
    fits in the INP scratchpad *in the layout its consumer's GEMM expects*
    (consumer is a 1×1/stride-1 conv or dense, BI == BO, batch-tile 1), the
    producer's stores spill on-chip (``StoreInsn.buffer = INP``) and the
    consumer emits no input loads at all. A liveness allocator hands out
    INP-scratchpad regions per edge and frees them once consumed, so chains
    longer than two hops ping-pong two regions.

Anything that does not fit falls back byte-for-byte to today's per-layer
path: a single-node ``Segment`` carries no program and is evaluated through
``run_network``'s cached ``schedule_layer`` route, unchanged.

Feasibility is decided by *attempting* to build the segment against the
scheduler's capacity asserts — the same checks a mis-sized runtime would
trip on real VTA — and falling back on failure, mirroring how the DSE
engine treats infeasible design points.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.tps import ConvWorkload, Tiling, tps_search
from repro_torch.vta.graph import Graph, Node
from repro_torch.vta.isa import VTAConfig
from repro_torch.vta.runtime import Program, UopAllocator, finalize
from repro_torch.vta.scheduler import (emit_concat_tasks, emit_conv_tasks,
                                 emit_depthwise_tasks, emit_pool_tasks,
                                 program_dram_bytes)
from repro_torch.vta.workloads import pad_for_blocking


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------
@dataclass
class Segment:
    """One compiled unit: either a fallback single node (``program is None``,
    evaluated through the classic per-layer path) or a fused/resident run of
    nodes lowered into one Program."""
    nodes: list                          # graph Nodes, topo order
    program: Optional[Program] = None
    n_ctx: int = 1
    fused_adds: tuple = ()               # add-node names folded into convs
    resident_edges: tuple = ()           # "producer->consumer" on-chip edges
    dram_bytes: dict = field(default_factory=dict)
    head_tune: Optional[dict] = None     # autotuned fused-head tile info

    @property
    def multi(self) -> bool:
        return self.program is not None

    @property
    def names(self) -> list:
        return [n.name for n in self.nodes]


class ResidencyAllocator:
    """Liveness-based first-fit allocator over the INP scratchpad (tiles).

    Regions are keyed by the producing node (one region per live graph
    edge); ``free`` releases a region once its consumer has issued. Regions
    are placed as high as possible so the low addresses stay free for the
    producer's own DRAM loads (which ``emit_conv_tasks`` models as a
    ``inp_reserve``-shrunk scratchpad).
    """

    def __init__(self, depth: int):
        self.depth = depth
        self.live: dict = {}             # key -> (base, size)

    def alloc(self, key: str, size: int) -> Optional[int]:
        spans = sorted((b, b + s) for b, s in self.live.values())
        best = None
        cur = 0
        for b, e in spans:
            if b - cur >= size:
                best = b - size          # highest slot inside this gap
            cur = max(cur, e)
        if self.depth - cur >= size:
            best = self.depth - size
        if best is None:
            return None
        self.live[key] = (best, size)
        return best

    def free(self, key: str) -> None:
        self.live.pop(key, None)

    def reserved_below(self) -> int:
        """Tiles unusable for bottom-up loads: everything above the lowest
        live region (the top slice the scheduler must keep clear)."""
        if not self.live:
            return 0
        return self.depth - min(b for b, _ in self.live.values())


# ---------------------------------------------------------------------------
# Tiling selection for segment members
# ---------------------------------------------------------------------------
def _divisors(n: int) -> list:
    return [d for d in range(1, n + 1) if n % d == 0]


def _is_pointwise(wl: ConvWorkload) -> bool:
    return (wl.kh == wl.kw == 1 and wl.sh == wl.sw == 1
            and wl.ph == wl.pw == 0 and not wl.depthwise)


def _untiled_tiling(wl: ConvWorkload, hw: VTAConfig, *, inp_reserve: int,
                    fused: bool, bias: bool) -> Optional[Tiling]:
    """Spatially-untiled single-context tiling (resident producers): the
    whole output is computed in th=oh, tw=ow rows so stores can spill
    on-chip in the consumer's layout. Smallest (tco_o, tci_o) that fits
    minimizes input re-reads."""
    BI, BO, BV = hw.block_in, hw.block_out, hw.batch
    if wl.b // BV != 1:
        return None
    di, do = wl.fi // BI, wl.fo // BO
    ih = (wl.oh - 1) * wl.sh + wl.kh
    iw = (wl.ow - 1) * wl.sw + wl.kw
    for tco_o in _divisors(do):
        tco_i = do // tco_o
        n_acc = tco_i * wl.oh * wl.ow
        per = n_acc * (2 if fused else 1) + (tco_i if bias else 0)
        if per > hw.acc_depth:
            continue
        for tci_o in _divisors(di):
            tci_i = di // tci_o
            if tci_i * ih * iw > hw.inp_depth - inp_reserve:
                continue
            if tco_i * tci_i * wl.kh * wl.kw > hw.wgt_depth:
                continue
            return Tiling(1, 1, 1, tco_o, tci_o)
    return None


def _consumer_tiling(wl: ConvWorkload, hw: VTAConfig, *, fused: bool,
                     bias: bool) -> Optional[Tiling]:
    """Tiling for a consumer whose whole input is resident (1×1/s1): one
    input region (tci_o=1), untiled spatial, output channels split until
    weights + acc fit."""
    BI, BO, BV = hw.block_in, hw.block_out, hw.batch
    if wl.b // BV != 1 or not _is_pointwise(wl):
        return None
    di, do = wl.fi // BI, wl.fo // BO
    for tco_o in _divisors(do):
        tco_i = do // tco_o
        n_acc = tco_i * wl.oh * wl.ow
        per = n_acc * (2 if fused else 1) + (tco_i if bias else 0)
        if tco_i * di <= hw.wgt_depth and per <= hw.acc_depth:
            return Tiling(1, 1, 1, tco_o, 1)
    return None


def _fused_tiling(wl: ConvWorkload, hw: VTAConfig, *,
                  prefer_db: bool) -> Optional[Tiling]:
    """TPS tiling for a conv that must co-host the skip tile in acc: search
    against a half-size acc scratchpad so the doubled footprint fits."""
    shrunk = dataclasses.replace(hw, log_acc_buff=hw.log_acc_buff - 1)
    res = tps_search(wl, shrunk, require_db=True) if prefer_db else None
    if res is None or not res.feasible:
        res = tps_search(wl, shrunk)
    return res.tiling if res.feasible else None


# ---------------------------------------------------------------------------
# Segment construction
# ---------------------------------------------------------------------------
def _build_segment(chain: list, fused_add: Optional[Node], graph: Graph,
                   hw: VTAConfig, *, prefer_db: bool,
                   dedup_loads: bool, tuner=None) -> Segment:
    """Lower a chain (+ optional trailing fused add) into one Program.

    Raises AssertionError when any member does not fit — the caller treats
    that as an infeasible plan and falls back. With a ``tuner``
    (vta/autotune.LayerTuner), a fusion-only head's tiling is searched with
    tsim on the actual fused program instead of taking ``_fused_tiling``'s
    analytic answer; the analytic answer stays in the candidate set, so the
    tuned segment is never slower than the untuned one.
    """
    alloc = UopAllocator(hw)
    tasks: list = []
    liveness = ResidencyAllocator(hw.inp_depth)
    bases: dict = {}                 # producer node name -> resident base
    resident: list = []
    head_tune: Optional[dict] = None
    n_ctx = 1
    for i, node in enumerate(chain):
        layer = node.layer
        wl = pad_for_blocking(layer.wl, hw)
        last = i == len(chain) - 1
        fuse = fused_add if last else None
        skip_name = None
        if fuse is not None:
            others = [s for s in fuse.inputs if s != node.name]
            assert len(others) == 1, "fused add needs exactly one skip input"
            skip_name = others[0]
        tensors = {"inp": node.inputs[0], "wgt": f"{node.name}.wgt",
                   "bias": f"{node.name}.bias",
                   "out": fuse.name if fuse is not None else node.name}
        res_in = bases.get(node.inputs[0])
        res_out = None
        if not last:
            nxt = chain[i + 1]
            nwl = pad_for_blocking(nxt.layer.wl, hw)
            n_res = (nwl.fi // hw.block_in) * nwl.h * nwl.w
            res_out = liveness.alloc(node.name, n_res)
            assert res_out is not None, "no resident scratchpad space"
            bases[node.name] = res_out
            resident.append(f"{node.name}->{nxt.name}")
        reserve = liveness.reserved_below()

        if node.kind in ("conv", "dense"):
            if res_in is not None:
                t = _consumer_tiling(wl, hw, fused=fuse is not None,
                                     bias=layer.bias)
            elif res_out is not None:
                t = _untiled_tiling(wl, hw, inp_reserve=reserve,
                                    fused=fuse is not None, bias=layer.bias)
            else:               # fusion-only segment head
                t = None
                if fuse is not None:
                    if tuner is not None:
                        plan = tuner.tune_fused_conv(
                            wl, hw, post_op=layer.post_op, bias=layer.bias,
                            prefer_db=prefer_db, dedup_loads=dedup_loads,
                            skip_name=skip_name, tensors=tensors)
                        if plan is not None:
                            t = plan.tile
                            head_tune = {"chosen_tile": plan.tile_dict(),
                                         "tuning_gain": plan.tuning_gain}
                    if t is None:
                        t = _fused_tiling(wl, hw, prefer_db=prefer_db)
                if t is None and fuse is None:
                    res = tps_search(wl, hw, require_db=True) if prefer_db \
                        else None
                    if res is None or not res.feasible:
                        res = tps_search(wl, hw)
                    t = res.tiling if res.feasible else None
            assert t is not None, f"no feasible tiling for {wl.name}"
            nc = emit_conv_tasks(
                wl, t, hw, alloc, tasks, post_op=layer.post_op,
                dedup_loads=dedup_loads and res_in is None and res_out is None,
                bias=layer.bias, tensors=tensors,
                fuse_add=skip_name,
                inp_reserve=0 if res_in is not None else reserve,
                resident_in=res_in, resident_out=res_out)
            n_ctx = max(n_ctx, nc if len(chain) == 1 else 1)
            assert len(chain) == 1 or nc == 1, \
                "resident chains are single-context"
        elif node.kind == "depthwise":
            assert fuse is None, "fused add rides the GEMM path only"
            emit_depthwise_tasks(wl, hw, alloc, tasks, post_op=layer.post_op,
                                 tensors=tensors, resident_out=res_out)
        elif node.kind in ("maxpool", "avgpool"):
            assert fuse is None, "fused add rides the GEMM path only"
            emit_pool_tasks(wl, hw, alloc, tasks, mode=node.kind[:3],
                            tensors=tensors, resident_out=res_out)
        else:
            raise AssertionError(f"{node.kind} cannot join a segment")

        if res_in is not None:
            liveness.free(node.inputs[0])

    prog = finalize(tasks, hw, n_ctx=n_ctx)
    prog.uop_mem = alloc.mem
    # whole-segment fusion marker: the compiler guarantees this program is
    # one self-contained layer pipeline (conv -> fused add -> clip, resident
    # spill chains), so the JAX backend may execute its entire trace as a
    # single kernel launch (fsim_jax segment fusion)
    prog.fused_segment = True
    nodes = list(chain) + ([fused_add] if fused_add is not None else [])
    return Segment(nodes=nodes, program=prog, n_ctx=n_ctx,
                   fused_adds=(fused_add.name,) if fused_add is not None else (),
                   resident_edges=tuple(resident),
                   dram_bytes=program_dram_bytes(prog, hw),
                   head_tune=head_tune)


def _build_concat(node: Node, graph: Graph, hw: VTAConfig) -> Segment:
    """Concat = pure DMA: copy every source at its channel offset. Channel
    counts must be BO-multiples (offsets cannot be re-padded)."""
    alloc = UopAllocator(hw)
    tasks: list = []
    shapes = [graph.nodes[s].shape for s in node.inputs]
    emit_concat_tasks(shapes, hw, alloc, tasks, tensors=list(node.inputs),
                      out_tensor=node.name, n_ctx=2)
    n_ctx = max((t.ctx for t in tasks), default=0) + 1
    prog = finalize(tasks, hw, n_ctx=n_ctx)
    prog.uop_mem = alloc.mem
    return Segment(nodes=[node], program=prog,
                   dram_bytes=program_dram_bytes(prog, hw))


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------
def _resident_next(graph: Graph, consumers: dict, comp: list, j: int,
                   hw: VTAConfig) -> Optional[Node]:
    """The next compute node, iff producer comp[j] can keep its output
    resident for it (see module docstring for the rule)."""
    p = comp[j]
    if p.on_cpu or p.kind not in ("conv", "dense", "depthwise",
                                  "maxpool", "avgpool"):
        return None
    cons = consumers[p.name]
    if len(cons) != 1 or j + 1 >= len(comp) or comp[j + 1].name != cons[0]:
        return None
    c = comp[j + 1]
    if c.on_cpu or c.kind not in ("conv", "dense") or c.layer is None:
        return None
    cwl = pad_for_blocking(c.layer.wl, hw)
    pwl = pad_for_blocking(p.layer.wl, hw)
    if not _is_pointwise(cwl):
        return None
    if cwl.b // hw.batch != 1 or pwl.b // hw.batch != 1:
        return None
    if pwl.fo != cwl.fi or (pwl.oh, pwl.ow) != (cwl.h, cwl.w):
        return None
    n_res = (cwl.fi // hw.block_in) * cwl.h * cwl.w
    if n_res > hw.inp_depth:
        return None
    return c


# post-ops that leave the acc tile narrowed to int8 range — the fused ADD
# must see exactly the value the unfused path would have round-tripped
# through DRAM (the store clamps to [-128, 127]); an unbounded epilogue
# (relu/relu_shift/none) would make the fused program diverge bit-wise
_NARROWING_POST_OPS = ("clip_shift", "clip_shift_legacy", "clip")


def _fused_next(consumers: dict, comp: list, j: int) -> Optional[Node]:
    """The next compute node, iff it is an add consuming only comp[j]."""
    last = comp[j]
    if last.kind not in ("conv", "dense") or last.on_cpu:
        return None
    if last.layer is None or last.layer.post_op not in _NARROWING_POST_OPS:
        return None
    cons = consumers[last.name]
    if len(cons) != 1 or j + 1 >= len(comp) or comp[j + 1].name != cons[0]:
        return None
    c = comp[j + 1]
    if c.kind != "add" or c.on_cpu:
        return None
    return c


def compile_graph(graph: Graph, hw: VTAConfig, *, prefer_db: bool = True,
                  dedup_loads: bool = False, fusion: bool = True,
                  residency: bool = True, tuner=None) -> list:
    """Partition ``graph`` into Segments (topo order). Nodes that join no
    feasible fused/resident plan become single-node fallback segments —
    byte-for-byte today's per-layer path. ``tuner`` tsim-searches fused-head
    tilings (see ``_build_segment``); single-node fallbacks are tuned later,
    on the per-layer path in ``run_network``."""
    graph.validate()
    consumers = graph.consumers()
    comp = graph.compute_nodes()
    bi_eq = hw.block_in == hw.block_out
    segments: list = []
    i = 0
    while i < len(comp):
        node = comp[i]
        if node.kind == "concat":
            segments.append(_build_concat(node, graph, hw))
            i += 1
            continue
        if node.on_cpu or node.kind == "add":
            segments.append(Segment(nodes=[node]))
            i += 1
            continue
        chain = [node]
        j = i
        while residency and bi_eq:
            nxt = _resident_next(graph, consumers, comp, j, hw)
            if nxt is None:
                break
            chain.append(nxt)
            j += 1
        fused = _fused_next(consumers, comp, j) if fusion else None
        if len(chain) == 1 and fused is None:
            segments.append(Segment(nodes=[node]))
            i += 1
            continue
        attempts = [(chain, fused)]
        if fused is not None:
            attempts.append((chain, None))
        seg = None
        for cand_chain, cand_fused in attempts:
            try:
                seg = _build_segment(cand_chain, cand_fused, graph, hw,
                                     prefer_db=prefer_db,
                                     dedup_loads=dedup_loads, tuner=tuner)
                break
            except AssertionError:
                seg = None
        if seg is None:
            segments.append(Segment(nodes=[node]))
            i += 1
        else:
            segments.append(seg)
            i += len(seg.nodes)
    return segments
