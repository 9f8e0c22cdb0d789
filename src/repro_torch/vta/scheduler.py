"""Lower DNN layers to VTA instruction streams using TPS tilings (paper §IV.D).

Layout conventions (match the TPS cost model):
  activations  (B, FI, H, W)  int8, blocked (BV, BI) tiles
  weights      (FO, FI, KH, KW) int8, blocked (BO, BI) tiles
  acc/output   (B, FO, OH, OW) int32 -> int8 on store

Scratchpad-local indexing inside one task (== what the uops encode):
  inp tile idx = ((b_i*tci_i + ci)*ih_i + y)*iw_i + x
  wgt tile idx = ((co_i*tci_i + ci)*kh + dy)*kw + dx
  acc tile idx = ((b_i*tco_i + co_i)*th_i + row)*tw_i + col

Virtual threading (double buffering): with oc_n=2 the tco_o loop is split
across 2 contexts, each owning half of every scratchpad; with h_n=2 the th_o
loop is split. `dedup_loads=True` enables the paper's §IV.D.2 redundant-load
elimination: the operand shared between the two contexts (input when oc_n=2,
weights when h_n=2) is loaded once into ctx0's half and ctx1's uops read it
there — turning the access pattern (I1,W1),(I2,W2),(I1,W1),(I2,W2) into
(I1,W1),(I1,W2),(I2,W1),(I2,W2).

ALU-lowered layers (depthwise / pool / add) use *vectorized macro-ops*: the
whole per-tile tap sequence is batched into one or two multi-uop AluInsns
(overwrite-seeded MAC sweeps for depthwise; an overwrite copy + one MAX/ADD
sweep for pool), the per-tile uop chunks dedup through the UopAllocator so
repeated tiles re-load nothing, and the same virtual-thread treatment conv
has (n_ctx=2, alternating acc halves, patch loads streamed through the LD
engine) lets the memory engine fill tile i+1 while the ALU chews tile i.
Each emitter keeps its pre-macro-op lowering behind ``vectorize=False`` as
the single-uop comparison baseline.

Graph-compiler hooks (vta/compiler.py): every ``schedule_*`` is a thin
wrapper over an ``emit_*_tasks`` function that appends Tasks to a caller-
owned list against a caller-owned UopAllocator, so multiple layers can share
one Program (fused segments). The extra knobs:

  * ``fuse_add=<tensor>``   fold a residual-add consumer into the conv: the
                            skip tensor tile is ACC-loaded next to the conv's
                            resident output tile, ALU-ADDed and re-clipped —
                            no separate DRAM pass over the activation;
  * ``resident_out=<base>`` stores spill on-chip into the INP scratchpad at
                            ``base`` (StoreInsn.buffer = INP) in the layout
                            the consumer's GEMM expects;
  * ``resident_in=<base>``  the whole input is already resident at ``base``:
                            no INP loads are emitted, uops index the region;
  * ``inp_reserve=<tiles>`` top slice of the INP scratchpad kept out of this
                            layer's own load space (it holds a resident
                            tensor for the segment);
  * ``tensors={role: name}`` DRAM tensor names stamped into load/store metas
                            so fsim can run multi-tensor segment programs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.tps import ConvWorkload, Tiling
from repro_torch.vta.isa import (PAD_BITS, AluInsn, AluOp, Buffer, GemmInsn,
                           LoadInsn, Op, StoreInsn, Uop, VTAConfig)
from repro_torch.vta.lowering import insn_dram_bytes as insn_dram_bytes
from repro_torch.vta.runtime import Program, Task, UopAllocator, finalize

INT8_MIN = -128


@dataclass
class Schedule:
    program: Program
    tiling: Tiling
    wl: ConvWorkload
    uop_flushes: int = 0
    dram_bytes: dict = field(default_factory=dict)


def _ceil_div(a, b):
    return -(-a // b)


def _n_ctx_of(tasks: list) -> int:
    """Effective context count of an emitted task list (emitters downgrade
    a requested n_ctx=2 when even a minimal tile cannot split)."""
    return max((t.ctx for t in tasks), default=0) + 1


def _shrink_tile(oh: int, ow: int, need, budget: int):
    """Halve a (th, tw) spatial tile (rows first, then width — the
    emit_depthwise fallback, shared by every ALU-lowered emitter) until
    ``need(th, tw) <= budget``; None when even 1x1 does not fit."""
    th, tw = oh, ow
    while need(th, tw) > budget and th > 1:
        th = _ceil_div(th, 2)
    while need(th, tw) > budget and tw > 1:
        tw = _ceil_div(tw, 2)
    return (th, tw) if need(th, tw) <= budget else None


def _finish_schedule(wl: ConvWorkload, t: Tiling, hw: VTAConfig,
                     alloc: UopAllocator, tasks: list, n_ctx: int) -> Schedule:
    """Shared wrapper epilogue: finalize tasks into a standalone Schedule."""
    prog = finalize(tasks, hw, n_ctx=n_ctx)
    prog.uop_mem = alloc.mem
    sched = Schedule(program=prog, tiling=t, wl=wl, uop_flushes=alloc.flushes)
    sched.dram_bytes = program_dram_bytes(prog, hw)
    return sched


# ---------------------------------------------------------------------------
# Convolution (and dense = 1x1x1 conv)
# ---------------------------------------------------------------------------
def emit_conv_tasks(wl: ConvWorkload, t: Tiling, hw: VTAConfig,
                    alloc: UopAllocator, tasks: list, *,
                    post_op: str = "clip_shift", dedup_loads: bool = False,
                    bias: bool = False, tensors: Optional[dict] = None,
                    fuse_add: Optional[str] = None,
                    inp_reserve: int = 0,
                    resident_in: Optional[int] = None,
                    resident_out: Optional[int] = None) -> int:
    """Append this conv's Tasks to ``tasks``; returns its n_ctx."""
    BV, BI, BO = hw.batch, hw.block_in, hw.block_out
    assert wl.b % BV == 0 and wl.fo % BO == 0 and wl.fi % BI == 0, (wl, hw)
    di, do, bo_ct = wl.fi // BI, wl.fo // BO, wl.b // BV
    oh, ow = wl.oh, wl.ow
    tname = (tensors or {}).get
    # inner extents
    tb_i = bo_ct // t.tb_o
    th_i = oh // t.th_o
    tw_i = ow // t.tw_o
    tco_i = do // t.tco_o
    tci_i = di // t.tci_o
    ih_i = (th_i - 1) * wl.sh + wl.kh
    iw_i = (tw_i - 1) * wl.sw + wl.kw

    n_ctx = 2 if t.double_buffered else 1
    inp_half = (hw.inp_depth - inp_reserve) // n_ctx
    wgt_half = hw.wgt_depth // n_ctx
    acc_half = hw.acc_depth // n_ctx
    n_inp = tb_i * tci_i * ih_i * iw_i
    n_wgt = tco_i * tci_i * wl.kh * wl.kw
    n_acc = tb_i * tco_i * th_i * tw_i
    # per-sub acc footprint: out tile + optional bias row + resident skip tile
    acc_per_sub = n_acc + (tb_i * tco_i if bias else 0) \
        + (n_acc if fuse_add is not None else 0)
    if resident_in is not None:
        # whole input resident: single untiled inp region, no halving games
        assert t.tb_o == t.th_o == t.tw_o == t.tci_o == 1 and n_ctx == 1, \
            "resident input requires an untiled, single-context consumer"
        assert wl.kh == wl.kw == 1 and wl.sh == wl.sw == 1 \
            and wl.ph == wl.pw == 0, "resident input consumer must be 1x1/s1"
    else:
        assert n_inp <= inp_half, f"inp tiles {n_inp} > half depth {inp_half}"
    assert n_wgt <= wgt_half, f"wgt tiles {n_wgt} > half depth {wgt_half}"
    assert acc_per_sub <= acc_half, \
        f"acc tiles {acc_per_sub} > half depth {acc_half}"
    if resident_out is not None:
        assert t.tb_o == t.th_o == t.tw_o == 1 and tb_i == 1 and n_ctx == 1, \
            "resident output requires untiled spatial, batch 1, 1 context"

    # gemm uop sequence for one (task, reduction step); offsets select halves
    def gemm_uops(inp_base: int, wgt_base: int, acc_base: int) -> tuple:
        seq = []
        for b_i in range(tb_i):
            for co_i in range(tco_i):
                for ci in range(tci_i):
                    for dy in range(wl.kh):
                        for dx in range(wl.kw):
                            acc = acc_base + (b_i * tco_i + co_i) * th_i * tw_i
                            inp = inp_base + ((b_i * tci_i + ci) * ih_i + dy) * iw_i + dx
                            wgt = wgt_base + ((co_i * tci_i + ci) * wl.kh + dy) * wl.kw + dx
                            seq.append(Uop(acc, inp, wgt))
        return tuple(seq)

    def acc_uops(acc_base: int, src_base: Optional[int] = None,
                 src_stride: int = 1) -> tuple:
        seq = []
        for b_i in range(tb_i):
            for co_i in range(tco_i):
                a = acc_base + (b_i * tco_i + co_i) * th_i * tw_i
                s = a if src_base is None else \
                    src_base + (b_i * tco_i + co_i) * src_stride
                seq.append(Uop(a, s, 0))
        return tuple(seq)

    def emit_compute(task: Task, seq: tuple, make):
        """Place uops (split on buffer capacity) and emit compute insns."""
        cap = max(1, hw.uop_depth)
        for s0 in range(0, len(seq), cap):
            chunk = seq[s0:s0 + cap]
            bgn, ld = alloc.place(chunk)
            if ld is not None:
                task.computes.append(ld)
            task.computes.append(make(bgn, bgn + len(chunk)))

    # ------------------------------------------------------------------
    # Outer iteration -> "units". Normally a unit is one (bo,ho,wo,coo)
    # sub-iteration; with dedup_loads the two sub-iterations that share an
    # operand (coo pair for oc_n=2, ho pair for h_n=2) are merged into one
    # unit whose shared operand is loaded once (the paper's reordered
    # access pattern (I1,W1),(I1,W2),(I2,W1),(I2,W2)). Units alternate
    # scratchpad halves (ctx = unit index % n_ctx) for double buffering.
    # ------------------------------------------------------------------
    outer: list[tuple] = []
    for bo in range(t.tb_o):
        for ho in range(t.th_o):
            for wo in range(t.tw_o):
                for coo in range(t.tco_o):
                    outer.append((bo, ho, wo, coo))
    if t.h_n == 2:
        # make ho pairs adjacent: reorder (bo, wo, coo, ho)
        outer.sort(key=lambda o: (o[0], o[2], o[3], o[1] // 2, o[1] % 2))

    units: list[list[tuple]]
    if dedup_loads and t.double_buffered:
        units = [outer[i:i + 2] for i in range(0, len(outer), 2)]
    else:
        units = [[o] for o in outer]

    merged = dedup_loads and t.double_buffered

    def unit_state(ui: int, unit: list) -> tuple:
        ctx = ui % n_ctx
        # Buffer policy:
        #  * normal: every buffer split in ctx halves (classic virtual threads)
        #  * merged (dedup): the pair's two subs run as the two virtual
        #    threads (ctx = sub index). The *shared* operand is loaded once
        #    per (pair, reduction step) by ctx0's task and read by both
        #    contexts' GEMMs — that is the paper's reordered access pattern
        #    (I1,W1),(I1,W2),(I2,W1),(I2,W2) — alternating the two halves of
        #    its scratchpad by reduction-step parity so the next step's load
        #    never clobbers the chunk the other context is still reading
        #    (the cross-context read itself is ordered by the serial compute
        #    queue). The non-shared operand and acc use classic per-context
        #    halves, so every region has exactly one loading context and the
        #    same-ctx release tokens (runtime.finalize) close all reuse.
        inp_base0 = ctx * inp_half
        wgt_base0 = ctx * wgt_half
        acc_base0 = ctx * acc_half
        # distinct operand keys within the unit (shared ones load once)
        inp_keys: list[tuple] = []
        wgt_keys: list[tuple] = []
        subs = []
        for (bo, ho, wo, coo) in unit:
            ik = (bo, ho, wo)
            wk = (coo,)
            if ik not in inp_keys:
                inp_keys.append(ik)
            if wk not in wgt_keys:
                wgt_keys.append(wk)
            subs.append((bo, ho, wo, coo, inp_keys.index(ik), wgt_keys.index(wk)))
        if resident_in is None:
            assert n_inp * (1 if merged else len(inp_keys)) <= inp_half, \
                "inp tiles exceed half"
        assert n_wgt * (1 if merged else len(wgt_keys)) <= wgt_half, \
            "wgt tiles exceed half"
        assert acc_per_sub * (1 if merged else len(subs)) <= acc_half
        return (ctx, ui, inp_base0, wgt_base0, acc_base0, inp_keys,
                wgt_keys, subs)

    def emit_unit_task(state: tuple, r: int) -> None:
        (ctx, ui, inp_base0, wgt_base0, acc_base0, inp_keys, wgt_keys,
         subs) = state
        # merged units run their two subs as the two virtual threads; the
        # shared operand's scratchpad halves alternate by reduction-step
        # parity (see the buffer-policy comment in unit_state)
        shared_inp = merged and t.oc_n == 2
        sp = (ui * t.tci_o + r) % 2
        if merged:
            unit_tasks = [Task(ctx=si) for si in range(len(subs))]
        else:
            unit_tasks = [Task(ctx=ctx)]
        task = unit_tasks[0]
        # ---- loads ----
        if resident_in is None:
            for ii, (bo, ho, wo) in enumerate(inp_keys):
                if merged:
                    tgt = unit_tasks[0] if shared_inp else unit_tasks[ii]
                    base = (sp if shared_inp else ii) * inp_half
                else:
                    tgt, base = task, inp_base0 + ii * n_inp
                y0 = ho * th_i * wl.sh - wl.ph
                x0 = wo * tw_i * wl.sw - wl.pw
                ypad0 = max(0, -y0)
                ypad1 = max(0, y0 + ih_i - wl.h)
                xpad0 = max(0, -x0)
                xpad1 = max(0, x0 + iw_i - wl.w)
                ld = LoadInsn(
                    op=Op.LOAD, buffer=Buffer.INP,
                    sram_base=base,
                    dram_base=ui % (1 << 20),
                    y_size=ih_i - ypad0 - ypad1, x_size=iw_i - xpad0 - xpad1,
                    x_stride=max(1, wl.w),
                    y_pad0=min(15, ypad0), y_pad1=min(15, ypad1),
                    x_pad0=min(15, xpad0), x_pad1=min(15, xpad1))
                ld.meta = {"kind": "inp", "b0": bo * tb_i, "tb": tb_i,
                           "ci0": r * tci_i, "tci": tci_i,
                           "y0": y0, "x0": x0, "ih": ih_i, "iw": iw_i}
                if tname("inp"):
                    ld.meta["tensor"] = tname("inp")
                tgt.loads.append(ld)
        for wi_, (coo,) in enumerate(wgt_keys):
            if merged:
                tgt = unit_tasks[wi_] if shared_inp else unit_tasks[0]
                base = (wi_ if shared_inp else sp) * wgt_half
            else:
                tgt, base = task, wgt_base0 + wi_ * n_wgt
            ld = LoadInsn(
                op=Op.LOAD, buffer=Buffer.WGT,
                sram_base=base,
                dram_base=ui % (1 << 20),
                y_size=tco_i, x_size=tci_i * wl.kh * wl.kw,
                x_stride=max(1, di * wl.kh * wl.kw))
            ld.meta = {"kind": "wgt", "co0": coo * tco_i, "tco": tco_i,
                       "ci0": r * tci_i, "tci": tci_i,
                       "kh": wl.kh, "kw": wl.kw}
            if tname("wgt"):
                ld.meta["tensor"] = tname("wgt")
            tgt.loads.append(ld)

        # ---- computes (per sub-iteration) ----
        for si, (bo, ho, wo, coo, ik, wk) in enumerate(subs):
            if merged:
                task = unit_tasks[si]
                acc_base = si * acc_half
                inp_base = (sp if shared_inp else ik) * inp_half
                wgt_base = (wk if shared_inp else sp) * wgt_half
            else:
                acc_base = acc_base0 + si * acc_per_sub
                inp_base = inp_base0 + ik * n_inp
                wgt_base = wgt_base0 + wk * n_wgt
            bias_base = acc_base + n_acc
            skip_base = bias_base + (tb_i * tco_i if bias else 0)
            if resident_in is not None:
                inp_base = resident_in
            if r == 0:
                if bias:
                    ld = LoadInsn(op=Op.LOAD, buffer=Buffer.ACC,
                                  sram_base=bias_base, dram_base=0,
                                  y_size=1, x_size=tb_i * tco_i,
                                  x_stride=tb_i * tco_i)
                    ld.meta = {"kind": "bias", "co0": coo * tco_i,
                               "tco": tco_i, "tb": tb_i}
                    if tname("bias"):
                        ld.meta["tensor"] = tname("bias")
                    task.computes.append(ld)
                emit_compute(task, acc_uops(acc_base),
                             lambda b, e: GemmInsn(op=Op.GEMM, reset=True,
                                                   uop_bgn=b, uop_end=e,
                                                   lp0=th_i, lp1=tw_i,
                                                   acc_f0=tw_i, acc_f1=1))
            seq = gemm_uops(inp_base, wgt_base, acc_base)
            emit_compute(task, seq, lambda b, e: GemmInsn(
                op=Op.GEMM, uop_bgn=b, uop_end=e, lp0=th_i, lp1=tw_i,
                acc_f0=tw_i, acc_f1=1,
                inp_f0=wl.sh * iw_i, inp_f1=wl.sw))

            if r == t.tci_o - 1:
                if bias:
                    emit_compute(task, acc_uops(acc_base, bias_base),
                                 lambda b, e: AluInsn(
                                     op=Op.ALU, alu_op=AluOp.ADD,
                                     uop_bgn=b, uop_end=e,
                                     lp0=th_i, lp1=tw_i,
                                     dst_f0=tw_i, dst_f1=1,
                                     src_f0=0, src_f1=0))
                _emit_post_ops(task, emit_compute, acc_uops(acc_base),
                               th_i, tw_i, post_op)
                if fuse_add is not None:
                    # residual add against the resident output tile:
                    # ACC-load the skip tile, ALU ADD, re-clip (the add
                    # node's clip) — replaces a whole DRAM pass.
                    ld = LoadInsn(op=Op.LOAD, buffer=Buffer.ACC,
                                  sram_base=skip_base,
                                  dram_base=ui % (1 << 20),
                                  y_size=tb_i * tco_i, x_size=th_i * tw_i,
                                  x_stride=max(1, oh * ow))
                    ld.meta = {"kind": "resid", "tensor": fuse_add,
                               "b0": bo * tb_i, "tb": tb_i,
                               "co0": coo * tco_i, "tco": tco_i,
                               "y0": ho * th_i, "th": th_i,
                               "x0": wo * tw_i, "tw": tw_i}
                    task.computes.append(ld)
                    emit_compute(
                        task,
                        acc_uops(acc_base, skip_base,
                                 src_stride=th_i * tw_i),
                        lambda b, e: AluInsn(op=Op.ALU, alu_op=AluOp.ADD,
                                             uop_bgn=b, uop_end=e,
                                             lp0=th_i, lp1=tw_i,
                                             dst_f0=tw_i, dst_f1=1,
                                             src_f0=tw_i, src_f1=1))
                    emit_compute(
                        task, acc_uops(acc_base),
                        lambda b, e: AluInsn(op=Op.ALU, alu_op=AluOp.CLIP,
                                             uop_bgn=b, uop_end=e,
                                             lp0=th_i, lp1=tw_i,
                                             dst_f0=tw_i, dst_f1=1,
                                             src_f0=tw_i, src_f1=1,
                                             use_imm=True, imm=127))
                st = StoreInsn(op=Op.STORE, sram_base=acc_base,
                               dram_base=ui % (1 << 20),
                               y_size=tb_i * tco_i, x_size=th_i * tw_i,
                               x_stride=max(1, oh * ow))
                st.meta = {"kind": "out", "b0": bo * tb_i, "tb": tb_i,
                           "co0": coo * tco_i, "tco": tco_i,
                           "y0": ho * th_i, "th": th_i,
                           "x0": wo * tw_i, "tw": tw_i}
                if tname("out"):
                    st.meta["tensor"] = tname("out")
                if resident_out is not None:
                    _spill(st, resident_out + coo * tco_i * oh * ow,
                           oh * ow)
                task.stores.append(st)
        tasks.extend(unit_tasks)

    # Build tasks in final program order. Reduction steps (the tci_o loop)
    # interleave across the group's n_ctx contexts — (u0,r0),(u1,r0),
    # (u0,r1),(u1,r1),... — so that while one context's GEMM chews step r,
    # the other context's loads stream step r in parallel. Each context's
    # step-r+1 load still waits for its own step-r compute to release the
    # half (finalize's same-ctx token), which is what makes the reuse of one
    # inp/wgt half across the reduction loop hazard-free. Merged dedup units
    # span both contexts themselves, so they form their own group.
    group_n = 1 if merged else n_ctx
    for g0 in range(0, len(units), group_n):
        states = [unit_state(g0 + k, u)
                  for k, u in enumerate(units[g0:g0 + group_n])]
        for r in range(t.tci_o):
            for state in states:
                emit_unit_task(state, r)
    return n_ctx


def _patch_load(wl: ConvWorkload, sram_base: int, y0: int, x0: int,
                ih: int, iw: int, *, stream: bool,
                pad_value: int = 0) -> LoadInsn:
    """Widening ACC load of an (ih, iw) activation patch with explicit pad
    fields: out-of-bounds rows/cols are hardware padding (like the conv INP
    path), not DRAM traffic — y_size/x_size count only real DRAM entries.

    A pad that outgrows its 4-bit field (exotic stride/pad combinations)
    falls back to the padless form — the whole patch extent is fetched and
    billed as DRAM traffic — so the encoded word always describes exactly
    the transfer the simulators perform."""
    ypad0 = max(0, -y0)
    ypad1 = max(0, y0 + ih - wl.h)
    xpad0 = max(0, -x0)
    xpad1 = max(0, x0 + iw - wl.w)
    if max(ypad0, ypad1, xpad0, xpad1) >= (1 << PAD_BITS):
        ypad0 = ypad1 = xpad0 = xpad1 = 0
    return LoadInsn(op=Op.LOAD, buffer=Buffer.ACC, sram_base=sram_base,
                    dram_base=0,
                    y_size=ih - ypad0 - ypad1, x_size=iw - xpad0 - xpad1,
                    x_stride=max(1, wl.w),
                    y_pad0=ypad0, y_pad1=ypad1, x_pad0=xpad0, x_pad1=xpad1,
                    pad_value=pad_value, stream=stream)


def _spill(st: StoreInsn, dst: int, dst_stride: int) -> None:
    """Turn a DRAM store into an on-chip INP-scratchpad spill at ``dst``.

    Row r of the store (one (b,co) tile row of x_size entries) lands at
    ``dst + r*dst_stride`` — the consumer's input-patch layout.
    """
    st.buffer = Buffer.INP
    st.dram_base = dst
    st.meta = {**st.meta, "kind": "spill", "dst": dst,
               "dst_stride": dst_stride}


def schedule_conv(wl: ConvWorkload, t: Tiling, hw: VTAConfig, *,
                  post_op: str = "clip_shift", dedup_loads: bool = False,
                  bias: bool = False, tensors: Optional[dict] = None,
                  fuse_add: Optional[str] = None) -> Schedule:
    alloc = UopAllocator(hw)
    tasks: list[Task] = []
    n_ctx = emit_conv_tasks(wl, t, hw, alloc, tasks, post_op=post_op,
                            dedup_loads=dedup_loads, bias=bias,
                            tensors=tensors, fuse_add=fuse_add)
    return _finish_schedule(wl, t, hw, alloc, tasks, n_ctx)


def _emit_post_ops(task, emit_compute, uops, lp0, lp1, post_op: str):
    def alu(op, imm=0, imm2=0):
        return lambda b, e: AluInsn(op=Op.ALU, alu_op=op, uop_bgn=b, uop_end=e,
                                    lp0=lp0, lp1=lp1, dst_f0=lp1, dst_f1=1,
                                    src_f0=lp1, src_f1=1, use_imm=True,
                                    imm=imm, imm2=imm2)
    if post_op == "none":
        return
    if post_op == "clip":
        # elementwise-add epilogue: clip only, no shift
        emit_compute(task, uops, alu(AluOp.CLIP, 127))
    elif post_op == "relu":
        emit_compute(task, uops, alu(AluOp.MAX, 0))
    elif post_op == "relu_shift":
        emit_compute(task, uops, alu(AluOp.SHR, 8))
        emit_compute(task, uops, alu(AluOp.MAX, 0))
    elif post_op == "clip_shift":
        emit_compute(task, uops, alu(AluOp.SHR, 8))
        # NEW clip insn: one op instead of MIN+MAX (paper abstract)
        emit_compute(task, uops, alu(AluOp.CLIP, 127))
    elif post_op == "clip_shift_legacy":
        emit_compute(task, uops, alu(AluOp.SHR, 8))
        emit_compute(task, uops, alu(AluOp.MIN, 127))
        emit_compute(task, uops, alu(AluOp.MAX, -127))
    else:
        raise ValueError(post_op)


# ---------------------------------------------------------------------------
# Depthwise conv (§IV.D.3): vectorized ALU macro-ops over taps, channel-blocked
# ---------------------------------------------------------------------------
def _chunked(seq: tuple, cap: int):
    for s0 in range(0, len(seq), cap):
        yield seq[s0:s0 + cap]


def emit_depthwise_tasks(wl: ConvWorkload, hw: VTAConfig,
                         alloc: UopAllocator, tasks: list, *,
                         post_op: str = "relu_shift",
                         tensors: Optional[dict] = None,
                         resident_out: Optional[int] = None,
                         n_ctx: int = 1, vectorize: bool = True,
                         tile: Optional[tuple] = None) -> Tiling:
    """Depthwise conv on the ALU.

    Vectorized form (default): one overwrite-MAC sweep seeds the output tile
    with tap 0's products, then a single multi-uop MAC macro-op accumulates
    every remaining tap — ``2 + len(post)`` ALU instructions per tile where
    the single-uop form needed ``4*kh*kw + 1``. Tap weights live in the low
    acc slots (``n_ctx * kh * kw`` entries) so the MAC's latched src2 fits
    the uop's third field; patch/weight loads stream through the LD engine
    and tasks alternate scratchpad halves when ``n_ctx == 2``, so the memory
    engine fills tile i+1 while the ALU chews tile i.

    Legacy form (``vectorize=False``, the pre-macro-op lowering kept as the
    tsim comparison baseline): per tap (tmp=0, copy, MUL weight, ADD into
    out), each a single-uop instruction, single-context, compute-queue loads.

    ``tile`` overrides the capacity-greedy spatial tile with an explicit
    ``(th_i, tw_i)`` — the autotuner's search knob; it must still fit the
    per-context budget (asserted, so infeasible candidates are prunable).
    """
    BV, BO = hw.batch, hw.block_out
    assert wl.fi == wl.fo and wl.b % BV == 0 and wl.fo % BO == 0
    if not vectorize:
        n_ctx = 1               # the legacy forms are single-context
    dc = wl.fo // BO
    oh, ow = wl.oh, wl.ow
    kk = wl.kh * wl.kw
    tname = (tensors or {}).get
    # Tile against the per-context acc budget (the vectorized form drops the
    # tmp tile and hoists tap weights into a low reserve; the legacy form
    # keeps the old [patch | out | tmp | wgt] layout in a single context).
    # Double buffering halves the spatial tile when it must — the overlap
    # re-reads cost a little DRAM, the load/compute overlap buys more cycles
    # — but n_ctx falls back to 1 if even a 1x1 tile cannot split.
    def need(th, tw):
        ih = (th - 1) * wl.sh + wl.kh
        iw = (tw - 1) * wl.sw + wl.kw
        return ih * iw + th * tw + (0 if vectorize else th * tw + kk)
    if n_ctx > 1 and _shrink_tile(
            oh, ow, need, (hw.acc_depth - n_ctx * kk) // n_ctx) is None:
        n_ctx = 1
    wgt_reserve = n_ctx * kk if vectorize else 0
    half = (hw.acc_depth - wgt_reserve) // n_ctx
    if tile is None:
        tile = _shrink_tile(oh, ow, need, half)
    else:
        assert need(*tile) <= half, \
            f"depthwise tile {tile} exceeds per-context acc budget"
    assert tile is not None, "acc scratchpad too small for depthwise tile"
    th_i, tw_i = tile
    th_o, tw_o = _ceil_div(oh, th_i), _ceil_div(ow, tw_i)
    ih_i = (th_i - 1) * wl.sh + wl.kh
    iw_i = (tw_i - 1) * wl.sw + wl.kw
    if resident_out is not None:
        assert tw_o == 1 and wl.b // BV == 1, \
            "resident output needs full-width rows and batch 1"
        # a partial edge tile would spill rows past the tensor's extent into
        # the next channel's resident region (the DRAM path clamps; the
        # on-chip path must not need to)
        assert oh % th_i == 0, "resident output needs divisor spatial tiles"

    cap = max(1, hw.uop_depth)
    taps = [(dy, dx) for dy in range(wl.kh) for dx in range(wl.kw)]
    last_wc: dict = {}          # ctx -> channel block whose weights are loaded
    for ti, (b, c, ho, wo) in enumerate(
            (b, c, ho, wo) for b in range(wl.b // BV) for c in range(dc)
            for ho in range(th_o) for wo in range(tw_o)):
        ctx = ti % n_ctx
        if vectorize:
            wgt_base = ctx * kk
            patch_base = wgt_reserve + ctx * half
            out_base = patch_base + ih_i * iw_i
            tmp_base = None
        else:
            patch_base = 0
            out_base = ih_i * iw_i
            tmp_base = out_base + th_i * tw_i
            wgt_base = tmp_base + th_i * tw_i
        task = Task(ctx=ctx)
        y0 = ho * th_i * wl.sh - wl.ph
        x0 = wo * tw_i * wl.sw - wl.pw
        ld = _patch_load(wl, patch_base, y0, x0, ih_i, iw_i,
                         stream=vectorize)
        ld.meta = {"kind": "dw_patch", "b0": b, "c0": c,
                   "y0": y0, "x0": x0, "ih": ih_i, "iw": iw_i}
        if tname("inp"):
            ld.meta["tensor"] = tname("inp")
        # hoist the tap-weight load out of the spatial tile loop: within one
        # channel block every (ho, wo) tile reuses the same kh*kw weights,
        # so only the first tile of a (ctx, c) run reloads the slot
        loads = [ld]
        if not vectorize or last_wc.get(ctx) != c:
            last_wc[ctx] = c
            lw = LoadInsn(op=Op.LOAD, buffer=Buffer.ACC,
                          sram_base=wgt_base, dram_base=0,
                          y_size=1, x_size=kk, x_stride=kk,
                          stream=vectorize)
            lw.meta = {"kind": "dw_wgt", "c0": c, "kh": wl.kh, "kw": wl.kw}
            if tname("wgt"):
                lw.meta["tensor"] = tname("wgt")
            loads.append(lw)
        if vectorize:
            task.loads.extend(loads)
        else:
            task.computes.extend(loads)

        def emit(seq, make):
            for chunk in _chunked(seq, cap):
                bgn, uld = alloc.place(chunk)
                if uld is not None:
                    task.computes.append(uld)
                task.computes.append(make(bgn, bgn + len(chunk)))

        def mac(seq, overwrite):
            emit(seq, lambda b_, e, o=overwrite: AluInsn(
                op=Op.ALU, alu_op=AluOp.MAC, uop_bgn=b_, uop_end=e,
                lp0=th_i, lp1=tw_i, dst_f0=tw_i, dst_f1=1,
                src_f0=wl.sh * iw_i, src_f1=wl.sw, overwrite=o))

        if vectorize:
            # tap 0 seeds out (write-through), taps 1.. accumulate — one
            # multi-uop MAC sweep covers them all
            def tap_uop(dy, dx):
                return Uop(out_base, patch_base + dy * iw_i + dx,
                           wgt_base + dy * wl.kw + dx)
            mac((tap_uop(*taps[0]),), True)
            if len(taps) > 1:
                mac(tuple(tap_uop(dy, dx) for dy, dx in taps[1:]), False)
        else:
            # zero the out region
            emit((Uop(out_base, out_base, 0),),
                 lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.MUL,
                                       uop_bgn=b_, uop_end=e,
                                       lp0=th_i, lp1=tw_i,
                                       dst_f0=tw_i, dst_f1=1,
                                       src_f0=tw_i, src_f1=1,
                                       use_imm=True, imm=0))
            for dy, dx in taps:
                src = patch_base + dy * iw_i + dx
                # tmp = 0; tmp += shifted patch; tmp *= w[dy,dx]; out += tmp
                emit((Uop(tmp_base, tmp_base, 0),),
                     lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.MUL,
                                           uop_bgn=b_, uop_end=e,
                                           lp0=th_i, lp1=tw_i,
                                           dst_f0=tw_i, dst_f1=1,
                                           src_f0=tw_i, src_f1=1,
                                           use_imm=True, imm=0))
                emit((Uop(tmp_base, src, 0),),
                     lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.ADD,
                                           uop_bgn=b_, uop_end=e,
                                           lp0=th_i, lp1=tw_i,
                                           dst_f0=tw_i, dst_f1=1,
                                           src_f0=wl.sh * iw_i,
                                           src_f1=wl.sw))
                emit((Uop(tmp_base, wgt_base + dy * wl.kw + dx, 0),),
                     lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.MUL,
                                           uop_bgn=b_, uop_end=e,
                                           lp0=th_i, lp1=tw_i,
                                           dst_f0=tw_i, dst_f1=1,
                                           src_f0=0, src_f1=0))
                emit((Uop(out_base, tmp_base, 0),),
                     lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.ADD,
                                           uop_bgn=b_, uop_end=e,
                                           lp0=th_i, lp1=tw_i,
                                           dst_f0=tw_i, dst_f1=1,
                                           src_f0=tw_i, src_f1=1))
        _emit_post_ops(task, lambda t_, s, m: emit(s, m),
                       (Uop(out_base, out_base, 0),), th_i, tw_i, post_op)
        st = StoreInsn(op=Op.STORE, sram_base=out_base, dram_base=0,
                       y_size=1, x_size=th_i * tw_i, x_stride=oh * ow)
        st.meta = {"kind": "dw_out", "b0": b, "c0": c,
                   "y0": ho * th_i, "th": th_i,
                   "x0": wo * tw_i, "tw": tw_i}
        if tname("out"):
            st.meta["tensor"] = tname("out")
        if resident_out is not None:
            _spill(st, resident_out + c * oh * ow
                   + ho * th_i * ow, 1)
        task.stores.append(st)
        tasks.append(task)
    return Tiling(1, th_o, tw_o, dc, 1)


def schedule_depthwise(wl: ConvWorkload, hw: VTAConfig, *,
                       post_op: str = "relu_shift",
                       tensors: Optional[dict] = None,
                       vectorize: bool = True,
                       tile: Optional[tuple] = None) -> Schedule:
    alloc = UopAllocator(hw)
    tasks: list[Task] = []
    t = emit_depthwise_tasks(wl, hw, alloc, tasks, post_op=post_op,
                             tensors=tensors, n_ctx=2 if vectorize else 1,
                             vectorize=vectorize, tile=tile)
    return _finish_schedule(wl, t, hw, alloc, tasks, _n_ctx_of(tasks))


# ---------------------------------------------------------------------------
# Pooling (§IV.E): max pool via pad-value load + ALU MAX; avg via ADD + SHR
# ---------------------------------------------------------------------------
def emit_pool_tasks(wl: ConvWorkload, hw: VTAConfig,
                    alloc: UopAllocator, tasks: list, *, mode: str = "max",
                    tensors: Optional[dict] = None,
                    resident_out: Optional[int] = None,
                    n_ctx: int = 1, vectorize: bool = True,
                    tile: Optional[tuple] = None) -> Tiling:
    """Pool on the ALU. Vectorized form: tap 0 is an overwrite (write-through)
    copy and every remaining tap rides one multi-uop MAX/ADD macro sweep —
    2-3 ALU instructions per tile vs ``kh*kw + 2``; patch loads stream via
    the LD engine and tasks alternate scratchpad halves (``n_ctx == 2``).
    ``vectorize=False`` keeps the single-uop, single-context legacy forms.
    ``tile`` overrides the capacity-greedy spatial tile (autotuner knob)."""
    BV, BO = hw.batch, hw.block_out
    assert wl.fi == wl.fo and wl.fo % BO == 0
    if not vectorize:
        n_ctx = 1
    dc = wl.fo // BO
    oh, ow = wl.oh, wl.ow
    tname = (tensors or {}).get
    # same policy as depthwise: halve the spatial tile until it fits a
    # per-context half; n_ctx falls back to 1 only when no tile splits
    def need(th, tw):
        ih = (th - 1) * wl.sh + wl.kh
        iw = (tw - 1) * wl.sw + wl.kw
        return ih * iw + th * tw
    if n_ctx > 1 and _shrink_tile(oh, ow, need, hw.acc_depth // n_ctx) is None:
        n_ctx = 1
    half = hw.acc_depth // n_ctx
    if tile is None:
        tile = _shrink_tile(oh, ow, need, half)
    else:
        assert need(*tile) <= half, \
            f"pool tile {tile} exceeds per-context acc budget"
    assert tile is not None, "acc scratchpad too small for pool tile"
    th_i, tw_i = tile
    th_o, tw_o = _ceil_div(oh, th_i), _ceil_div(ow, tw_i)
    ih_i = (th_i - 1) * wl.sh + wl.kh
    iw_i = (tw_i - 1) * wl.sw + wl.kw
    pad_value = INT8_MIN if mode == "max" else 0
    if resident_out is not None:
        assert tw_o == 1 and wl.b // BV == 1, \
            "resident output needs full-width rows and batch 1"
        # a partial edge tile would spill rows past the tensor's extent into
        # the next channel's resident region (the DRAM path clamps; the
        # on-chip path must not need to)
        assert oh % th_i == 0, "resident output needs divisor spatial tiles"

    cap = max(1, hw.uop_depth)
    taps = [(dy, dx) for dy in range(wl.kh) for dx in range(wl.kw)]
    op = AluOp.MAX if mode == "max" else AluOp.ADD
    for ti, (b, c, ho, wo) in enumerate(
            (b, c, ho, wo) for b in range(wl.b // BV) for c in range(dc)
            for ho in range(th_o) for wo in range(tw_o)):
        ctx = ti % n_ctx
        patch_base = ctx * half
        out_base = patch_base + ih_i * iw_i
        task = Task(ctx=ctx)
        y0 = ho * th_i * wl.sh - wl.ph
        x0 = wo * tw_i * wl.sw - wl.pw
        ld = _patch_load(wl, patch_base, y0, x0, ih_i, iw_i,
                         stream=vectorize, pad_value=pad_value)
        ld.meta = {"kind": "dw_patch", "b0": b, "c0": c,
                   "y0": y0, "x0": x0, "ih": ih_i, "iw": iw_i,
                   "pad_value": pad_value}
        if tname("inp"):
            ld.meta["tensor"] = tname("inp")
        if vectorize:
            task.loads.append(ld)
        else:
            task.computes.append(ld)

        def emit(seq, make):
            for chunk in _chunked(seq, cap):
                bgn, uld = alloc.place(chunk)
                if uld is not None:
                    task.computes.append(uld)
                task.computes.append(make(bgn, bgn + len(chunk)))

        def tap_sweep(seq, o, overwrite):
            emit(seq, lambda b_, e, o=o, ov=overwrite: AluInsn(
                op=Op.ALU, alu_op=o, uop_bgn=b_, uop_end=e,
                lp0=th_i, lp1=tw_i, dst_f0=tw_i, dst_f1=1,
                src_f0=wl.sh * iw_i, src_f1=wl.sw, overwrite=ov))

        def tap_uop(dy, dx):
            return Uop(out_base, patch_base + dy * iw_i + dx, 0)

        if vectorize:
            # out <- tap0 (write-through copy), then one MAX/ADD macro sweep
            tap_sweep((tap_uop(*taps[0]),), AluOp.ADD, True)
            if len(taps) > 1:
                tap_sweep(tuple(tap_uop(dy, dx) for dy, dx in taps[1:]),
                          op, False)
        else:
            # out = 0 (MUL imm 0); out += tap0 (copy); then MAX/ADD rest
            emit((Uop(out_base, out_base, 0),),
                 lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.MUL,
                                       uop_bgn=b_, uop_end=e,
                                       lp0=th_i, lp1=tw_i,
                                       dst_f0=tw_i, dst_f1=1,
                                       src_f0=tw_i, src_f1=1,
                                       use_imm=True, imm=0))
            for ti_, (dy, dx) in enumerate(taps):
                tap_sweep((tap_uop(dy, dx),),
                          AluOp.ADD if ti_ == 0 else op, False)
        if mode == "avg":
            shift = max(0, int(round(math.log2(wl.kh * wl.kw))))
            emit((Uop(out_base, out_base, 0),),
                 lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.SHR,
                                       uop_bgn=b_, uop_end=e,
                                       lp0=th_i, lp1=tw_i,
                                       dst_f0=tw_i, dst_f1=1,
                                       src_f0=tw_i, src_f1=1,
                                       use_imm=True, imm=shift))
        st = StoreInsn(op=Op.STORE, sram_base=out_base, dram_base=0,
                       y_size=1, x_size=th_i * tw_i, x_stride=oh * ow)
        st.meta = {"kind": "dw_out", "b0": b, "c0": c,
                   "y0": ho * th_i, "th": th_i,
                   "x0": wo * tw_i, "tw": tw_i}
        if tname("out"):
            st.meta["tensor"] = tname("out")
        if resident_out is not None:
            _spill(st, resident_out + c * oh * ow
                   + ho * th_i * ow, 1)
        task.stores.append(st)
        tasks.append(task)
    return Tiling(1, th_o, tw_o, dc, 1)


def schedule_pool(wl: ConvWorkload, hw: VTAConfig, *, mode: str = "max",
                  tensors: Optional[dict] = None,
                  vectorize: bool = True,
                  tile: Optional[tuple] = None) -> Schedule:
    alloc = UopAllocator(hw)
    tasks: list[Task] = []
    t = emit_pool_tasks(wl, hw, alloc, tasks, mode=mode, tensors=tensors,
                        n_ctx=2 if vectorize else 1, vectorize=vectorize,
                        tile=tile)
    return _finish_schedule(wl, t, hw, alloc, tasks, _n_ctx_of(tasks))


# ---------------------------------------------------------------------------
# Elementwise residual add (graph `add` nodes, unfused fallback path):
# out = clip(a + b). Both operands are widened int8 ACC loads; the whole
# layer is ALU work with one DRAM pass per operand plus the output store.
# When a producer conv absorbs the add (fuse_add), this schedule disappears
# entirely — that is the graph compiler's DRAM win.
# ---------------------------------------------------------------------------
def emit_add_tasks(wl: ConvWorkload, hw: VTAConfig,
                   alloc: UopAllocator, tasks: list, *,
                   tensors: Optional[dict] = None,
                   n_ctx: int = 1, vectorize: bool = True) -> Tiling:
    BV, BO = hw.batch, hw.block_out
    assert wl.fi == wl.fo and wl.fo % BO == 0
    if not vectorize:
        n_ctx = 1
    dc = wl.fo // BO
    oh, ow = wl.oh, wl.ow
    tname = (tensors or {}).get
    need = lambda th, tw: th * tw * 2      # the a/b operand pair
    if n_ctx > 1 and _shrink_tile(oh, ow, need, hw.acc_depth // n_ctx) is None:
        n_ctx = 1
    half = hw.acc_depth // n_ctx
    tile = _shrink_tile(oh, ow, need, half)
    assert tile is not None, "acc too small for add tile"
    th_i, tw_i = tile
    th_o, tw_o = _ceil_div(oh, th_i), _ceil_div(ow, tw_i)

    for ti, (b, c, ho, wo) in enumerate(
            (b, c, ho, wo) for b in range(wl.b // BV) for c in range(dc)
            for ho in range(th_o) for wo in range(tw_o)):
        ctx = ti % n_ctx
        a_base = ctx * half
        b_base = a_base + th_i * tw_i
        task = Task(ctx=ctx)
        for base, role in ((a_base, "add_a"), (b_base, "add_b")):
            ld = LoadInsn(op=Op.LOAD, buffer=Buffer.ACC,
                          sram_base=base, dram_base=0,
                          y_size=th_i, x_size=tw_i, x_stride=ow,
                          stream=vectorize)
            ld.meta = {"kind": "dw_patch", "b0": b, "c0": c,
                       "y0": ho * th_i, "x0": wo * tw_i,
                       "ih": th_i, "iw": tw_i}
            if tname(role):
                ld.meta["tensor"] = tname(role)
            if vectorize:
                task.loads.append(ld)
            else:
                task.computes.append(ld)

        def emit(seq, make):
            bgn, uld = alloc.place(seq)
            if uld is not None:
                task.computes.append(uld)
            task.computes.append(make(bgn, bgn + len(seq)))

        emit((Uop(a_base, b_base, 0),),
             lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.ADD,
                                   uop_bgn=b_, uop_end=e,
                                   lp0=th_i, lp1=tw_i,
                                   dst_f0=tw_i, dst_f1=1,
                                   src_f0=tw_i, src_f1=1))
        emit((Uop(a_base, a_base, 0),),
             lambda b_, e: AluInsn(op=Op.ALU, alu_op=AluOp.CLIP,
                                   uop_bgn=b_, uop_end=e,
                                   lp0=th_i, lp1=tw_i,
                                   dst_f0=tw_i, dst_f1=1,
                                   src_f0=tw_i, src_f1=1,
                                   use_imm=True, imm=127))
        st = StoreInsn(op=Op.STORE, sram_base=a_base, dram_base=0,
                       y_size=1, x_size=th_i * tw_i, x_stride=oh * ow)
        st.meta = {"kind": "dw_out", "b0": b, "c0": c,
                   "y0": ho * th_i, "th": th_i,
                   "x0": wo * tw_i, "tw": tw_i}
        if tname("out"):
            st.meta["tensor"] = tname("out")
        task.stores.append(st)
        tasks.append(task)
    return Tiling(1, th_o, tw_o, dc, 1)


def schedule_add(wl: ConvWorkload, hw: VTAConfig, *,
                 tensors: Optional[dict] = None,
                 vectorize: bool = True) -> Schedule:
    alloc = UopAllocator(hw)
    tasks: list[Task] = []
    t = emit_add_tasks(wl, hw, alloc, tasks, tensors=tensors,
                       n_ctx=2 if vectorize else 1, vectorize=vectorize)
    return _finish_schedule(wl, t, hw, alloc, tasks, _n_ctx_of(tasks))


# ---------------------------------------------------------------------------
# Channel concat (graph `concat` nodes): pure DMA — widen-load each source
# tile into acc and store it narrowed at its channel offset in the output.
# ---------------------------------------------------------------------------
def emit_concat_tasks(shapes: list, hw: VTAConfig,
                      alloc: UopAllocator, tasks: list, *,
                      tensors: Optional[list] = None,
                      out_tensor: Optional[str] = None,
                      n_ctx: int = 1) -> None:
    """shapes: per-source (B, C, H, W); sources stack along channels.

    Pure DMA: with ``n_ctx == 2`` the loads fill alternating acc halves, so
    tile i+1 loads (compute queue) while tile i stores (store queue); a
    source whose single row outgrows a half downgrades to one context."""
    BV, BO = hw.batch, hw.block_out
    if n_ctx > 1 and any(w > hw.acc_depth // n_ctx for (_, _, _, w) in shapes):
        n_ctx = 1
    half = hw.acc_depth // n_ctx
    c_off = 0
    ti = 0
    for si, (b, c, h, w) in enumerate(shapes):
        assert c % BO == 0 and b % BV == 0
        th_i = h
        while th_i * w > half and th_i > 1:
            th_i = _ceil_div(th_i, 2)
        assert th_i * w <= half, "acc scratchpad too small for concat row"
        th_o = _ceil_div(h, th_i)
        for bb in range(b // BV):
            for cc in range(c // BO):
                for ho in range(th_o):
                    ctx = ti % n_ctx
                    ti += 1
                    base = ctx * half
                    task = Task(ctx=ctx)
                    ld = LoadInsn(op=Op.LOAD, buffer=Buffer.ACC,
                                  sram_base=base, dram_base=0,
                                  y_size=th_i, x_size=w, x_stride=w)
                    ld.meta = {"kind": "dw_patch", "b0": bb, "c0": cc,
                               "y0": ho * th_i, "x0": 0, "ih": th_i, "iw": w}
                    if tensors:
                        ld.meta["tensor"] = tensors[si]
                    task.computes.append(ld)
                    st = StoreInsn(op=Op.STORE, sram_base=base, dram_base=0,
                                   y_size=1, x_size=th_i * w, x_stride=h * w)
                    st.meta = {"kind": "dw_out", "b0": bb,
                               "c0": c_off // BO + cc,
                               "y0": ho * th_i, "th": th_i, "x0": 0, "tw": w}
                    if out_tensor:
                        st.meta["tensor"] = out_tensor
                    task.stores.append(st)
                    tasks.append(task)
        c_off += c


# ---------------------------------------------------------------------------
# DRAM traffic accounting (drives Fig 10/11 benches + tsim memory timing).
# The per-instruction rule (`insn_dram_bytes`, re-exported above) lives in
# vta/lowering.py — the single point that interprets load/store metas.
# ---------------------------------------------------------------------------
def program_dram_bytes(prog: Program, hw: VTAConfig) -> dict:
    out = {"inp": 0, "wgt": 0, "acc": 0, "uop": 0, "out": 0, "total": 0,
           "onchip": 0}
    for i in prog.order:
        b = insn_dram_bytes(i, hw)
        if isinstance(i, LoadInsn):
            key = {Buffer.INP: "inp", Buffer.WGT: "wgt", Buffer.ACC: "acc",
                   Buffer.UOP: "uop", Buffer.OUT: "out"}[i.buffer]
            out[key] += b
        elif isinstance(i, StoreInsn):
            if i.on_chip:
                out["onchip"] += i.tiles() * hw.out_tile_bytes
            out["out"] += b
        out["total"] += b
    return out
