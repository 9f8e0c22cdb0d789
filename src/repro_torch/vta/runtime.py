"""SW-defined runtime: instruction-stream builder (paper §II.C).

The scheduler emits *tasks* (loads + computes + stores for one tile of work,
tagged with a virtual-thread context); the runtime:

  * allocates uop-buffer space with a dedup cache ("runtime enhancements to
    lower uop count" — identical uop sequences are loaded once);
  * assigns the 4 dependency-token bits that let the load / compute / store
    queues run concurrently without races (double buffering), following the
    classic VTA virtual-thread pattern: task t synchronizes with task t-N
    (N = number of contexts) over each shared scratchpad;
  * emits LOADs of UOP/ACC through the *compute* queue (as on real VTA) and
    INP/WGT through the load queue.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from repro_torch.vta.isa import (AluInsn, Buffer, FinishInsn, GemmInsn, Insn,
                           LoadInsn, Op, StoreInsn, VTAConfig, encode_insn)


@dataclass
class Task:
    """One tile's worth of work in a single virtual-thread context."""
    ctx: int = 0
    loads: list = field(default_factory=list)        # LoadInsn (INP/WGT)
    computes: list = field(default_factory=list)     # Gemm/Alu/Load(UOP/ACC)
    stores: list = field(default_factory=list)       # StoreInsn


@dataclass
class Program:
    """Finalized instruction stream."""
    hw: VTAConfig
    order: list = field(default_factory=list)        # global program order
    uop_mem: list = field(default_factory=list)      # uop DRAM image
    n_ctx: int = 1

    @property
    def queues(self) -> dict:
        qs = {"load": [], "compute": [], "store": []}
        for insn in self.order:
            qs[queue_of(insn)].append(insn)
        return qs

    def counts(self) -> dict:
        c = {"load": 0, "gemm": 0, "alu": 0, "store": 0, "uop_load": 0,
             "acc_load": 0, "uops": len(self.uop_mem), "insns": len(self.order)}
        for i in self.order:
            if isinstance(i, LoadInsn):
                if i.buffer == Buffer.UOP:
                    c["uop_load"] += 1
                elif i.buffer == Buffer.ACC:
                    c["acc_load"] += 1
                else:
                    c["load"] += 1
            elif isinstance(i, GemmInsn):
                c["gemm"] += 1
            elif isinstance(i, AluInsn):
                c["alu"] += 1
            elif isinstance(i, StoreInsn):
                c["store"] += 1
        return c

    def validate_encoding(self) -> int:
        """Encode every instruction + uop; returns #words (raises on overflow)."""
        n = 0
        for i in self.order:
            encode_insn(i, self.hw)
            n += 1
        for u in self.uop_mem:
            u.encode(self.hw)
        return n


def queue_of(insn: Insn) -> str:
    if isinstance(insn, LoadInsn):
        if insn.buffer == Buffer.ACC and insn.stream:
            return "load"       # streamed ALU-layer tile (double buffering)
        return "compute" if insn.buffer in (Buffer.UOP, Buffer.ACC) else "load"
    if isinstance(insn, StoreInsn):
        return "store"
    if insn.op in (Op.GEMM, Op.ALU, Op.FINISH):
        return "compute"
    return "load"


class UopAllocator:
    """Uop buffer with content dedup (lowers uop-load count, paper abstract)."""

    def __init__(self, hw: VTAConfig):
        self.hw = hw
        self.capacity = hw.uop_depth
        self.cursor = 0
        self.cache: dict = {}        # seq -> sram bgn (valid until flush)
        self.dram_cache: dict = {}   # seq -> dram base (survives flushes)
        self.mem: list = []          # DRAM image of all unique sequences
        self.flushes = 0

    def place(self, seq: tuple) -> tuple:
        """Returns (uop_bgn, load_insn_or_None)."""
        key = seq
        if key in self.cache:
            return self.cache[key], None
        if self.cursor + len(seq) > self.capacity:
            self.cache.clear()
            self.cursor = 0
            self.flushes += 1
            if len(seq) > self.capacity:
                raise ValueError(
                    f"uop sequence ({len(seq)}) exceeds uop buffer "
                    f"({self.capacity}); enlarge LOG_UOP_BUFF")
        bgn = self.cursor
        # content-dedup the DRAM image too: a sequence re-placed after a
        # buffer flush reloads the *same* DRAM chunk instead of appending a
        # fresh copy (repeated tiles stop paying uop DRAM traffic)
        dram_base = self.dram_cache.get(key)
        if dram_base is None:
            dram_base = len(self.mem)
            self.mem.extend(seq)
            self.dram_cache[key] = dram_base
        self.cursor += len(seq)
        self.cache[key] = bgn
        ld = LoadInsn(op=Op.LOAD, buffer=Buffer.UOP, sram_base=bgn,
                      dram_base=dram_base, y_size=1, x_size=len(seq), x_stride=len(seq))
        return bgn, ld


def finalize(tasks: list[Task], hw: VTAConfig, n_ctx: int = 1) -> Program:
    """Assign dependency bits and produce the global instruction order.

    Token protocol per task t, synchronizing with the *previous task in the
    same virtual-thread context* — the task whose scratchpad regions t
    reuses. For strictly-alternating schedules that is exactly task
    t - n_ctx (the classic VTA pattern); for runs of same-context tasks
    (e.g. a conv's reduction loop reusing one inp/wgt half per step) it is
    task t - 1, which the old fixed-distance protocol left unsynchronized —
    a scratchpad WAR race that ``run_tsim(check_hazards=True)`` now catches:
      load[0]        pop_next   (prev same-ctx compute released inp/wgt half)
      load[-1]       push_next  (data ready for compute)
      compute[0]     pop_prev   (consume load token)
      compute[-1]    push_prev  (release inp/wgt half to the next same-ctx
                                 task's loads)
      compute[-1]    push_next  (result ready for store)
      compute[0]     pop_next   (prev same-ctx store freed the acc half)
      store[0]       pop_prev ; store[-1] push_prev

    Release tokens are tracked per context as pending counters so pushes
    and pops stay balanced even when tasks lack loads or stores (reduction
    steps store nothing; their first compute still consumes the pending
    store release so it cannot clobber an acc half that is mid-store).
    """
    order: list = []
    load_rel: dict = {}      # ctx -> pending compute->load half releases
    store_rel: dict = {}     # ctx -> pending store->compute half releases
    for task in tasks:
        ctx = task.ctx
        has_loads = bool(task.loads)
        has_stores = bool(task.stores)
        if has_loads:
            if load_rel.get(ctx, 0) > 0:
                task.loads[0].pop_next = True       # wait compute release
                load_rel[ctx] -= 1
            task.loads[-1].push_next = True
        if task.computes:
            if has_loads:
                task.computes[0].pop_prev = True
            if store_rel.get(ctx, 0) > 0:
                task.computes[0].pop_next = True    # acc half freed by store
                store_rel[ctx] -= 1
            if has_loads:
                task.computes[-1].push_prev = True  # release inp/wgt half
                load_rel[ctx] = load_rel.get(ctx, 0) + 1
            if has_stores:
                task.computes[-1].push_next = True
        if has_stores:
            task.stores[0].pop_prev = True
            task.stores[-1].push_prev = True
            store_rel[ctx] = store_rel.get(ctx, 0) + 1
        order.extend(task.loads)
        order.extend(task.computes)
        order.extend(task.stores)
    order.append(FinishInsn(op=Op.FINISH))
    return Program(hw=hw, order=order, n_ctx=n_ctx)
