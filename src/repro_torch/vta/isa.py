"""VTA hardware configuration + instruction set (faithful machine model).

The paper's §II.B ISA: 5 instructions (LOAD, STORE, GEMM, ALU, FINISH), 128-bit
wide, plus 32-bit (extendable to 64-bit) uops. Field widths are derived from
the hardware config — larger scratchpads need wider address fields, and the
encoder *checks* that everything still fits in the 128-bit budget (the paper's
"compile-time checks - such as ensuring instruction width constraints are not
violated"). When uop address fields outgrow 32 bits the uop width doubles,
mirroring "we also extended the size of uops".

New instructions/variants from the paper (§IV.D-E, abstract):
  * ALU opcode MUL — element-wise 8-bit multiply (depthwise conv);
  * LOAD pad_value choice — 0 or INT8_MIN (max-pool support);
  * ALU opcode CLIP — min+max in one op (the ResNet clip pattern).

Vectorized ALU macro-ops (this stack's micro-architecture enhancement, in the
paper's feature-by-feature methodology):
  * every ALU instruction iterates a *uop vector* [uop_bgn, uop_end), exactly
    like GEMM — one instruction sweeps many taps/operand pairs instead of one
    single-uop sweep per tap, paying fetch/decode/flush once;
  * ``overwrite`` bit — the symmetric counterpart of the GEMM ``reset`` bit:
    the destination's prior value is ignored and the source (or immediate, or
    MAC product) is written through. Collapses the tmp=0/copy idiom into one
    single-read micro-op;
  * ALU opcode MAC — ``dst += src1 * src2``: the uop's third field (idle in
    classic two-operand ALU ops, already decoded for GEMM) addresses a second
    acc operand that is loop-invariant across the lp0 x lp1 sweep and latched
    once per uop. Depthwise conv becomes one overwrite-MAC + one MAC sweep
    per tile. Because the field is the uop's WGT slot, latched operands must
    sit in the low 2^wgt_addr_bits entries of the acc scratchpad — checked at
    encode time like every other field constraint.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from enum import IntEnum


class Op(IntEnum):
    LOAD = 0
    STORE = 1
    GEMM = 2
    ALU = 3
    FINISH = 4


class AluOp(IntEnum):
    ADD = 0
    MAX = 1
    MIN = 2
    SHR = 3
    MUL = 4      # NEW (paper): element-wise multiply for depthwise conv
    CLIP = 5     # NEW (paper): fused min/max clip (ResNet pattern)
    MAC = 6      # NEW (macro-op): dst += src1 * src2 (uop 3rd field = src2)


class Buffer(IntEnum):
    UOP = 0
    WGT = 1
    INP = 2
    ACC = 3
    OUT = 4


INSN_BITS = 128


@dataclass(frozen=True)
class VTAConfig:
    """log2-parameterized, like the upstream JSON config."""
    log_batch: int = 0
    log_block_in: int = 4
    log_block_out: int = 4
    log_inp_buff: int = 15      # bytes (default 32 KiB)
    log_wgt_buff: int = 18      # 256 KiB
    log_acc_buff: int = 17      # 128 KiB
    log_uop_buff: int = 15      # 32 KiB
    mem_width_bytes: int = 8    # AXI data width: 8..64 bytes/cycle (paper §IV.A.3)
    gemm_ii: int = 4            # initiation interval; 1 = pipelined (paper §IV.A.1)
    alu_ii: int = 4             # 1/2 pipelined (paper §IV.A.2)
    gemm_depth: int = 5         # pipeline depth (flush cost per instruction)
    dram_latency: int = 64      # cycles to first beat of a DMA burst
    max_inflight: int = 8       # VME outstanding requests (paper Fig 6)
    inp_bytes: int = 1          # int8
    wgt_bytes: int = 1          # int8
    acc_bytes: int = 4          # int32
    out_bytes: int = 1          # int8
    uop_bytes_base: int = 4     # 32-bit uops by default

    # ------------------------------------------------------------------
    @property
    def batch(self) -> int:
        return 1 << self.log_batch

    @property
    def block_in(self) -> int:
        return 1 << self.log_block_in

    @property
    def block_out(self) -> int:
        return 1 << self.log_block_out

    @property
    def macs(self) -> int:
        return self.batch * self.block_in * self.block_out

    # scratchpad geometry: depth = entries of one tensor tile
    @property
    def inp_tile_bytes(self) -> int:
        return self.batch * self.block_in * self.inp_bytes

    @property
    def wgt_tile_bytes(self) -> int:
        return self.block_out * self.block_in * self.wgt_bytes

    @property
    def acc_tile_bytes(self) -> int:
        return self.batch * self.block_out * self.acc_bytes

    @property
    def out_tile_bytes(self) -> int:
        return self.batch * self.block_out * self.out_bytes

    @property
    def inp_depth(self) -> int:
        return (1 << self.log_inp_buff) // self.inp_tile_bytes

    @property
    def wgt_depth(self) -> int:
        return (1 << self.log_wgt_buff) // self.wgt_tile_bytes

    @property
    def acc_depth(self) -> int:
        return (1 << self.log_acc_buff) // self.acc_tile_bytes

    @property
    def uop_depth(self) -> int:
        return (1 << self.log_uop_buff) // self.uop_bytes

    # element capacities for TPS (paper Appendix A capacities)
    @property
    def inp_elems(self) -> int:
        return (1 << self.log_inp_buff) // self.inp_bytes

    @property
    def wgt_elems(self) -> int:
        return (1 << self.log_wgt_buff) // self.wgt_bytes

    @property
    def acc_elems(self) -> int:
        return (1 << self.log_acc_buff) // self.acc_bytes

    # ------------------------------------------------------------------
    # address field widths (bits); drive uop width + insn validation
    @property
    def inp_addr_bits(self) -> int:
        return max(1, math.ceil(math.log2(max(2, self.inp_depth))))

    @property
    def wgt_addr_bits(self) -> int:
        return max(1, math.ceil(math.log2(max(2, self.wgt_depth))))

    @property
    def acc_addr_bits(self) -> int:
        return max(1, math.ceil(math.log2(max(2, self.acc_depth))))

    @property
    def uop_bits_needed(self) -> int:
        return self.acc_addr_bits + self.inp_addr_bits + self.wgt_addr_bits

    @property
    def uop_bytes(self) -> int:
        """32-bit uops when fields fit, else 64-bit (paper: wider uops)."""
        return 4 if self.uop_bits_needed <= 32 else 8

    # ------------------------------------------------------------------
    # Config projections (staged DSE caching).  Every dataclass field is
    # claimed by exactly one projection — enforced by tests — so a new
    # field cannot silently leak a scheduling input into a cost-only key.
    #
    #   schedule_key: everything scheduling / lowering / encoding reads
    #     (block shapes, scratchpad geometry, ISA field widths via the
    #     data-element widths).  Two configs with equal schedule_key
    #     produce byte-identical programs for the same workload.
    #   cost_key: everything only the cycle/area models read (bus width,
    #     initiation intervals, pipeline depth, DRAM latency, VME depth).
    SCHEDULE_FIELDS = (
        "log_batch", "log_block_in", "log_block_out",
        "log_inp_buff", "log_wgt_buff", "log_acc_buff", "log_uop_buff",
        "inp_bytes", "wgt_bytes", "acc_bytes", "out_bytes",
        "uop_bytes_base",
    )
    COST_FIELDS = (
        "mem_width_bytes", "gemm_ii", "alu_ii", "gemm_depth",
        "dram_latency", "max_inflight",
    )

    def schedule_key(self) -> tuple:
        """Projection of the config that scheduling depends on."""
        return tuple(getattr(self, f) for f in self.SCHEDULE_FIELDS)

    def cost_key(self) -> tuple:
        """Projection of the config that only costing depends on."""
        return tuple(getattr(self, f) for f in self.COST_FIELDS)

    def validate(self) -> list[str]:
        """Compile-time ISA constraint checks. Returns list of violations."""
        errs = []
        gemm_bits = gemm_field_bits(self)
        if gemm_bits > INSN_BITS:
            errs.append(f"GEMM insn needs {gemm_bits} bits > {INSN_BITS}")
        load_bits = load_field_bits(self)
        if load_bits > INSN_BITS:
            errs.append(f"LOAD insn needs {load_bits} bits > {INSN_BITS}")
        if self.mem_width_bytes not in (8, 16, 32, 64):
            errs.append(f"mem width {self.mem_width_bytes}B outside 8..64")
        for name in ("inp", "wgt", "acc"):
            if getattr(self, f"{name}_depth") < 2:
                errs.append(f"{name} scratchpad holds <2 tiles")
        return errs

    def to_json(self) -> str:
        return json.dumps({
            "TARGET": "repro-tsim",
            "LOG_BATCH": self.log_batch,
            "LOG_BLOCK_IN": self.log_block_in,
            "LOG_BLOCK_OUT": self.log_block_out,
            "LOG_INP_BUFF_SIZE": self.log_inp_buff,
            "LOG_WGT_BUFF_SIZE": self.log_wgt_buff,
            "LOG_ACC_BUFF_SIZE": self.log_acc_buff,
            "LOG_UOP_BUFF_SIZE": self.log_uop_buff,
            "MEM_WIDTH_BYTES": self.mem_width_bytes,
            "GEMM_II": self.gemm_ii,
            "ALU_II": self.alu_ii,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "VTAConfig":
        d = json.loads(s)
        return VTAConfig(
            log_batch=d["LOG_BATCH"], log_block_in=d["LOG_BLOCK_IN"],
            log_block_out=d["LOG_BLOCK_OUT"], log_inp_buff=d["LOG_INP_BUFF_SIZE"],
            log_wgt_buff=d["LOG_WGT_BUFF_SIZE"], log_acc_buff=d["LOG_ACC_BUFF_SIZE"],
            log_uop_buff=d["LOG_UOP_BUFF_SIZE"],
            mem_width_bytes=d.get("MEM_WIDTH_BYTES", 8),
            gemm_ii=d.get("GEMM_II", 4), alu_ii=d.get("ALU_II", 4))


DEFAULT_VTA = VTAConfig()                       # 1x16x16, 64-bit bus, unpipelined
PIPELINED_VTA = VTAConfig(gemm_ii=1, alu_ii=2)  # after paper §IV.A.1-2


# ---------------------------------------------------------------------------
# Field-width accounting (for the 128-bit constraint checks)
# ---------------------------------------------------------------------------
LOOP_BITS = 14          # GEMM/ALU outer-loop extents (lp0, lp1)
FACTOR_BITS = 11        # per-loop index increments
DRAM_ADDR_BITS = 32
SIZE_BITS = 16
STRIDE_BITS = 16
PAD_BITS = 4


def gemm_field_bits(hw: VTAConfig) -> int:
    # opcode(3) + 4 dep bits + uop_bgn/uop_end + 2 loop extents
    # + 2*(acc,inp,wgt) per-loop factors
    uop_addr = max(1, math.ceil(math.log2(max(2, hw.uop_depth))))
    return (3 + 4 + 2 * uop_addr + 2 * LOOP_BITS
            + 2 * (hw.acc_addr_bits + hw.inp_addr_bits + hw.wgt_addr_bits))


def load_field_bits(hw: VTAConfig) -> int:
    sram_addr = max(hw.inp_addr_bits, hw.wgt_addr_bits, hw.acc_addr_bits)
    return (3 + 4 + 3 + sram_addr + DRAM_ADDR_BITS + 2 * SIZE_BITS
            + STRIDE_BITS + 3 * PAD_BITS + 1)  # +1: pad-value select (NEW)


# ---------------------------------------------------------------------------
# Instructions (runtime-level descriptors; encode() packs/validates fields)
# ---------------------------------------------------------------------------
@dataclass
class Insn:
    op: Op
    # dependency token bits (paper Fig 1): q in {load, compute, store}
    pop_prev: bool = False
    pop_next: bool = False
    push_prev: bool = False
    push_next: bool = False

    @property
    def queue(self) -> str:
        if self.op == Op.LOAD:
            return "load"
        if self.op == Op.STORE:
            return "store"
        return "compute"


@dataclass
class LoadInsn(Insn):
    buffer: Buffer = Buffer.INP
    sram_base: int = 0
    dram_base: int = 0
    y_size: int = 1          # rows
    x_size: int = 1          # tiles per row
    x_stride: int = 1
    y_pad0: int = 0
    y_pad1: int = 0
    x_pad0: int = 0
    x_pad1: int = 0
    pad_value: int = 0       # NEW: 0 or INT8_MIN (max-pool)
    stream: bool = False     # NEW: ACC data load issued via the LD engine
                             # (load queue) so it double-buffers against the
                             # ALU; UOP and mid-stream ACC loads stay on the
                             # compute queue as on classic VTA

    def tiles(self) -> int:
        return (self.y_size + self.y_pad0 + self.y_pad1) * \
               (self.x_size + self.x_pad0 + self.x_pad1)

    def dram_tiles(self) -> int:
        return self.y_size * self.x_size


@dataclass
class StoreInsn(Insn):
    """Narrow acc -> int8 and write out.

    ``buffer`` selects the destination (NEW, graph compiler): ``Buffer.OUT``
    is the classic DRAM store; ``Buffer.INP`` spills the narrowed tile into
    the *input scratchpad* instead — the on-chip bypass that lets the next
    layer's GEMM consume this layer's output without a DRAM round trip.
    For INP spills ``dram_base`` carries the destination INP sram address.
    """
    sram_base: int = 0
    dram_base: int = 0
    y_size: int = 1
    x_size: int = 1
    x_stride: int = 1
    buffer: Buffer = Buffer.OUT

    @property
    def on_chip(self) -> bool:
        return self.buffer != Buffer.OUT

    def tiles(self) -> int:
        return self.y_size * self.x_size


@dataclass
class GemmInsn(Insn):
    uop_bgn: int = 0
    uop_end: int = 1
    lp0: int = 1
    lp1: int = 1
    acc_f0: int = 0
    acc_f1: int = 0
    inp_f0: int = 0
    inp_f1: int = 0
    wgt_f0: int = 0
    wgt_f1: int = 0
    reset: bool = False

    def iterations(self) -> int:
        return self.lp0 * self.lp1 * (self.uop_end - self.uop_bgn)


@dataclass
class AluInsn(Insn):
    alu_op: AluOp = AluOp.ADD
    uop_bgn: int = 0
    uop_end: int = 1
    lp0: int = 1
    lp1: int = 1
    dst_f0: int = 0
    dst_f1: int = 0
    src_f0: int = 0
    src_f1: int = 0
    use_imm: bool = False
    imm: int = 0
    imm2: int = 0            # CLIP: [imm, imm2] bounds
    overwrite: bool = False  # NEW (macro-op): write-through, dst not read

    def iterations(self) -> int:
        return self.lp0 * self.lp1 * (self.uop_end - self.uop_bgn)

    @property
    def two_operand(self) -> bool:
        return not self.use_imm

    def acc_reads(self, latched: bool = True) -> int:
        """Accumulator-RF reads per iteration (drives the tsim II model).

        ``latched``: a MAC's src2 is loop-invariant across the lp0 x lp1
        sweep, so the pipelined unit reads it once per uop and holds it in an
        operand latch; the unpipelined unit re-reads it every iteration.
        """
        n = 0 if self.overwrite else 1              # dst read-modify-write
        if self.alu_op == AluOp.MAC:
            n += 1 + (0 if latched else 1)          # src1 + (latched) src2
        elif not self.use_imm:
            n += 1                                  # src
        return n


@dataclass
class FinishInsn(Insn):
    op: Op = Op.FINISH


@dataclass(frozen=True)
class Uop:
    acc_idx: int
    inp_idx: int
    wgt_idx: int

    def encode(self, hw: VTAConfig) -> int:
        a, i, w = hw.acc_addr_bits, hw.inp_addr_bits, hw.wgt_addr_bits
        assert 0 <= self.acc_idx < (1 << a), (self.acc_idx, a)
        assert 0 <= self.inp_idx < (1 << i), (self.inp_idx, i)
        assert 0 <= self.wgt_idx < (1 << w), (self.wgt_idx, w)
        return self.acc_idx | (self.inp_idx << a) | (self.wgt_idx << (a + i))


def encode_insn(insn: Insn, hw: VTAConfig) -> int:
    """Pack an instruction to its 128-bit word, asserting field ranges.

    This is the machine-level fidelity check: schedules that address beyond a
    configuration's scratchpad depth fail here, exactly like a mis-configured
    runtime would on real VTA.
    """
    word = int(insn.op) | (insn.pop_prev << 3) | (insn.pop_next << 4) \
        | (insn.push_prev << 5) | (insn.push_next << 6)
    bit = 7

    def put(val: int, width: int, what: str):
        nonlocal word, bit
        assert 0 <= val < (1 << width), f"{what}={val} exceeds {width} bits"
        word |= val << bit
        bit += width

    if isinstance(insn, LoadInsn):
        depth = {Buffer.INP: hw.inp_depth, Buffer.WGT: hw.wgt_depth,
                 Buffer.ACC: hw.acc_depth, Buffer.UOP: hw.uop_depth,
                 Buffer.OUT: hw.acc_depth}[insn.buffer]
        put(int(insn.buffer), 3, "buffer")
        put(insn.sram_base, max(1, math.ceil(math.log2(max(2, depth)))), "sram_base")
        put(insn.dram_base, DRAM_ADDR_BITS, "dram_base")
        put(insn.y_size, SIZE_BITS, "y_size")
        put(insn.x_size, SIZE_BITS, "x_size")
        put(insn.x_stride, STRIDE_BITS, "x_stride")
        for f in ("y_pad0", "y_pad1", "x_pad0", "x_pad1"):
            put(getattr(insn, f), PAD_BITS, f)
        put(1 if insn.pad_value else 0, 1, "pad_value")
    elif isinstance(insn, StoreInsn):
        put(int(insn.buffer), 3, "buffer")
        put(insn.sram_base, hw.acc_addr_bits, "sram_base")
        put(insn.dram_base, DRAM_ADDR_BITS, "dram_base")
        put(insn.y_size, SIZE_BITS, "y_size")
        put(insn.x_size, SIZE_BITS, "x_size")
        put(insn.x_stride, STRIDE_BITS, "x_stride")
    elif isinstance(insn, GemmInsn):
        uop_addr = max(1, math.ceil(math.log2(max(2, hw.uop_depth))))
        put(insn.reset, 1, "reset")
        put(insn.uop_bgn, uop_addr, "uop_bgn")
        put(insn.uop_end, uop_addr + 1, "uop_end")
        put(insn.lp0, LOOP_BITS, "lp0")
        put(insn.lp1, LOOP_BITS, "lp1")
        for f, w in (("acc_f0", hw.acc_addr_bits), ("acc_f1", hw.acc_addr_bits),
                     ("inp_f0", hw.inp_addr_bits), ("inp_f1", hw.inp_addr_bits),
                     ("wgt_f0", hw.wgt_addr_bits), ("wgt_f1", hw.wgt_addr_bits)):
            put(getattr(insn, f), w, f)
    elif isinstance(insn, AluInsn):
        uop_addr = max(1, math.ceil(math.log2(max(2, hw.uop_depth))))
        put(int(insn.alu_op), 3, "alu_op")
        put(insn.uop_bgn, uop_addr, "uop_bgn")
        put(insn.uop_end, uop_addr + 1, "uop_end")
        put(insn.lp0, LOOP_BITS, "lp0")
        put(insn.lp1, LOOP_BITS, "lp1")
        for f in ("dst_f0", "dst_f1", "src_f0", "src_f1"):
            put(getattr(insn, f), hw.acc_addr_bits, f)
        put(1 if insn.use_imm else 0, 1, "use_imm")
        put(insn.imm & 0xFFFF, 16, "imm")
        put(1 if insn.overwrite else 0, 1, "overwrite")
    elif isinstance(insn, FinishInsn):
        pass
    assert bit <= INSN_BITS, f"{type(insn).__name__} needs {bit} bits > {INSN_BITS}"
    return word
