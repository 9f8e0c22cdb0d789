"""Functional simulator — bit-accurate behavioural model of the VTA machine
(paper's `fsim` role: the simple reference the RTL/tsim targets are debugged
against, §III.C / §IV.G).

The numpy execution backend: ``FSim`` lowers a Program to the typed
tensor-op trace (vta/lowering.py) and executes the trace in program order
against numpy scratchpads:
    inp (depth, BV, BI) i8 | wgt (depth, BO, BI) i8 | acc (depth, BV, BO) i32

All meta-dict interpretation (DRAM slices, padding, residual widen-loads,
on-chip spills) happens in the lowering pass; this module only applies the
resulting gather/scatter index maps and compute ops, so any backend that
consumes the same trace — e.g. the JIT-compiled batched JAX executor in
vta/fsim_jax.py — is bit-for-bit comparable. A trace hook records
per-instruction state digests for divergence debugging (vta/trace.py).

Multi-tensor DRAM (graph compiler): ``dram`` maps tensor names to arrays.
Metas may carry ``tensor`` naming the array a load reads / a store writes;
without it the classic single-layer defaults apply ("inp"/"wgt"/"bias"/
"dw_wgt"/"out"), so per-layer programs run unchanged. Fused segment programs
name every edge tensor explicitly, which is what lets a conv→add→clip
segment (or a resident two-layer chain) be verified bit-exactly end to end.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.vta.isa import AluOp, Buffer, VTAConfig
from repro_torch.vta.lowering import (F32_EXACT_TERMS, AluSweep,
                                      GatherLoad, GemmOp, ScatterStore,
                                      SpillStore, Trace, UopLoad, _alu_steps,
                                      lower)
from repro_torch.vta.runtime import Program


class FSim:
    def __init__(self, hw: VTAConfig, dram: dict):
        """dram: {"inp": (B,FI,H,W) i8, "wgt": (FO,FI,KH,KW) i8,
                  "bias": (FO,) i32, "out": (B,FO,OH,OW) i8 (written),
                  "dw_wgt": (C,KH,KW) i8}"""
        self.hw = hw
        self.dram = dram
        self.inp = np.zeros((hw.inp_depth, hw.batch, hw.block_in), np.int8)
        self.wgt = np.zeros((hw.wgt_depth, hw.block_out, hw.block_in), np.int8)
        self.acc = np.zeros((hw.acc_depth, hw.batch, hw.block_out), np.int32)
        self.uop = np.zeros((hw.uop_depth, 3), np.int64)
        self.trace_hook: Optional[Callable] = None

    # ------------------------------------------------------------------
    def run(self, prog: Program, trace: Optional[Trace] = None):
        """Execute ``prog``. A pre-lowered ``trace`` may be passed so batched
        runs (same program, many images) lower once."""
        if trace is None:
            trace = lower(prog, self.hw,
                          {k: np.asarray(v).shape for k, v in self.dram.items()})
        for step, (insn, op) in enumerate(zip(trace.insns, trace.ops)):
            if op is not None:
                self._exec(op)
            if self.trace_hook is not None:
                self.trace_hook(step, insn, self)

    # ------------------------------------------------------------------
    def _buf(self, buffer: Buffer) -> np.ndarray:
        return {Buffer.INP: self.inp, Buffer.WGT: self.wgt,
                Buffer.ACC: self.acc}[buffer]

    def _exec(self, op):
        if isinstance(op, GatherLoad):
            src = self.dram[op.tensor].reshape(-1)[op.index]
            if op.mask is not None:
                src = np.where(op.mask, src, op.fill)
            buf = self._buf(op.buffer)
            buf[op.base:op.base + len(op.index)] = src
        elif isinstance(op, GemmOp):
            if op.reset:
                self.acc[op.acc_idx] = 0
                return
            prod = np.einsum("nbi,noi->nbo",
                             self.inp[op.inp_idx].astype(np.int32),
                             self.wgt[op.wgt_idx].astype(np.int32))
            np.add.at(self.acc, op.acc_idx, prod)
        elif isinstance(op, AluSweep):
            self._alu(op)
        elif isinstance(op, ScatterStore):
            vals = np.clip(self.acc[op.base:op.base + len(op.index)],
                           -128, 127).astype(np.int8)
            out = self.dram[op.tensor]
            if op.mask is not None:
                np.put(out, op.index[op.mask], vals[op.mask])
            else:
                np.put(out, op.index, vals)
        elif isinstance(op, SpillStore):
            # BI == BO is a compiler precondition for spills, so narrowed
            # (BV, BO) acc tiles are (BV, BI) input tiles
            self.inp[op.dst] = np.clip(self.acc[op.src], -128, 127) \
                .astype(np.int8)
        elif isinstance(op, UopLoad):
            self.uop[op.base:op.base + len(op.values)] = op.values
        else:
            raise TypeError(type(op))

    def _alu(self, op):
        """Steps execute *in sequence* (each vectorized over the sweep grid),
        because batched uop vectors may chain through a shared destination —
        e.g. the depthwise MAC accumulation, where every tap's uop reads and
        updates the same output tile. Accepts a raw ``AluInsn`` too (lowered
        against the live uop buffer) for single-insn unit testing."""
        if not isinstance(op, AluSweep):
            insn = op
            op = AluSweep(step=-1, alu_op=insn.alu_op, use_imm=insn.use_imm,
                          imm=insn.imm, overwrite=insn.overwrite,
                          steps=_alu_steps(insn,
                                           self.uop[insn.uop_bgn:insn.uop_end]))
        for st in op.steps:
            dst_i = st.dst
            if op.alu_op == AluOp.MAC:
                # src2: loop-invariant latched acc entry (uop 3rd field)
                prod = self.acc[st.src] * self.acc[st.src2][None]
                r = prod if op.overwrite else self.acc[dst_i] + prod
                self.acc[dst_i] = r
                continue
            src = np.int32(op.imm) if op.use_imm else self.acc[st.src]
            if op.overwrite:
                # write-through: dst <- src/imm (op applied to its identity)
                self.acc[dst_i] = np.broadcast_to(src, self.acc[dst_i].shape)
                continue
            dst = self.acc[dst_i]
            if op.alu_op == AluOp.ADD:
                r = dst + src
            elif op.alu_op == AluOp.MAX:
                r = np.maximum(dst, src)
            elif op.alu_op == AluOp.MIN:
                r = np.minimum(dst, src)
            elif op.alu_op == AluOp.SHR:
                r = dst >> src
            elif op.alu_op == AluOp.MUL:
                r = dst * src
            elif op.alu_op == AluOp.CLIP:
                bound = abs(int(op.imm))
                r = np.clip(dst, -bound, bound)
            else:
                raise ValueError(op.alu_op)
            self.acc[dst_i] = r


# ---------------------------------------------------------------------------
# numpy oracles (reference semantics the machine is validated against)
# ---------------------------------------------------------------------------
def conv2d_ref(inp: np.ndarray, wgt: np.ndarray, stride=(1, 1), pad=(0, 0),
               bias: Optional[np.ndarray] = None) -> np.ndarray:
    """int8 conv -> int32 acc. inp (B,FI,H,W), wgt (FO,FI,KH,KW).

    im2col + one blocked sgemm: int8 values are exact in f32, and block
    sums of <= F32_EXACT_TERMS products stay below 2^24, so accumulating
    exact f32 blocks in int32 is bit-identical to pure int32 math while
    running at BLAS speed.
    """
    B, FI, H, W = inp.shape
    FO, _, KH, KW = wgt.shape
    sh, sw = stride
    ph, pw = pad
    x = np.pad(inp.astype(np.float32), ((0, 0), (0, 0), (ph, ph), (pw, pw)))
    OH = (H + 2 * ph - KH) // sh + 1
    OW = (W + 2 * pw - KW) // sw + 1
    K = FI * KH * KW
    cols = np.empty((B, OH, OW, FI, KH, KW), np.float32)
    for dy in range(KH):
        for dx in range(KW):
            cols[:, :, :, :, dy, dx] = \
                x[:, :, dy:dy + sh * OH:sh, dx:dx + sw * OW:sw] \
                .transpose(0, 2, 3, 1)
    cols = cols.reshape(B * OH * OW, K)
    w2 = wgt.reshape(FO, K).T.astype(np.float32)          # (K, FO)
    out = np.zeros((B * OH * OW, FO), np.int32)
    for k0 in range(0, K, F32_EXACT_TERMS):
        k1 = k0 + F32_EXACT_TERMS
        out += (cols[:, k0:k1] @ w2[k0:k1]).astype(np.int32)
    out = out.reshape(B, OH, OW, FO).transpose(0, 3, 1, 2)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def depthwise_ref(inp, wgt, stride=(1, 1), pad=(0, 0)):
    """inp (B,C,H,W) i8; wgt (C,KH,KW) i8 -> i32."""
    B, C, H, W = inp.shape
    _, KH, KW = wgt.shape
    sh, sw = stride
    ph, pw = pad
    x = np.pad(inp.astype(np.int32), ((0, 0), (0, 0), (ph, ph), (pw, pw)))
    OH = (H + 2 * ph - KH) // sh + 1
    OW = (W + 2 * pw - KW) // sw + 1
    out = np.zeros((B, C, OH, OW), np.int32)
    for dy in range(KH):
        for dx in range(KW):
            out += x[:, :, dy:dy + sh * OH:sh, dx:dx + sw * OW:sw] \
                * wgt[:, dy, dx].astype(np.int32)[None, :, None, None]
    return out


def pool_ref(inp, k, stride, pad, mode="max"):
    B, C, H, W = inp.shape
    kh, kw = k
    sh, sw = stride
    ph, pw = pad
    fill = -128 if mode == "max" else 0
    x = np.full((B, C, H + 2 * ph, W + 2 * pw), fill, np.int32)
    x[:, :, ph:ph + H, pw:pw + W] = inp.astype(np.int32)
    OH = (H + 2 * ph - kh) // sh + 1
    OW = (W + 2 * pw - kw) // sw + 1
    taps = [x[:, :, dy:dy + sh * OH:sh, dx:dx + sw * OW:sw]
            for dy in range(kh) for dx in range(kw)]
    stacked = np.stack(taps)
    if mode == "max":
        return stacked.max(0)
    return stacked.sum(0) >> max(0, int(round(np.log2(kh * kw))))


def post_op_ref(acc: np.ndarray, post_op: str) -> np.ndarray:
    if post_op == "none":
        r = acc
    elif post_op == "relu":
        r = np.maximum(acc, 0)
    elif post_op == "relu_shift":
        r = np.maximum(acc >> 8, 0)
    elif post_op in ("clip_shift", "clip_shift_legacy"):
        r = np.clip(acc >> 8, -127, 127)
    else:
        raise ValueError(post_op)
    return np.clip(r, -128, 127).astype(np.int8)
