"""Per-instruction state-digest recorder + first-divergence differ.

The paper's dynamic trace-based divergence debugging methodology (§IV.G):
when two executions of one Program disagree — numpy fsim vs the PyTorch
backend, or a candidate schedule vs a known-good one — comparing final
outputs only says *that* they diverged. This module records a digest of
every scratchpad after every instruction and bisects to the *first*
instruction whose architectural state differs, which is almost always the
instruction carrying the bug.

Usage (what the backend-equivalence tests do on failure):

    a = record_trace(prog, hw, dram_a)                  # numpy FSim
    b = record_trace(prog, hw, dram_b, backend="torch") # stepped, the card
    d = first_divergence(a, b)
    if d is not None:
        print(d.describe())      # step, instruction, diverging buffers

Digests are sha1 over the raw scratchpad bytes (inp / wgt / acc / uop), so
two recordings are comparable across backends as long as both expose the
same numpy-shaped state (``TorchBackend.run_stepped`` does).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.vta.isa import VTAConfig
from repro_torch.vta.runtime import Program

BUFFERS = ("inp", "wgt", "acc", "uop")


@dataclass
class StepDigest:
    step: int
    insn: str                        # type name of the instruction
    digests: dict                    # buffer -> sha1 hex


@dataclass
class Divergence:
    step: int
    insn: str
    buffers: tuple                   # buffer names that differ at `step`
    # the fused kernel the fast path executes this step inside, when
    # any: ("aluchain", lo, hi) | ("segment", lo, hi). Stepped recording
    # runs per-op, so the digests localize to one instruction even when the
    # fast path would run it fused; this field maps the instruction back to
    # the kernel to inspect (lowering.enclosing_kernel).
    kernel: Optional[tuple] = None

    def describe(self) -> str:
        msg = (f"first divergence at insn {self.step} ({self.insn}): "
               f"{', '.join(self.buffers)} scratchpad state differs")
        if self.kernel is not None:
            kind, lo, hi = self.kernel
            msg += (f"; inside fused {kind} kernel covering insns "
                    f"[{lo}, {hi}]")
        return msg


class TraceRecorder:
    """Hook object for ``FSim.trace_hook`` / ``TorchBackend.run_stepped``."""

    def __init__(self, buffers=BUFFERS):
        self.buffers = buffers
        self.steps: list = []

    def __call__(self, step: int, insn, sim) -> None:
        digests = {}
        for b in self.buffers:
            arr = np.ascontiguousarray(getattr(sim, b))
            digests[b] = hashlib.sha1(arr.tobytes()).hexdigest()
        self.steps.append(StepDigest(step=step, insn=type(insn).__name__,
                                     digests=digests))


def record_trace(prog: Program, hw: VTAConfig, dram: dict,
                 backend: str = "numpy", buffers=BUFFERS) -> list:
    """Execute ``prog`` over ``dram`` recording per-instruction digests.

    ``backend="numpy"`` runs the reference FSim with a trace hook;
    ``"torch"`` (the card) and ``"torch-cpu"`` run that backend's eager
    stepped mode. All write the program's outputs into ``dram`` as a normal
    run would.
    """
    rec = TraceRecorder(buffers)
    if backend == "numpy":
        from repro_torch.vta.fsim import FSim
        sim = FSim(hw, dram)
        sim.trace_hook = rec
        sim.run(prog)
    elif backend in ("torch", "torch-cpu"):
        from repro_torch.vta.backend import get_backend
        get_backend(backend).run_stepped(prog, hw, dram, rec)
    else:
        raise KeyError(f"record_trace supports numpy|torch|torch-cpu, not "
                       f"{backend!r}")
    return rec.steps


def first_divergence(a: list, b: list) -> Optional[Divergence]:
    """First step whose digests differ between two recordings (None when
    bit-identical). A length mismatch counts as divergence at the first
    missing step."""
    for sa, sb in zip(a, b):
        bad = tuple(name for name in sa.digests
                    if name in sb.digests
                    and sa.digests[name] != sb.digests[name])
        if bad:
            return Divergence(step=sa.step, insn=sa.insn, buffers=bad)
    if len(a) != len(b):
        n = min(len(a), len(b))
        longer = a if len(a) > len(b) else b
        return Divergence(step=longer[n].step, insn=longer[n].insn,
                          buffers=("<missing steps>",))
    return None


@dataclass
class TraceDiff:
    """Convenience wrapper: run both backends on copies of one dram image
    and report outputs + localization in one object."""
    divergence: Optional[Divergence]
    outputs_equal: bool
    steps: int = 0
    detail: dict = field(default_factory=dict)


def diff_backends(prog: Program, hw: VTAConfig, dram: dict,
                  backends=("numpy", "torch")) -> TraceDiff:
    """Run ``prog`` under two backends on identical inputs (by default the
    numpy oracle against the card); compare outputs byte-for-byte and
    localize the first diverging instruction if any."""
    drams = [{k: np.array(v, copy=True) for k, v in dram.items()}
             for _ in backends]
    traces = [record_trace(prog, hw, d, backend=b)
              for d, b in zip(drams, backends)]
    div = first_divergence(traces[0], traces[1])
    if div is not None:
        from repro_torch.vta.lowering import enclosing_kernel, lower_cached
        shapes = {k: np.asarray(v).shape for k, v in dram.items()}
        div.kernel = enclosing_kernel(lower_cached(prog, hw, shapes),
                                      div.step)
    outputs_equal = all(np.array_equal(drams[0][k], drams[1][k])
                        for k in dram)
    return TraceDiff(divergence=div, outputs_equal=outputs_equal,
                     steps=len(traces[0]))
