"""Roofline model — both planes; the port of ``repro/core/roofline.py``.

VTA plane (paper Fig 2): Ops/Cycle vs Ops/Byte, compute bound = 2*MACs
ops/cycle, memory bound = mem_width_bytes/cycle * intensity. Copied
unchanged.

GPU plane: the three-term time roofline the dry-run analysis uses —
compute / HBM / collective terms per device; see analysis/roofline.py for
the pipeline. The constants are NVIDIA's data-sheet values for one H100 SXM
80GB HBM3 at its 700 W limit (dense, no sparsity), not measurements:
    989 TFLOP/s bf16 | 3.35 TB/s HBM | 450 GB/s a direction of NVLink per
    GPU inside one 8-GPU node; 50 GB/s (400 Gb/s NDR InfiniBand) per GPU
    once the mesh spans nodes.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.vta.isa import VTAConfig

# --- NVIDIA H100 SXM 80GB HBM3, 700 W: data-sheet constants ---
PEAK_FLOPS = 989e12            # dense bf16 FLOP/s per GPU
HBM_BW = 3.35e12               # bytes/s per GPU
NVLINK_BW = 450e9              # bytes/s a direction per GPU, inside a node
IB_BW = 50e9                   # bytes/s per GPU across nodes (400 Gb/s NDR)
GPUS_PER_NODE = 8


def collective_bw(n_devices: int) -> float:
    """Collective bandwidth per GPU of a mesh of ``n_devices``: NVLink when
    it fits one 8-GPU node, InfiniBand otherwise."""
    return NVLINK_BW if n_devices <= GPUS_PER_NODE else IB_BW


@dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Lower-bound step time (perfectly overlapped terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    def fraction_of_roofline(self) -> float:
        """compute_time / bound: 1.0 == tensor-core-limited with all else
        hidden."""
        return self.compute_s / max(self.bound_s, 1e-30)


def h100_terms(flops_per_device: float, hbm_bytes_per_device: float,
               coll_bytes_per_device: float, *,
               n_devices: int = 256) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=hbm_bytes_per_device / HBM_BW,
        collective_s=coll_bytes_per_device / collective_bw(n_devices),
    )


# --------------------------------------------------------------------------
# VTA roofline (paper Fig 2)
# --------------------------------------------------------------------------
def vta_bounds(hw: VTAConfig):
    """Returns (peak_ops_per_cycle, bytes_per_cycle)."""
    return 2.0 * hw.macs, float(hw.mem_width_bytes)


def vta_roofline_point(macs: int, cycles: int, dram_bytes: int) -> dict:
    ops = 2.0 * macs
    return {"ops_per_byte": ops / max(1, dram_bytes),
            "ops_per_cycle": ops / max(1, cycles)}


def vta_attainable(hw: VTAConfig, ops_per_byte: float) -> float:
    peak, bw = vta_bounds(hw)
    return min(peak, bw * ops_per_byte)
