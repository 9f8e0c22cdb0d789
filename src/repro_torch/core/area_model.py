"""Scaled-area model (paper §IV.F, Fig 13).

The paper reports *scaled* area (unitless, relative). Its qualitative claims:
  * scratchpad SRAM is the main area contributor;
  * scaled area spans ~an order of magnitude across the design space;
  * the big end (~4K MACs + large scratchpads + wide bus) costs ~12x the
    (pipelined) default.

We model area = c_mac * MACs + c_sram * scratchpad_bytes + c_bus * bus_bytes,
with coefficients in the ratio of int8-MAC logic to SRAM bits in a generic
process (MAC ~ 300 gate-equivalents, SRAM ~ 1.2 / byte, bus/VME ~ 2k per byte
of width). Absolute units are arbitrary; we always report area scaled to the
default configuration, as the paper does.
"""
from __future__ import annotations

from repro_torch.vta.isa import VTAConfig

C_MAC = 300.0          # per int8 MAC (multiplier + adder + pipe regs)
C_SRAM = 1.2           # per byte of scratchpad SRAM
C_BUS = 2000.0         # per byte/cycle of memory interface (VME, AXI, tags)
C_PIPE = 40.0          # per MAC extra pipeline registers when fully pipelined


def area_units(hw: VTAConfig) -> float:
    spad_bytes = ((1 << hw.log_inp_buff) + (1 << hw.log_wgt_buff)
                  + (1 << hw.log_acc_buff) + (1 << hw.log_uop_buff))
    a = C_MAC * hw.macs + C_SRAM * spad_bytes + C_BUS * hw.mem_width_bytes
    if hw.gemm_ii == 1:
        a += C_PIPE * hw.macs          # "minimal area increase" (§IV.A)
    return a


def scaled_area(hw: VTAConfig, reference: VTAConfig) -> float:
    return area_units(hw) / area_units(reference)


def area_breakdown(hw: VTAConfig) -> dict:
    spad_bytes = ((1 << hw.log_inp_buff) + (1 << hw.log_wgt_buff)
                  + (1 << hw.log_acc_buff) + (1 << hw.log_uop_buff))
    return {
        "mac": C_MAC * hw.macs + (C_PIPE * hw.macs if hw.gemm_ii == 1 else 0.0),
        "sram": C_SRAM * spad_bytes,
        "bus": C_BUS * hw.mem_width_bytes,
        "total": area_units(hw),
    }
