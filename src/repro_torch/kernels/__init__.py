"""Custom-kernel layer of the port: the registry plus the hand-written CUDA
kernels (``csrc/``) behind it, and the float layer ops behind ``ops.py``,
each kernel with its plain PyTorch version.

Every kernel wrapper counts its CUDA launches (and nothing else);
``launch_counts`` reads the counters and ``reset_launch_counts`` zeroes
them, so a run can show it went through the kernels.
"""
from repro_torch.kernels.registry import (available_impls, get_kernel,
                                          register_kernel)

__all__ = ["available_impls", "get_kernel", "register_kernel",
           "launch_counts", "reset_launch_counts", "add_launch_counts"]


def _counters() -> tuple:
    from repro_torch.kernels import (alu, alu_sweep, depthwise,
                                     flash_attention, gemm, pool2d, vta_gemm)
    return (vta_gemm.LAUNCHES, alu_sweep.LAUNCHES, gemm.LAUNCHES,
            alu.LAUNCHES, depthwise.LAUNCHES, pool2d.LAUNCHES,
            flash_attention.LAUNCHES)


def launch_counts() -> dict:
    """{kernel name: CUDA launches since the last reset}."""
    out: dict = {}
    for c in _counters():
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _counters():
        for k in c:
            c[k] = 0


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` ({kernel name: launches}) to the counters: a replayed
    CUDA graph runs the launches its capture recorded without calling the
    wrappers, so the executor adds them for it."""
    for c in _counters():
        for k in c:
            c[k] += delta.get(k, 0)
