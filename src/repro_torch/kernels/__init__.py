"""Custom-kernel layer of the port: the registry plus the hand-written CUDA
kernels (``csrc/``) behind it, and the float layer ops behind ``ops.py``,
each kernel with its plain PyTorch version.

Every kernel wrapper counts its CUDA launches (and nothing else) through
``count_launch``; ``launch_counts`` reads the counters and
``reset_launch_counts`` zeroes them, so a run can show it went through the
kernels. The counters are shared by every thread, under one lock. A thread
inside ``recording_launches`` (a CUDA-graph capture, which launches
nothing) counts into its own record instead, so another thread's launches
never enter it.
"""
import contextlib
import threading

from repro_torch.kernels.registry import (available_impls, get_kernel,
                                          register_kernel)

__all__ = ["available_impls", "get_kernel", "register_kernel",
           "launch_counts", "reset_launch_counts", "add_launch_counts",
           "count_launch", "recording_launches"]

_LOCK = threading.Lock()
_RECORD = threading.local()


def _counters() -> tuple:
    from repro_torch.kernels import (alu, alu_sweep, depthwise,
                                     flash_attention, gemm, pool2d, vta_gemm)
    return (vta_gemm.LAUNCHES, alu_sweep.LAUNCHES, gemm.LAUNCHES,
            alu.LAUNCHES, depthwise.LAUNCHES, pool2d.LAUNCHES,
            flash_attention.LAUNCHES)


def launch_counts() -> dict:
    """{kernel name: CUDA launches since the last reset}."""
    out: dict = {}
    with _LOCK:
        for c in _counters():
            out.update(c)
    return out


def reset_launch_counts() -> None:
    with _LOCK:
        for c in _counters():
            for k in c:
                c[k] = 0


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` ({kernel name: launches}) to the counters: a replayed
    CUDA graph runs the launches its capture recorded without calling the
    wrappers, so the executor adds them for it."""
    with _LOCK:
        for c in _counters():
            for k in c:
                c[k] += delta.get(k, 0)


def count_launch(counters: dict, key: str) -> None:
    """One launch of kernel ``key`` (a key of the wrapper's ``counters``):
    into the calling thread's record inside ``recording_launches``, else
    into the shared counters."""
    record = getattr(_RECORD, "launches", None)
    if record is not None:
        record[key] = record.get(key, 0) + 1
        return
    with _LOCK:
        counters[key] += 1


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's ``count_launch`` calls go to the
    yielded dict ({kernel name: launches}) and not to the counters: what a
    graph capture records, for its replays to add."""
    prev = getattr(_RECORD, "launches", None)
    _RECORD.launches = record = {}
    try:
        yield record
    finally:
        _RECORD.launches = prev
