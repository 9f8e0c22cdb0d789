"""Execution-backend protocol + registry of the port.

A *backend* executes the typed trace ``vta/lowering.py`` produces from a
Program. Built-ins:

  * ``"numpy"``     — the reference ``FSim`` (vta/fsim.py, a copy of the JAX
    package's): per image, in place, program order. The oracle; its
    ``run_batched`` returns CPU tensors, as the protocol below asks.
  * ``"torch"``     — ``TorchBackend()`` (vta/fsim_torch.py) on the CUDA
    device, compute through the hand-written kernels. Raises where there is
    no CUDA device: the card path never falls back to the CPU.
  * ``"torch-cpu"`` — ``TorchBackend(device="cpu")``: the same executor with
    the kernels' plain PyTorch versions, used only when asked for. It is a
    rung only of ``DEGRADATION_LADDER`` (``torch -> torch-cpu -> numpy``,
    serve/breaker.py), on the way down from the card, never a fallback
    that hides it.

The reference for both is the numpy ``FSim``; the port's tests hold them to
it, and the port's copy to the JAX package's, bit for bit.

``run_batched``'s contract: ``batched`` maps tensor names to ``(N, ...)``
stacks (numpy arrays or tensors), ``shared`` maps names to single arrays
every image reuses (weights, biases); the return value maps every tensor the
program stores to its ``(N, ...)`` result as a tensor on the backend's
device.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Protocol, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.vta.isa import VTAConfig
from repro_torch.vta.lowering import lower_cached
from repro_torch.vta.runtime import Program


_LOWER_LOCK = threading.Lock()


def lowered(prog: Program, hw: VTAConfig, shapes: dict):
    """``lower_cached`` under one lock: serving workers that dispatch the
    same Program at once get the same Trace, whose executor memos (index
    maps, captured plans) then serve them both."""
    with _LOWER_LOCK:
        return lower_cached(prog, hw, shapes)


@runtime_checkable
class Backend(Protocol):
    name: str

    def run(self, prog: Program, hw: VTAConfig, dram: dict) -> None:
        """Execute one image in place: stored tensors in ``dram`` are
        overwritten with the program's outputs."""
        ...

    def run_batched(self, prog: Program, hw: VTAConfig, *, shared: dict,
                    batched: dict) -> dict:
        """Execute N images; returns {stored tensor name: (N, ...) tensor}."""
        ...


class NumpyBackend:
    """The trace-executing ``FSim``, image by image: ``run_batched`` lowers
    once and reuses the trace across the batch (the JAX package's
    ``NumpyBackend``, returning tensors)."""

    name = "numpy"
    device = torch.device("cpu")

    def run(self, prog: Program, hw: VTAConfig, dram: dict) -> None:
        from repro_torch.vta.fsim import FSim
        shapes = {k: np.asarray(v).shape for k, v in dram.items()}
        FSim(hw, dram).run(prog, trace=lowered(prog, hw, shapes))

    def run_batched(self, prog: Program, hw: VTAConfig, *, shared: dict,
                    batched: dict) -> dict:
        from repro_torch.vta.fsim import FSim
        shared = {k: np.asarray(v) for k, v in shared.items()}
        batched = {k: np.asarray(v) for k, v in batched.items()}
        n = next(iter(batched.values())).shape[0]
        shapes = {k: v.shape for k, v in shared.items()}
        shapes.update({k: v.shape[1:] for k, v in batched.items()})
        trace = lowered(prog, hw, shapes)
        outs: dict = {t: [] for t in trace.tensors_written}
        for i in range(n):
            dram = dict(shared)
            # fresh copies: the caller's (N, ...) stacks stay untouched
            dram.update({k: np.array(v[i]) for k, v in batched.items()})
            FSim(hw, dram).run(prog, trace=trace)
            for t in outs:
                outs[t].append(dram[t])
        return {t: torch.from_numpy(np.stack(v)) for t, v in outs.items()}


class CardFault(Exception):
    """A fault of the card (a kernel that does not build or launch, a CUDA
    error) met while a program ran there for a caller that would otherwise
    read the failure as a result: the autotuner's verification
    (vta/autotune.py) and the design-space sweep above it (core/dse.py).
    Deliberately not a ``RuntimeError``, ``AssertionError`` or
    ``ValueError``: the handlers that turn those into an infeasible design
    point or an untuned layer cannot catch it."""


def on_card(backend: Union[str, "Backend", None]) -> bool:
    """Whether the resolved backend runs on a CUDA device."""
    dev = getattr(get_backend(backend), "device", None)
    return dev is not None and torch.device(dev).type == "cuda"


_FACTORIES: Dict[str, Callable[[], Backend]] = {}
_INSTANCES: Dict[str, Backend] = {}


def register_backend(name: str, factory: Callable[[], Backend], *,
                     replace: bool = False) -> None:
    if not replace and name in _FACTORIES:
        raise ValueError(f"backend {name!r} already registered")
    _FACTORIES[name] = factory
    _INSTANCES.pop(name, None)


def available_backends() -> list:
    return sorted(_FACTORIES)


def get_backend(backend: Union[str, Backend, None]) -> Backend:
    """Resolve a backend name (or pass an instance through). ``None`` means
    ``"torch"``, the card."""
    if backend is None:
        backend = "torch"
    if not isinstance(backend, str):
        return backend
    if backend in _INSTANCES:
        return _INSTANCES[backend]
    if backend not in _FACTORIES:
        raise KeyError(f"unknown backend {backend!r}; "
                       f"available: {available_backends()}")
    _INSTANCES[backend] = _FACTORIES[backend]()
    return _INSTANCES[backend]


def _torch_factory() -> Backend:
    from repro_torch.vta.fsim_torch import TorchBackend
    return TorchBackend()


def _torch_cpu_factory() -> Backend:
    from repro_torch.vta.fsim_torch import TorchBackend
    return TorchBackend(device="cpu")


register_backend("numpy", NumpyBackend)
register_backend("torch", _torch_factory)
register_backend("torch-cpu", _torch_cpu_factory)


# ---------------------------------------------------------------------------
# Degradation ladder (serving reliability, serve/breaker.py)
# ---------------------------------------------------------------------------
# Best-first order for fault degradation: the card, the same executor on the
# CPU, the numpy oracle. Every backend executes the identical lowered trace
# bit for bit, so stepping down trades throughput only. "torch-cpu" is a
# rung of this ladder only on the way down: nothing picks it on its own. A
# ladder that names "torch" raises where there is no CUDA device (building
# its rung resolves the backend); it never drops the rung.
DEGRADATION_LADDER = ("torch", "torch-cpu", "numpy")


def backend_kernel_impls(backend: Union[str, Backend]) -> tuple:
    """The registry (kernel, impl) pairs the resolved backend instance
    routes compute through — the coordinates per-(backend, kernel-impl)
    circuit breakers and ``kernel.impl`` fault specs are scoped by. The
    numpy reference resolves no registry kernels: ``()``. Raises for
    ``"torch"`` where there is no CUDA device."""
    be = get_backend(backend)
    pairs = []
    for kernel, attr in (("gemm", "gemm_impl"), ("alu_chain", "alu_impl"),
                         ("alu_sweep", "alu_impl")):
        impl = getattr(be, attr, None)
        if impl is not None:
            pairs.append((kernel, impl))
    return tuple(pairs)
