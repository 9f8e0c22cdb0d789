"""Kernel registry: one kernel name, several interchangeable implementations.

The port's own registry, with the API of the JAX package's. A *kernel* is a
named contract; an *implementation* is one way to execute it:

  ``"gemm"``       one VTA GEMM instruction whole: the inp/wgt rows its
                   index vectors name, their exact int8 products, added
                   into the int32 acc scratchpad in place
                   (kernels/vta_gemm.py).
  ``"alu_chain"``  a scratchpad-only ALU stage program (kernels/alu_sweep.py).
  ``"alu_sweep"``  the DRAM-direct form: slabs gathered from DRAM tensors, the
                   stage program, optional acc write and int8 store.

Implementations: ``"cuda"`` — the wrapper around the hand-written kernel
(launches it for CUDA tensors, takes the plain version for CPU tensors) and
``"torch"`` — the plain PyTorch version. Both are bit-exact.

Built-ins register lazily on first lookup; ``register_kernel`` is open for
tests and experiments.
"""
from __future__ import annotations

from typing import Callable, Dict

_KERNELS: Dict[str, Dict[str, Callable]] = {}
_BUILTINS_READY = False


def register_kernel(name: str, impl: str, fn: Callable, *,
                    replace: bool = False) -> None:
    """Register ``fn`` as implementation ``impl`` of kernel ``name``."""
    impls = _KERNELS.setdefault(name, {})
    if not replace and impl in impls:
        raise ValueError(f"kernel {name!r} impl {impl!r} already registered")
    impls[impl] = fn


def _ensure_builtins() -> None:
    global _BUILTINS_READY
    if _BUILTINS_READY:
        return
    _BUILTINS_READY = True
    from repro_torch.kernels import alu_sweep, vta_gemm  # noqa: F401


def get_kernel(name: str, impl: str) -> Callable:
    """Resolve one implementation; KeyError names the alternatives."""
    _ensure_builtins()
    impls = _KERNELS.get(name)
    if not impls:
        raise KeyError(f"unknown kernel {name!r}; "
                       f"available: {sorted(_KERNELS)}")
    if impl not in impls:
        raise KeyError(f"kernel {name!r} has no impl {impl!r}; "
                       f"available: {sorted(impls)}")
    return impls[impl]


def swap_kernel(name: str, impl: str, fn: Callable) -> Callable:
    """Replace implementation ``impl`` of kernel ``name`` and return the
    previous callable so callers can restore it (fault injection, test
    doubles). KeyError when the pair is unknown."""
    old = get_kernel(name, impl)
    _KERNELS[name][impl] = fn
    return old


def available_impls(name: str) -> list:
    _ensure_builtins()
    return sorted(_KERNELS.get(name, {}))
