"""Circuit breakers + the bit-exact backend degradation ladder.

The execution backends are bit-for-bit interchangeable by construction
(vta/backend.py's equivalence contract), which turns graceful degradation
into a *free* reliability axis: stepping torch -> torch-cpu -> numpy
under faults loses throughput, never fidelity. This module is the policy
layer that does the stepping:

* ``CircuitBreaker`` — classic consecutive-failure breaker per
  (backend, kernel-impl) rung: ``closed`` (healthy) trips to ``open``
  after ``fail_threshold`` consecutive failures; after ``cooldown_s`` on
  the injected clock one probe call is admitted (``half_open``); a probe
  success re-closes, a probe failure re-opens and re-arms the cooldown.
  Every transition is recorded (and mirrored into ``ServeMetrics``) so
  chaos runs can assert the exact demote/recover sequence.

* ``DegradingBackendExecutor`` — drop-in replacement for the engine's
  ``BackendExecutor``: walks the ladder top-down each dispatch, skipping
  rungs whose breaker is open, and serves the batch on the first rung
  that (a) is admitted, (b) passes the fault injector's ``kernel.impl``
  check for every registry implementation the rung routes compute
  through, and (c) executes without raising. Because the walk restarts
  from the top every call, recovery is automatic: once a cooled-down
  rung's half-open probe succeeds, traffic returns to it. Only when every
  rung fails does the call raise ``AllBackendsFailed`` — at which point
  the engine's retry/bisection supervision takes over. A rung that
  computes on a CUDA device steps down only for an injected fault
  (``InjectedFault``: the drills this ladder exists for); any other error
  there (a kernel that does not build or launch, a CUDA error) is raised
  as it is, the rung's breaker untouched, so a fault of the card never
  moves its work to the CPU unseen.

``CircuitBreaker`` is also the health primitive at the *worker* axis:
serve/workers.py gives every pool worker one breaker (keyed ``worker<id>``)
whose state feeds placement — an open worker is skipped, a half-open worker
gets only the probe batch — while each worker additionally carries its own
``DegradingBackendExecutor`` so rung-level and worker-level health stay
independent. ``key_prefix`` namespaces the rung breakers per worker
(``w0:torch[...]``) so a shared ``ServeMetrics`` log stays unambiguous.

Not thread-safe beyond the engine's serialization: the serve loop issues
one dispatch at a time per executor instance (the pool serializes per
worker), which is the breaker's consistency model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.serve.clock import SystemClock
from repro_torch.serve.engine import BackendExecutor
from repro_torch.serve.faults import InjectedFault
from repro_torch.vta.backend import (DEGRADATION_LADDER, backend_kernel_impls,
                                     get_backend)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class AllBackendsFailed(RuntimeError):
    """Every rung of the degradation ladder refused or failed the batch."""


@dataclass
class CircuitBreaker:
    """Consecutive-failure breaker with half-open probe recovery."""
    key: str                               # e.g. "torch[gemm:cuda,...]"
    fail_threshold: int = 3
    cooldown_s: float = 1.0
    on_transition: Optional[Callable] = None   # (key, old, new, now)
    state: str = CLOSED
    consecutive_failures: int = 0
    opened_at: float = 0.0
    transitions: List[tuple] = field(default_factory=list)

    def _move(self, new: str, now: float) -> None:
        old, self.state = self.state, new
        self.transitions.append((old, new))
        if self.on_transition is not None:
            self.on_transition(self.key, old, new, now)

    def allow(self, now: float) -> bool:
        """May a dispatch use this rung right now? An ``open`` breaker
        whose cooldown elapsed moves to ``half_open`` and admits exactly
        the probe call that triggered the check."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN and now - self.opened_at >= self.cooldown_s:
            self._move(HALF_OPEN, now)
            return True
        return False           # open and still cooling, or probe in flight

    def on_success(self, now: float) -> None:
        if self.state == HALF_OPEN:
            self._move(CLOSED, now)
        self.consecutive_failures = 0

    def on_failure(self, now: float) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            self.opened_at = now
            self._move(OPEN, now)
        elif self.state == CLOSED \
                and self.consecutive_failures >= self.fail_threshold:
            self.opened_at = now
            self._move(OPEN, now)


@dataclass
class LadderRung:
    name: str                              # registered backend name
    executor: BackendExecutor
    impls: tuple                           # ((kernel, impl), ...) it uses
    breaker: CircuitBreaker
    on_card: bool = False                  # computes on a CUDA device


class DegradingBackendExecutor:
    """Ladder-walking executor: ``__call__`` has the engine-executor
    signature ``(model_key, images, bucket) -> [outputs]``.

    ``ladder`` is a tuple of registered backend names, best first (default
    ``DEGRADATION_LADDER`` = torch -> torch-cpu -> numpy). Each rung's
    breaker is keyed ``backend[kernel:impl,...]`` from the registry
    implementations that backend instance actually resolves
    (``backend_kernel_impls``), so a persistent ``kernel.impl`` fault trips
    exactly the rungs that route compute through the broken kernel.
    """

    def __init__(self, models: dict, ladder: tuple = DEGRADATION_LADDER, *,
                 clock=None, faults=None, metrics=None,
                 fail_threshold: int = 3, cooldown_s: float = 1.0,
                 key_prefix: str = ""):
        assert ladder, "need at least one backend in the ladder"
        self.clock = clock or SystemClock()
        self.faults = faults
        self.metrics = metrics
        self.rungs: List[LadderRung] = []
        for name in ladder:
            impls = backend_kernel_impls(name)
            sig = ",".join(f"{k}:{i}" for k, i in impls) or "reference"
            device = getattr(get_backend(name), "device", None)
            self.rungs.append(LadderRung(
                name=name,
                executor=BackendExecutor(models, backend=name),
                impls=impls,
                on_card=device is not None and device.type == "cuda",
                breaker=CircuitBreaker(
                    key=f"{key_prefix}{name}[{sig}]",
                    fail_threshold=fail_threshold, cooldown_s=cooldown_s,
                    on_transition=self._on_transition)))

    def _on_transition(self, key: str, old: str, new: str,
                       now: float) -> None:
        if self.metrics is not None:
            self.metrics.on_breaker(key, old, new)

    @property
    def active_backend(self) -> str:
        """The rung a dispatch issued now would use (diagnostics only)."""
        now = self.clock.now()
        for rung in self.rungs:
            if rung.breaker.state == CLOSED or (
                    rung.breaker.state == OPEN
                    and now - rung.breaker.opened_at >= rung.breaker.cooldown_s):
                return rung.name
        return self.rungs[-1].name

    def __call__(self, model_key: str, images: list, bucket: int) -> list:
        last_err: Optional[Exception] = None
        for i, rung in enumerate(self.rungs):
            if not rung.breaker.allow(self.clock.now()):
                continue
            try:
                if self.faults is not None:
                    for kernel, impl in rung.impls:
                        self.faults.check_kernel(kernel, impl)
                outs = rung.executor(model_key, images, bucket)
            except Exception as e:                      # noqa: BLE001
                if rung.on_card and not isinstance(e, InjectedFault):
                    raise
                rung.breaker.on_failure(self.clock.now())
                last_err = e
                continue
            rung.breaker.on_success(self.clock.now())
            if i > 0 and self.metrics is not None:
                self.metrics.on_fallback(rung.name)
            return outs
        raise AllBackendsFailed(
            f"all ladder rungs failed or were open: "
            f"{[r.name for r in self.rungs]}") from last_err

    def breaker_states(self) -> dict:
        return {r.name: r.breaker.state for r in self.rungs}

    def breaker_log(self) -> dict:
        """Per-rung transition sequences, keyed by backend name —
        deterministic under a FakeClock, compared by the chaos baseline."""
        return {r.name: [f"{a}->{b}" for a, b in r.breaker.transitions]
                for r in self.rungs}
