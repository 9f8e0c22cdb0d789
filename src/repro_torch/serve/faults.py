"""Deterministic fault injection for the serving stack.

Reliability work is only testable if failures are *reproducible*: a fault
that fires from a wall-clock race cannot be bisected, asserted on, or
replayed in CI. This module makes faults first-class, seeded inputs:

* a ``FaultPlan`` is data — a seed plus a list of ``FaultSpec``s naming
  *where* (site + key), *when* (probability / fire count / warm-up skip)
  and *how* a fault fires;
* a ``FaultInjector`` executes the plan. Every firing decision is a pure
  function of the spec's own seeded RNG stream and its opportunity
  counter, so two runs of the same plan against the same request stream
  produce byte-identical fault logs (asserted in tests/test_faults.py and
  by the chaos baseline in CI);
* when no injector is wired (``VTAServeEngine(faults=None)``, the default)
  the hot path pays exactly one ``is None`` check per dispatch — zero
  overhead, no RNG, no logging.

Sites (the engine / degradation ladder consult these at fixed points):

  ``executor.raise``   the executor call raises ``InjectedFault`` before
                       touching the backend (infra crash; transient when
                       ``times`` bounds it). Key: served-model name.
  ``executor.hang``    the executor stalls ``hang_s`` seconds on the
                       *injected clock* before proceeding — the watchdog
                       (``VTAServeEngine(exec_timeout_s=...)``) is what
                       turns the stall into a failure. Key: model name.
  ``kernel.impl``      a registry kernel implementation fails. Key is the
                       registry coordinate ``"<kernel>:<impl>"`` (e.g.
                       ``"gemm:pallas_interpret"``) and is validated
                       against ``kernels/registry.py`` at plan-build time.
                       The degradation ladder (serve/breaker.py) consults
                       this site before dispatching on a rung that routes
                       compute through the faulted implementation;
                       ``install_kernel_faults`` additionally wraps the
                       registry entry itself for direct-call paths.
  ``payload.bitflip``  an int8 payload is corrupted: real bit-flips are
                       applied to a copy of the image (DRAM corruption
                       model) and the request id is marked *poisoned* —
                       every dispatch of a batch containing it raises
                       ``PoisonedPayload``, which is what the engine's
                       batch bisection isolates. Key: model name.
  ``worker.die``       an executor worker (serve/workers.py) dies
                       permanently at the top of a dispatch: the pool
                       marks it dead (its affinity keys get *reassigned*
                       to survivors at next placement) and the engine
                       requeues the in-flight batch whole (no bisection —
                       the batch is innocent, the worker is not). Key:
                       the worker id as a string (``"0"``).
  ``worker.stall``     a worker stalls ``hang_s`` seconds on the injected
                       clock before executing — watchdog fodder, exactly
                       like ``executor.hang`` but scoped to one worker so
                       per-worker breakers (not the rung breakers) absorb
                       the failures. Key: worker id string.

``times=None`` makes a fault persistent (fires on every matching
opportunity); a finite ``times`` makes it transient — it exhausts, which
is also how chaos runs demonstrate breaker *recovery* through a half-open
probe.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Set

import numpy as np

SITES = ("executor.raise", "executor.hang", "kernel.impl", "payload.bitflip",
         "worker.die", "worker.stall")


class InjectedFault(RuntimeError):
    """An injected failure (site + key carried for logs and assertions)."""

    def __init__(self, site: str, key: str, detail: str = ""):
        self.site, self.key, self.detail = site, key, detail
        super().__init__(f"injected fault at {site}[{key}]"
                         + (f": {detail}" if detail else ""))


class PoisonedPayload(InjectedFault):
    """A batch contained a bit-flipped (poisoned) payload."""


class ExecutorTimeout(RuntimeError):
    """The executor exceeded the engine's watchdog budget."""


@dataclass(frozen=True)
class FaultSpec:
    """One fault source. Matching opportunities are counted per spec, so
    ``after`` skips a warm-up and ``times`` bounds total fires; ``prob``
    draws from the spec's own seeded stream — deterministic regardless of
    what other specs do."""
    site: str
    key: str = "*"                   # "*" matches every key at the site
    prob: float = 1.0                # firing probability per opportunity
    times: Optional[int] = None      # max fires; None = persistent
    after: int = 0                   # skip the first N matching opportunities
    hang_s: float = 0.0              # executor.hang: injected-clock stall
    bits: int = 1                    # payload.bitflip: bits to flip


@dataclass
class FaultPlan:
    """Seed + specs. ``validate`` (called by the injector) rejects unknown
    sites and ``kernel.impl`` keys that do not resolve through the kernel
    registry — a chaos run must never silently inject nothing."""
    seed: int = 0
    specs: tuple = ()

    def __post_init__(self):
        self.specs = tuple(self.specs)

    def validate(self) -> "FaultPlan":
        from repro_torch.kernels.registry import get_kernel
        for s in self.specs:
            if s.site not in SITES:
                raise ValueError(f"unknown fault site {s.site!r}; "
                                 f"known: {SITES}")
            if not (0.0 <= s.prob <= 1.0):
                raise ValueError(f"{s.site}: prob must be in [0, 1]")
            if s.site == "kernel.impl" and s.key != "*":
                name, _, impl = s.key.partition(":")
                get_kernel(name, impl)       # KeyError names alternatives
        return self


@dataclass
class FaultEvent:
    """One fired fault — the unit of the replayable fault log."""
    seq: int
    t: float                         # injected-clock time of the firing
    site: str
    key: str
    detail: str = ""

    def to_dict(self) -> dict:
        return {"seq": self.seq, "t": round(self.t, 6), "site": self.site,
                "key": self.key, "detail": self.detail}


@dataclass
class _SpecState:
    rng: np.random.Generator
    opportunities: int = 0
    fires: int = 0


class FaultInjector:
    """Executes a ``FaultPlan`` against the engine's named fault sites.

    Deterministic by construction: each spec owns an RNG seeded from
    ``(plan.seed, spec index)``, and every decision consumes only that
    stream plus the spec's opportunity counter. The ``log`` (a list of
    ``FaultEvent``) replays identically for identical request streams.
    ``on_fire(site)`` is an optional hook the engine points at
    ``ServeMetrics.on_fault`` so fault counters land in snapshots.
    """

    def __init__(self, plan: FaultPlan, *, clock=None,
                 on_fire: Optional[Callable[[str], None]] = None):
        self.plan = plan.validate()
        self.clock = clock
        self.on_fire = on_fire
        self.log: List[FaultEvent] = []
        self.poisoned: Set[int] = set()
        self._seq = 0
        self._state = [
            _SpecState(rng=np.random.default_rng((int(plan.seed), i)))
            for i, _ in enumerate(plan.specs)]

    # ------------------------------------------------------------------
    # core decision + log
    # ------------------------------------------------------------------
    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    def _record(self, site: str, key: str, detail: str = "") -> None:
        self.log.append(FaultEvent(seq=self._seq, t=self._now(), site=site,
                                   key=key, detail=detail))
        self._seq += 1
        if self.on_fire is not None:
            self.on_fire(site)

    def fire(self, site: str, key: str,
             detail: str = "") -> Optional[FaultSpec]:
        """One opportunity at ``site``/``key``: returns the first matching
        spec that fires (logging the event), else None. Every matching
        spec's opportunity counter advances whether or not it fires, so
        ``after``/``prob`` schedules stay independent across specs."""
        hit = None
        for spec, st in zip(self.plan.specs, self._state):
            if spec.site != site or spec.key not in ("*", key):
                continue
            st.opportunities += 1
            if hit is not None or st.opportunities <= spec.after:
                continue
            if spec.times is not None and st.fires >= spec.times:
                continue
            if spec.prob < 1.0 and float(st.rng.random()) >= spec.prob:
                continue
            st.fires += 1
            hit = spec
        if hit is not None:
            self._record(site, key, detail)
        return hit

    # ------------------------------------------------------------------
    # engine hooks (each a no-op unless a matching spec fires)
    # ------------------------------------------------------------------
    def on_submit(self, req) -> None:
        """``payload.bitflip``: corrupt a copy of the int8 payload (real
        bit-flips at seeded byte/bit positions) and mark the request
        poisoned. The original caller array is never mutated."""
        for spec, st in zip(self.plan.specs, self._state):
            if spec.site != "payload.bitflip" \
                    or spec.key not in ("*", req.model):
                continue
            st.opportunities += 1
            if st.opportunities <= spec.after:
                continue
            if spec.times is not None and st.fires >= spec.times:
                continue
            if spec.prob < 1.0 and float(st.rng.random()) >= spec.prob:
                continue
            st.fires += 1
            payload = np.array(req.payload)          # private copy
            flat = payload.reshape(-1).view(np.uint8)
            flips = []
            for _ in range(max(1, spec.bits)):
                pos = int(st.rng.integers(flat.size))
                bit = int(st.rng.integers(8))
                flat[pos] ^= np.uint8(1 << bit)
                flips.append(f"{pos}.{bit}")
            req.payload = payload
            self.poisoned.add(req.id)
            self._record("payload.bitflip", req.model,
                         f"req={req.id} flips={','.join(flips)}")
            return

    def is_poisoned(self, req_id: int) -> bool:
        return req_id in self.poisoned

    def on_dispatch(self, model: str, requests: list) -> None:
        """Consulted by the engine immediately before the executor call.
        Raises for poisoned batches and injected executor crashes; hangs
        stall on the injected clock and return (the watchdog decides)."""
        bad = [r.id for r in requests if r.id in self.poisoned]
        if bad:
            self._record("payload.bitflip", model,
                         f"poisoned dispatch reqs={bad}")
            raise PoisonedPayload("payload.bitflip", model,
                                  f"poisoned request ids {bad}")
        spec = self.fire("executor.hang", model)
        if spec is not None and self.clock is not None:
            self.clock.sleep(spec.hang_s)
        if self.fire("executor.raise", model) is not None:
            raise InjectedFault("executor.raise", model)

    def on_worker(self, worker_id) -> bool:
        """Consulted by the worker pool (serve/workers.py) at the top of
        every dispatch a worker runs. Fires ``worker.stall`` first (stalls
        ``hang_s`` on the injected clock — the engine watchdog is what
        turns the stall into a failure), then ``worker.die``; returns True
        when the worker must die. Keys are worker ids as strings, so one
        plan can fault workers independently and replay-deterministically:
        opportunity counters advance per dispatch in dispatch order, which
        the inline transport keeps identical across same-seed runs."""
        key = str(worker_id)
        spec = self.fire("worker.stall", key)
        if spec is not None and self.clock is not None:
            self.clock.sleep(spec.hang_s)
        return self.fire("worker.die", key) is not None

    def check_kernel(self, kernel: str, impl: str) -> None:
        """Consulted by the degradation ladder for each registry (kernel,
        impl) pair a rung routes compute through."""
        if self.fire("kernel.impl", f"{kernel}:{impl}") is not None:
            raise InjectedFault("kernel.impl", f"{kernel}:{impl}")

    # ------------------------------------------------------------------
    # registry-level wrapping (direct-call kernel paths)
    # ------------------------------------------------------------------
    def install_kernel_faults(self) -> None:
        """Physically wrap the registry entries named by ``kernel.impl``
        specs so *direct* ``get_kernel(...)()`` calls fail too. Note the
        jax backends resolve kernels inside ``jax.jit``-traced functions:
        there the wrapper runs at trace time only (cached chunks never
        re-enter Python), which is why the serving ladder consults
        ``check_kernel`` at the dispatch boundary instead. ``restore()``
        puts the originals back."""
        from repro_torch.kernels.registry import swap_kernel
        self._swapped = getattr(self, "_swapped", [])
        for spec in self.plan.specs:
            if spec.site != "kernel.impl" or spec.key == "*":
                continue
            name, _, impl = spec.key.partition(":")

            def wrapper(*a, __inj=self, __name=name, __impl=impl, **kw):
                __inj.check_kernel(__name, __impl)
                return __inj._orig[(__name, __impl)](*a, **kw)

            self._orig = getattr(self, "_orig", {})
            if (name, impl) in self._orig:
                continue
            self._orig[(name, impl)] = swap_kernel(name, impl, wrapper)
            self._swapped.append((name, impl))

    def restore_kernels(self) -> None:
        from repro_torch.kernels.registry import swap_kernel
        for name, impl in getattr(self, "_swapped", []):
            swap_kernel(name, impl, self._orig[(name, impl)])
        self._swapped, self._orig = [], {}

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def summary(self) -> dict:
        out: dict = {}
        for ev in self.log:
            out[ev.site] = out.get(ev.site, 0) + 1
        return out

    def events(self) -> list:
        return [ev.to_dict() for ev in self.log]
