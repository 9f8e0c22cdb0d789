"""Horizontal serving scale-out: a pool of executor workers, one scheduler.

The single-executor engine caps throughput at one executor no matter how
many accelerator configs the DSE finds. This module adds the horizontal
axis: N **executor workers** fed by the existing ``BatchScheduler``
through a placement layer, each worker standing in for one accelerator
instance — an independently failing unit with its own captured graphs,
its own degradation ladder, and its own circuit breaker.

Three design rules, in order:

* **Sticky affinity.** Placement keeps a ``(model, bucket) -> worker`` map
  (one model key = one (network graph, VTAConfig) pair), so every chunk
  capture a worker pays keeps paying off: the torch backend keys its plans
  (buffers and CUDA graphs) on (capture scope, trace, batch), the scope
  being the worker's, so a key that ping-pongs across workers is captured
  again on each (asserted via ``fsim_torch.capture_log()`` scopes). A key's
  first placement goes to the least-loaded admissible worker (fewest owned
  keys, ties to the lowest id — deterministic); afterwards it sticks until
  its owner dies or its breaker opens.

* **Breaker state feeds placement.** Every worker carries a worker-level
  ``CircuitBreaker`` (keyed ``worker<id>``) *in addition to* the per-rung
  breakers inside its own ``DegradingBackendExecutor``: rung breakers
  choose how a worker computes, the worker breaker decides whether the
  worker gets traffic at all. An ``open`` worker is skipped (its keys are
  reassigned — availability beats affinity); a ``half_open`` worker gets
  exactly the probe batch; a ``dead`` worker is permanently out and its
  in-flight batches are requeued whole through the engine's retry deque —
  supervision stays total, every ticket resolves.

* **Transport is a knob, policy is not.** Placement, breakers, affinity
  and fault hooks are identical across transports:

    ``inline``   the dispatching thread executes synchronously — fully
                 deterministic under a ``FakeClock``; what the chaos
                 drill and tests/test_torch_workers.py replay
                 byte-for-byte.
    ``thread``   (default) each worker owns a daemon thread + a bounded
                 inbox; dispatches overlap in wall-clock. The default for
                 live serving and the scale-out run.
    ``process``  flag-gated: each worker owns a dedicated single-child
                 ``ProcessPoolExecutor`` (spawn context — CUDA cannot
                 start in a forked child) and ships (model name, scale,
                 backend) *config* instead of objects; the child imports
                 only ``repro_torch``, opens its own CUDA context and
                 rebuilds served models via the memoized ``served_model``
                 registry, so every worker really does own its captures.

On the card (a worker whose executor computes on a CUDA device: a ladder
with the ``"torch"`` rung, the default), each inline or thread worker owns
one ``torch.cuda.Stream`` and runs every dispatch under it: the upload of
the images, the graph replays and the copy of the results back. Two
workers' graphs can then run at once; a worker never runs on the default
stream. The stream comes from the process's registry
(``fsim_torch.claim_stream``), so no other worker, of this pool or
another, and no capture thread runs on it; ``shutdown`` gives it back. A ladder that names ``"torch"`` raises where there is no CUDA
device, as the backend does: the pool never drops the rung.

Faults (serve/faults.py): ``worker.die`` and ``worker.stall`` are seeded,
replay-deterministic sites keyed by worker id; the pool consults them at
the top of every dispatch via ``FaultInjector.on_worker``.

The pool's mutable state (affinity map, worker states) is only touched
under the engine lock — ``place``/``on_worker_death`` are called from the
engine's locked sections, which is the pool's consistency model.
"""
from __future__ import annotations

import queue
import threading
import weakref
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.serve.breaker import (CLOSED, OPEN, CircuitBreaker,
                                       DegradingBackendExecutor)
from repro_torch.serve.clock import SystemClock
from repro_torch.vta import fsim_torch
from repro_torch.vta.backend import DEGRADATION_LADDER, get_backend

WORKER_LIVE, WORKER_DEAD = "live", "dead"
TRANSPORTS = ("inline", "thread", "process")

_STOP = object()                 # inbox sentinel for thread shutdown


class WorkerDied(RuntimeError):
    """The worker executing (or assigned) a batch is dead. The engine
    requeues the batch whole — the batch is innocent, the worker is not."""


class AllWorkersDead(RuntimeError):
    """Every worker in the pool is dead: dispatches can only fail."""


# ---------------------------------------------------------------------------
# process transport: config over objects
# ---------------------------------------------------------------------------
def _process_dispatch(name: str, scale: str, backend: str,
                      images: list, bucket: int) -> list:
    """Runs in the worker's child process: rebuild the served model from
    config (``served_model`` memoizes per process — the child's own
    captures stay warm across dispatches) and execute one padded batch."""
    from repro_torch.serve.model import served_model
    model = served_model(name, scale)
    batch = np.zeros((bucket,) + model.image_shape, np.int8)
    for i, img in enumerate(images):
        batch[i] = img
    outs = model.run_batch(batch, backend=backend)
    return [np.asarray(outs[i]) for i in range(len(images))]


def _process_describe(backend: str) -> dict:
    """Runs in the worker's child process: its pid and the device its
    backend computes on (the card's name for ``"torch"``)."""
    import os
    device = getattr(get_backend(backend), "device", torch.device("cpu"))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return {"pid": os.getpid(), "backend": backend, "device": str(device),
            "device_name": name}


class ProcessBackendExecutor:
    """Executor backed by one dedicated child process (spawn). Picklable by
    construction: only (registry name, scale, backend) strings and the
    numpy payloads cross the process boundary."""

    def __init__(self, specs: dict, backend: str = "torch"):
        from concurrent.futures import ProcessPoolExecutor
        from multiprocessing import get_context
        self.specs = dict(specs)       # model_key -> (registry name, scale)
        self.backend = backend
        self._pool = ProcessPoolExecutor(max_workers=1,
                                         mp_context=get_context("spawn"))

    def __call__(self, model_key: str, images: list, bucket: int) -> list:
        name, scale = self.specs[model_key]
        return self._pool.submit(_process_dispatch, name, scale,
                                 self.backend, list(images), bucket).result()

    def describe(self) -> dict:
        """What the child reports of itself (``_process_describe``)."""
        return self._pool.submit(_process_describe, self.backend).result()

    def shutdown(self) -> None:
        """Stop the child: queued dispatches are cancelled, a running one
        finishes, and the call returns once the child has exited."""
        self._pool.shutdown(wait=True, cancel_futures=True)


# ---------------------------------------------------------------------------
# one worker
# ---------------------------------------------------------------------------
def _card_device(executor) -> Optional[torch.device]:
    """The CUDA device an in-process executor computes on, or None: the
    first rung of a ladder, or the backend of a ``BackendExecutor``, that
    resolves to a backend on the card. Resolving ``"torch"`` raises where
    there is no CUDA device."""
    if isinstance(executor, ProcessBackendExecutor):
        return None
    names = [r.name for r in getattr(executor, "rungs", ())]
    if not names and hasattr(executor, "backend"):
        names = [executor.backend]
    for name in names:
        device = getattr(get_backend(name), "device", None)
        if device is not None and device.type == "cuda":
            return device
    return None


class ExecutorWorker:
    """One executor instance: an id, a backend executor (its own degradation
    ladder by default), a worker-level breaker, a CUDA stream of its own
    when the executor computes on the card, and — under the thread and
    process transports — a daemon thread draining a bounded inbox."""

    def __init__(self, wid: int, executor: Callable, *, clock,
                 faults=None, fail_threshold: int = 3, cooldown_s: float = 1.0,
                 on_transition: Optional[Callable] = None,
                 inbox_depth: int = 4):
        self.id = wid
        self.executor = executor
        device = _card_device(executor)
        self.stream = None if device is None else fsim_torch.claim_stream(
            device, f"worker{wid}")
        if self.stream is not None:
            self._release = weakref.finalize(
                self, fsim_torch.release_stream, self.stream)
        self.clock = clock
        self.faults = faults
        self.state = WORKER_LIVE
        self.died_at: Optional[float] = None
        self.death_handled = False   # pool.on_worker_death ran once
        self.dispatches = 0
        self.breaker = CircuitBreaker(key=f"worker{wid}",
                                      fail_threshold=fail_threshold,
                                      cooldown_s=cooldown_s,
                                      on_transition=on_transition)
        self.inbox: Optional[queue.Queue] = None     # set by thread transport
        self.inbox_depth = inbox_depth
        self.thread: Optional[threading.Thread] = None

    @property
    def live(self) -> bool:
        return self.state == WORKER_LIVE

    @property
    def scope(self) -> str:
        """The capture-scope label of this worker's dispatches."""
        return f"worker{self.id}"

    def stop(self) -> None:
        """Give the worker's stream back to the process's registry
        (``fsim_torch.claim_stream``); the pool's ``shutdown`` calls it once
        the worker's thread has ended."""
        if self.stream is not None:
            self._release()

    def kill(self) -> None:
        self.state = WORKER_DEAD
        self.died_at = self.clock.now()

    def call(self, model_key: str, images: list, bucket: int) -> list:
        """One dispatch on this worker: fault hooks first (a ``worker.stall``
        burns injected-clock time for the engine watchdog; a ``worker.die``
        kills the worker and raises), then the executor under this worker's
        capture scope, so every plan and capture is its own, and on its
        stream when it has one."""
        if not self.live:
            raise WorkerDied(f"worker{self.id} is dead")
        if self.faults is not None and self.faults.on_worker(self.id):
            self.kill()
            raise WorkerDied(f"worker{self.id}: injected worker.die")
        self.dispatches += 1
        prev = fsim_torch.set_capture_scope(self.scope)
        try:
            if self.stream is None:
                return self.executor(model_key, images, bucket)
            with torch.cuda.stream(self.stream):
                return self.executor(model_key, images, bucket)
        finally:
            fsim_torch.set_capture_scope(prev)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------
class WorkerPool:
    """N ``ExecutorWorker``s + the placement layer between them and the
    engine's scheduler.

    ``executor_factory(wid) -> callable`` overrides the per-worker executor
    (tests inject recording/faulty executors); the default builds one
    ``DegradingBackendExecutor`` per worker over ``ladder``, rung breakers
    key-prefixed ``w<id>:`` so a shared metrics log stays unambiguous. For
    ``transport="process"``, pass ``process_specs`` mapping each served
    model key to its ``(registry name, scale)`` config instead of models.
    ``shutdown`` releases each worker's captures
    (``fsim_torch.release_capture_scope``).
    """

    def __init__(self, models: Optional[dict] = None, n: int = 2, *,
                 backend: str = "torch", transport: str = "thread",
                 clock=None, faults=None, metrics=None,
                 ladder: tuple = DEGRADATION_LADDER,
                 executor_factory: Optional[Callable] = None,
                 fail_threshold: int = 3, cooldown_s: float = 1.0,
                 inbox_depth: int = 4,
                 process_specs: Optional[dict] = None):
        assert n >= 1, "a pool needs at least one worker"
        assert transport in TRANSPORTS, \
            f"unknown transport {transport!r}; known: {TRANSPORTS}"
        self.transport = transport
        self.clock = clock or SystemClock()
        self.faults = faults
        self.metrics = metrics
        self.affinity: dict = {}     # (model, bucket) -> worker id
        self._engine = None
        self.workers: List[ExecutorWorker] = []
        for wid in range(n):
            if executor_factory is not None:
                ex = executor_factory(wid)
            elif transport == "process":
                assert process_specs, \
                    "process transport needs process_specs " \
                    "{model_key: (registry name, scale)}"
                ex = ProcessBackendExecutor(process_specs, backend=backend)
            else:
                ex = DegradingBackendExecutor(
                    models or {}, ladder, clock=self.clock,
                    faults=faults, metrics=metrics,
                    key_prefix=f"w{wid}:")
            self.workers.append(ExecutorWorker(
                wid, ex, clock=self.clock, faults=faults,
                fail_threshold=fail_threshold, cooldown_s=cooldown_s,
                on_transition=self._on_breaker, inbox_depth=inbox_depth))

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def _on_breaker(self, key: str, old: str, new: str, now: float) -> None:
        if self.metrics is not None:
            self.metrics.on_breaker(key, old, new)

    def attach(self, engine) -> None:
        """Bind to the engine (supervised execution + requeue path) and, for
        the threaded transports, start one daemon thread per worker."""
        self._engine = engine
        if self.transport in ("thread", "process"):
            for w in self.workers:
                w.inbox = queue.Queue(maxsize=w.inbox_depth)
                w.thread = threading.Thread(
                    target=self._thread_loop, args=(w,),
                    name=f"vta-worker{w.id}", daemon=True)
                w.thread.start()

    def _thread_loop(self, worker: ExecutorWorker) -> None:
        while True:
            item = worker.inbox.get()
            if item is _STOP:
                return
            plan, t0 = item
            # supervised: _execute never raises
            self._engine._execute(plan, t0, worker=worker)
            if not worker.live:
                # died mid-stream: hand any queued work back to the engine
                # (requeued plans re-place onto the survivors) and retire
                leftovers = []
                try:
                    while True:
                        item = worker.inbox.get_nowait()
                        if item is not _STOP:
                            leftovers.append(item)
                except queue.Empty:
                    pass
                if leftovers:
                    self._engine._requeue_dead_worker_plans(
                        worker, [p for p, _ in leftovers])
                return

    def shutdown(self) -> None:
        for w in self.workers:
            if w.inbox is not None:
                w.inbox.put(_STOP)
            if isinstance(w.executor, ProcessBackendExecutor):
                w.executor.shutdown()
        for w in self.workers:
            if w.thread is not None:
                w.thread.join(timeout=5)
                w.thread = None
            w.stop()
            fsim_torch.release_capture_scope(w.scope)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def live_workers(self) -> list:
        return [w for w in self.workers if w.live]

    def live_count(self) -> int:
        return len(self.live_workers())

    def owned_keys(self, wid: int) -> int:
        return sum(1 for owner in self.affinity.values() if owner == wid)

    def breaker_states(self) -> dict:
        return {f"worker{w.id}": w.breaker.state for w in self.workers}

    def breaker_log(self) -> dict:
        """Per-worker breaker transition sequences (deterministic under a
        FakeClock + inline transport, diffed by the scale-out drill)."""
        return {f"worker{w.id}": [f"{a}->{b}" for a, b in
                                  w.breaker.transitions]
                for w in self.workers}

    def affinity_map(self) -> dict:
        return dict(self.affinity)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _admissible(self, w: ExecutorWorker, now: float) -> bool:
        """Would this worker accept a dispatch right now? Non-mutating —
        candidate scanning must not consume half-open probe admissions; the
        chosen worker's ``breaker.allow`` is called exactly once below."""
        if not w.live:
            return False
        b = w.breaker
        if b.state == CLOSED:
            return True
        if b.state == OPEN and now - b.opened_at >= b.cooldown_s:
            return True                         # cooled: a probe may go in
        return False                            # open/cooling, probe in flight

    def _has_room(self, w: ExecutorWorker) -> bool:
        return w.inbox is None or not w.inbox.full()

    def _note_affinity(self, kind: str) -> None:
        if self.metrics is not None:
            self.metrics.on_affinity(kind)

    def place(self, plan, now: float) -> Optional[ExecutorWorker]:
        """Pick the worker for one assembled batch, or None when nothing is
        admissible right now (engine defers — placement-skip backpressure).

        Sticky: a key goes back to its owner while the owner is live and
        its breaker admits traffic; a busy owner (full inbox) means *wait*,
        not reassign — tearing a warm key off its worker costs a capture.
        Only death or an open breaker moves a key (availability beats
        affinity), and a cold key goes to the least-loaded admissible
        worker, ties to the lowest id — a pure function of pool state.
        """
        key = (plan.model, plan.bucket)
        owner = self.affinity.get(key)
        if owner is not None:
            w = self.workers[owner]
            if w.live and self._admissible(w, now):
                if not self._has_room(w):
                    return None              # busy: sticky beats rebalance
                w.breaker.allow(now)         # consume probe if half-opening
                self._note_affinity("hit")
                return w
            if w.live and w.breaker.state != OPEN:
                return None                  # probe in flight: wait for it
            # owner dead or breaker open: reassign below
        candidates = [w for w in self.workers
                      if self._admissible(w, now) and self._has_room(w)]
        if not candidates:
            return None
        w = min(candidates, key=lambda w: (self.owned_keys(w.id), w.id))
        w.breaker.allow(now)
        self.affinity[key] = w.id
        self._note_affinity("cold" if owner is None else "reassigned")
        return w

    def dispatch(self, worker: ExecutorWorker, plan, t0: float) -> None:
        """Hand a placed batch to its worker: run it synchronously (inline)
        or enqueue it on the worker's inbox (thread/process transports).
        ``place`` checked for room, so the put never blocks."""
        if worker.inbox is None:
            self._engine._execute(plan, t0, worker=worker)
        else:
            worker.inbox.put_nowait((plan, t0))

    # ------------------------------------------------------------------
    # death handling (called under the engine lock)
    # ------------------------------------------------------------------
    def on_worker_death(self, worker: ExecutorWorker) -> None:
        """Record the death (idempotent — a dead worker can surface
        ``WorkerDied`` more than once). The dead worker's affinity entries
        are deliberately left in place: ``place`` detects the dead owner
        and moves each key to a survivor, counting it *reassigned* — the
        taxonomy's honest name for a capture the death forces us to pay
        again."""
        if worker.death_handled:
            return
        worker.death_handled = True
        if self.metrics is not None:
            self.metrics.on_worker_death(worker.id)
