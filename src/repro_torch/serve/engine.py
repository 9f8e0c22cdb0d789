"""Serving engine: VTA continuous batching over the port's backends.

``VTAServeEngine`` is the production path for the accelerator stack: an
async multi-tenant request queue feeding a continuous-batching scheduler
(serve/scheduler.py) that assembles dynamic batches per served model —
one (network, VTAConfig) pair — pads them to bucket sizes, and dispatches
through ``Backend.run_batched`` (the CUDA ``"torch"`` backend by default).

The engine is deterministic by construction: its clock and its executor
are both injected. Tests drive it with a ``FakeClock`` and a recording
executor — every fairness/backpressure/deadline decision replays exactly.
Production wires the ``SystemClock`` and a ``BackendExecutor``,
optionally on a background thread (``start``/``stop``).

Execution is *supervised*: the serve loop never dies on an executor
exception. A failing batch is retried with exponential backoff on the
engine clock (``max_retries``), guarded by an optional watchdog
(``exec_timeout_s``), and on repeated failure **bisected** — split in two
and requeued ahead of fresh work so a poisoned request is isolated and
failed alone while its innocent batch-mates complete. Every submitted
ticket resolves; a failed one raises from ``Ticket.result``. ``faults``
takes a seeded ``serve/faults.FaultInjector`` for deterministic chaos
testing.

``workers`` adds the horizontal axis (serve/workers.py): an int builds a
``WorkerPool`` of that many executor workers over the same models/backend,
or pass a pre-built pool. Batches are then *placed* (sticky
``(model, bucket) -> worker`` affinity, worker breaker state feeding
admission) before they are dispatched, and a worker's death requeues its
batches whole through the same retry deque bisection uses — supervision
stays total across worker failures. On the card each thread worker runs on
a CUDA stream of its own and owns its captured graphs. Without ``workers``
nothing changes: the single injected executor runs every batch.

The language-model session (serve/session.py: ``ServeSession`` and its
step factories) is exported here too, as the reference exports it.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.serve.clock import FakeClock, SystemClock
from repro_torch.serve.faults import ExecutorTimeout, FaultInjector
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queues import REJECT_NEW, Request
from repro_torch.serve.scheduler import DEFAULT_BUCKETS, BatchPlan, BatchScheduler
from repro_torch.serve.session import (ServeSession, greedy_token,  # noqa: F401
                                       make_decode_step, make_prefill_step)

__all__ = ["ServeSession", "make_prefill_step", "make_decode_step",
           "greedy_token", "Ticket", "BackendExecutor", "VTAServeEngine",
           "ExecutorTimeout"]


class Ticket:
    """Caller-facing handle for one submitted request."""

    def __init__(self, request: Request):
        self.request = request
        self._done = threading.Event()
        if request.status in ("rejected", "shed", "expired", "failed"):
            self._done.set()

    @property
    def status(self) -> str:
        return self.request.status

    @property
    def ok(self) -> bool:
        return self.request.status == "done"

    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self) -> None:
        self._done.set()

    def result(self, timeout: Optional[float] = None):
        """Block until resolved; returns the output array or raises
        ``RuntimeError`` naming the terminal reason (queue_full /
        deadline_expired / the execution failure after supervision gave
        up)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.request.id} still pending")
        if self.request.status != "done":
            raise RuntimeError(f"request {self.request.id} "
                               f"{self.request.status}: {self.request.error}")
        return self.request.result


class BackendExecutor:
    """The production executor: pads a batch to its bucket and runs it as
    one ``run_batched`` dispatch on the configured backend. Pad slots are
    zero images; their outputs are computed and discarded (the price of a
    reused compile, measured by the occupancy metric)."""

    def __init__(self, models: dict, backend: str = "torch"):
        self.models = models
        self.backend = backend

    def __call__(self, model_key: str, images: list, bucket: int) -> list:
        model = self.models[model_key]
        batch = np.zeros((bucket,) + model.image_shape, np.int8)
        for i, img in enumerate(images):
            batch[i] = img
        outs = model.run_batch(batch, backend=self.backend)
        return [np.asarray(outs[i]) for i in range(len(images))]


class VTAServeEngine:
    """Multi-tenant continuous-batching server over the VTA backends.

    ``executor(model_key, images, bucket) -> [outputs]`` and ``clock`` are
    injectable; defaults are ``BackendExecutor(models, backend)`` and the
    system clock. ``submit`` is thread-safe; batch execution happens outside
    the lock so submitters never block on the accelerator.
    """

    def __init__(self, models: Optional[dict] = None, *,
                 backend: str = "torch",
                 clock: Union[SystemClock, FakeClock, None] = None,
                 executor: Optional[Callable] = None,
                 buckets: tuple = DEFAULT_BUCKETS,
                 queue_capacity: int = 64,
                 shed_policy: str = REJECT_NEW,
                 max_wait_s: float = 0.0,
                 metrics: Optional[ServeMetrics] = None,
                 faults: Optional[FaultInjector] = None,
                 max_retries: int = 2,
                 retry_backoff_s: float = 0.005,
                 exec_timeout_s: Optional[float] = None,
                 requeue_budget: int = 6,
                 workers=None,
                 worker_transport: str = "thread"):
        self.models = models or {}
        self.clock = clock or SystemClock()
        self.executor = executor if executor is not None \
            else BackendExecutor(self.models, backend)
        self.scheduler = BatchScheduler(buckets=buckets,
                                        queue_capacity=queue_capacity,
                                        shed_policy=shed_policy,
                                        max_wait_s=max_wait_s)
        self.metrics = metrics or ServeMetrics()
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.exec_timeout_s = exec_timeout_s
        self.requeue_budget = requeue_budget
        self.faults = faults
        if faults is not None:
            if faults.clock is None:
                faults.clock = self.clock
            if faults.on_fire is None:
                faults.on_fire = self.metrics.on_fault
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._tickets: dict = {}
        self._retry_queue: deque = deque()   # bisected sub-batches, LIFO-ish
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._inflight = 0           # requests handed to a worker/executor
        # horizontal scale-out: a pool of executor workers (lazy import —
        # workers.py builds on breaker.py which builds on this module)
        self.pool = None
        if workers is not None:
            from repro_torch.serve.workers import WorkerPool
            if isinstance(workers, WorkerPool):
                self.pool = workers
                if self.pool.metrics is None:
                    self._wire_pool_metrics()
            else:
                self.pool = WorkerPool(
                    self.models, int(workers), backend=backend,
                    transport=worker_transport, clock=self.clock,
                    faults=self.faults, metrics=self.metrics)
            self.pool.attach(self)

    # ------------------------------------------------------------------
    # tenants + submission
    # ------------------------------------------------------------------
    def add_tenant(self, name: str, *, weight: float = 1.0,
                   capacity: Optional[int] = None) -> None:
        with self._lock:
            self.scheduler.add_tenant(name, weight=weight, capacity=capacity)

    def submit(self, tenant: str, model: str, image: np.ndarray, *,
               deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue one image. ``deadline_s`` is relative to now; a request
        whose deadline passes while queued is dropped, never executed."""
        if self.models and model not in self.models:
            raise KeyError(f"unknown served model {model!r}; "
                           f"known: {sorted(self.models)}")
        with self._lock:
            now = self.clock.now()
            req = Request(id=next(self._ids), tenant=tenant, model=model,
                          payload=image, arrival_t=now,
                          deadline=None if deadline_s is None
                          else now + deadline_s)
            if self.faults is not None:
                self.faults.on_submit(req)     # may bit-flip the payload
            if self.metrics.started_at == 0.0:
                self.metrics.started_at = now
            self.metrics.on_submit(tenant)
            adm = self.scheduler.submit(req, now)
            ticket = Ticket(req)
            if adm.accepted:
                # only accepted requests are tracked: a rejected ticket is
                # born resolved (status/error set at admission) and must
                # not leak an entry that no later _finish will ever pop
                self._tickets[req.id] = ticket
            else:
                self.metrics.on_reject(tenant)
            if adm.shed is not None:
                self.metrics.on_shed(adm.shed.tenant)
                self._finish(adm.shed)
        return ticket

    def reset_metrics(self, metrics: Optional[ServeMetrics] = None
                      ) -> ServeMetrics:
        """Swap in a fresh ``ServeMetrics`` (benchmark warmups discard the
        warmup's counters this way) and rewire every component that holds
        a reference — the worker pool, each worker's ladder (so a step down
        the ladder after a reset is still counted) and the fault injector's
        on-fire hook."""
        self.metrics = metrics if metrics is not None else ServeMetrics()
        if self.pool is not None:
            self._wire_pool_metrics()
        if self.faults is not None and self.faults.on_fire is not None:
            self.faults.on_fire = self.metrics.on_fault
        return self.metrics

    def _wire_pool_metrics(self) -> None:
        """Point the pool and every worker's ladder at ``self.metrics``: a
        step down a ladder is always counted where the engine reports."""
        self.pool.metrics = self.metrics
        for w in self.pool.workers:
            if hasattr(w.executor, "metrics"):
                w.executor.metrics = self.metrics

    def pending(self) -> int:
        with self._lock:
            return self.scheduler.pending() \
                + sum(len(p.requests) for p in self._retry_queue) \
                + self._inflight

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------
    def _finish(self, req: Request) -> None:
        t = self._tickets.pop(req.id, None)
        if t is not None:
            t._resolve()

    def _expire_locked(self, req: Request) -> None:
        req.status = "expired"
        req.error = "deadline_expired"
        self.metrics.on_expire(req.tenant)
        self._finish(req)

    def _fail_locked(self, req: Request, err: Exception,
                     note: str = "") -> None:
        req.status = "failed"
        req.error = repr(err) + (f" [{note}]" if note else "")
        self.metrics.on_fail(req.tenant)
        self._finish(req)

    def _next_plan_locked(self) -> Optional[BatchPlan]:
        """Bisected sub-batches first (isolation in progress beats fresh
        work), then the scheduler; deadline-purges requeued requests."""
        now = self.clock.now()
        while self._retry_queue:
            plan = self._retry_queue.popleft()
            live = []
            for r in plan.requests:
                if r.deadline is not None and r.deadline <= now:
                    self._expire_locked(r)
                else:
                    live.append(r)
            if live:
                plan.requests = live
                plan.bucket = self.scheduler.bucket_for(len(live))
                return plan
        plan, expired = self.scheduler.next_batch(now)
        for req in expired:
            self._expire_locked(req)
        return plan

    # how many assembled plans one step scans for a placeable one before
    # deferring: bounds the work done under the lock while letting a plan
    # whose sticky owner is busy yield to other models' traffic instead of
    # blocking the head of the line
    PLACEMENT_SCAN = 4

    def _next_dispatchable_locked(self):
        """Pool placement over ``_next_plan_locked``: returns the first
        ``(plan, worker)`` the pool will admit, or None (nothing assembled,
        or nothing placeable right now — a placement skip). Plans that
        assembled but could not place are pushed back to the retry deque
        front in order, statuses untouched and requeue budgets uncharged:
        deferral is backpressure, not failure. With zero live workers every
        queued request is failed (``AllWorkersDead``) so drains terminate —
        supervision stays total even when the whole pool is gone."""
        from repro_torch.serve.workers import AllWorkersDead
        now = self.clock.now()
        if self.pool.live_count() == 0:
            err = AllWorkersDead("no live workers left in the pool")
            while True:
                plan = self._next_plan_locked()
                if plan is None:
                    return None
                for r in plan.requests:
                    self._fail_locked(r, err)
        skipped = []
        picked = None
        for _ in range(self.PLACEMENT_SCAN):
            plan = self._next_plan_locked()
            if plan is None:
                break
            worker = self.pool.place(plan, now)
            if worker is None:
                skipped.append(plan)
                continue
            picked = (plan, worker)
            break
        for plan in reversed(skipped):
            self._retry_queue.appendleft(plan)
        if picked is None and skipped:
            self.metrics.on_placement_skip()
        return picked

    def step(self) -> bool:
        """Assemble and execute at most one batch; False when nothing was
        dispatchable (idle, a partial batch is being held back, or — with a
        pool — no worker was admissible for anything assembled)."""
        with self._lock:
            worker = None
            if self.pool is None:
                plan = self._next_plan_locked()
            else:
                picked = self._next_dispatchable_locked()
                plan, worker = picked if picked else (None, None)
            if plan is None:
                return False
            t0 = self.clock.now()
            plan.worker = None if worker is None else worker.id
            for req in plan.requests:
                req.status = "dispatched"
                req.dispatch_t = t0
                req.worker = plan.worker
            self._inflight += len(plan.requests)
        if worker is None:
            self._execute(plan, t0)
        else:
            self.pool.dispatch(worker, plan, t0)
        return True

    # ------------------------------------------------------------------
    # supervised execution: retry -> watchdog -> bisection
    # ------------------------------------------------------------------
    def _call_executor(self, plan: BatchPlan, worker=None) -> list:
        if self.faults is not None:
            self.faults.on_dispatch(plan.model, plan.requests)
        call = self.executor if worker is None else worker.call
        return call(plan.model,
                    [r.payload for r in plan.requests],
                    plan.bucket)

    def _dispatch(self, plan: BatchPlan, t0: float, worker=None) -> list:
        """One executor attempt, watchdog-guarded when ``exec_timeout_s``
        is set: the call runs on a disposable worker thread joined with a
        real-time bound (a truly hung executor is abandoned — daemon
        thread, results discarded), and elapsed *engine-clock* time is
        checked afterwards so FakeClock-driven hangs trip the watchdog
        deterministically without any real waiting."""
        if self.exec_timeout_s is None:
            return self._call_executor(plan, worker)
        box: dict = {}

        def work():
            try:
                box["out"] = self._call_executor(plan, worker)
            except BaseException as e:               # noqa: BLE001
                box["err"] = e

        th = threading.Thread(target=work, daemon=True, name="vta-exec")
        th.start()
        th.join(None if isinstance(self.clock, FakeClock)
                else self.exec_timeout_s)
        if th.is_alive():
            raise ExecutorTimeout(
                f"executor still running after {self.exec_timeout_s}s "
                f"(batch of {plan.filled} for {plan.model!r} abandoned)")
        # budget expiry preempts whatever the call did afterwards — under a
        # real clock join(timeout) would have fired before any late error
        # or result was observed, so the FakeClock path must classify the
        # same way for the two clocks to replay identically
        elapsed = self.clock.now() - t0
        if elapsed > self.exec_timeout_s:
            raise ExecutorTimeout(
                f"executor took {elapsed:.3f}s on the engine clock "
                f"(> {self.exec_timeout_s}s watchdog budget)")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def _attempt(self, plan: BatchPlan,
                 worker=None) -> Optional[Exception]:
        """Run ``plan`` with bounded retry + exponential backoff on the
        engine clock. Returns None on success (requests resolved), else
        the last failure. With a pool worker, every attempt feeds the
        worker-level breaker (retries stay on the placed worker — only a
        requeue re-places) and the per-worker metrics; a ``WorkerDied``
        aborts immediately with no retry, since the worker cannot come
        back and the batch must re-place instead."""
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                with self._lock:
                    self.metrics.on_retry()
                    for r in plan.requests:
                        r.status = "retrying"
                self.clock.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
                with self._lock:
                    for r in plan.requests:
                        r.status = "dispatched"
            t_a = self.clock.now()
            try:
                outs = self._dispatch(plan, t_a, worker)
            except Exception as e:                   # noqa: BLE001
                if worker is not None:
                    from repro_torch.serve.workers import WorkerDied
                    if isinstance(e, WorkerDied):
                        return e
                    with self._lock:
                        worker.breaker.on_failure(self.clock.now())
                        self.metrics.on_worker_failure(
                            worker.id, self.clock.now() - t_a)
                if isinstance(e, ExecutorTimeout):
                    with self._lock:
                        self.metrics.on_timeout()
                last = e
                continue
            t1 = self.clock.now()
            with self._lock:
                if worker is not None:
                    worker.breaker.on_success(t1)
                    self.metrics.on_worker_batch(worker.id, plan.filled,
                                                 t1 - t_a)
                self.metrics.on_batch(plan.filled, plan.bucket, t1 - t_a)
                for req, out in zip(plan.requests, outs):
                    req.status = "done"
                    req.done_t = t1
                    req.result = out
                    self.metrics.on_complete(req.tenant,
                                             req.dispatch_t - req.arrival_t,
                                             t1 - req.arrival_t)
                    self.metrics.finished_at = t1
                    self._finish(req)
            return None
        return last

    def _requeue_plan_locked(self, plan: BatchPlan, err: Exception,
                             origin: str = "worker-requeue") -> None:
        """Requeue a batch *whole* at the retry-deque front (budgeted,
        deadline-checked). Used when the batch is innocent and its worker
        is not: a dead worker's in-flight and queued batches re-place onto
        the survivors without bisection."""
        keep = []
        now = self.clock.now()
        for r in plan.requests:
            if r.deadline is not None and r.deadline <= now:
                self._expire_locked(r)
            elif r.requeues >= self.requeue_budget:
                self._fail_locked(r, err, note="requeue budget "
                                  f"{self.requeue_budget} exhausted")
            else:
                r.requeues += 1
                r.status = "queued"
                r.worker = None
                keep.append(r)
        if keep:
            self.metrics.on_requeue(len(keep))
            self._retry_queue.appendleft(BatchPlan(
                model=plan.model, requests=keep,
                bucket=self.scheduler.bucket_for(len(keep)),
                origin=origin))

    def _requeue_dead_worker_plans(self, worker, plans: list) -> None:
        """Called by the pool's worker thread when its worker died with
        batches still queued on the inbox: every one goes back whole."""
        from repro_torch.serve.workers import WorkerDied
        err = WorkerDied(f"worker{worker.id} died with queued batches")
        with self._lock:
            for plan in plans:
                n = len(plan.requests)
                self._requeue_plan_locked(plan, err)
                self._inflight -= n

    def _execute(self, plan: BatchPlan, t0: float, worker=None) -> None:
        """Supervised execution: never raises. After retries are exhausted
        a multi-request batch is bisected — both halves requeued ahead of
        fresh work (budgeted, deadline-checked) — so a poisoned request is
        eventually isolated in a batch of one and failed alone. A
        ``WorkerDied`` instead requeues the batch whole (the batch is
        innocent, the worker is not) after the pool drops the dead
        worker's affinity entries, so the retry re-places on a survivor."""
        n = len(plan.requests)
        try:
            err = self._attempt(plan, worker)
            if err is None:
                return
            if worker is not None:
                from repro_torch.serve.workers import WorkerDied
                if isinstance(err, WorkerDied):
                    with self._lock:
                        self.pool.on_worker_death(worker)
                        self._requeue_plan_locked(plan, err)
                    return
            with self._lock:
                reqs = list(plan.requests)
                if len(reqs) == 1:
                    self._fail_locked(reqs[0], err)
                    return
                self.metrics.on_bisection()
                now = self.clock.now()
                mid = len(reqs) // 2
                for half in (reqs[:mid], reqs[mid:]):
                    keep = []
                    for r in half:
                        if r.deadline is not None and r.deadline <= now:
                            self._expire_locked(r)
                        elif r.requeues >= self.requeue_budget:
                            self._fail_locked(r, err, note="requeue budget "
                                              f"{self.requeue_budget} "
                                              "exhausted")
                        else:
                            r.requeues += 1
                            r.status = "queued"
                            keep.append(r)
                    if keep:
                        self.metrics.on_requeue(len(keep))
                        self._retry_queue.append(BatchPlan(
                            model=plan.model, requests=keep,
                            bucket=self.scheduler.bucket_for(len(keep)),
                            origin="bisect"))
        finally:
            with self._lock:
                self._inflight -= n

    def drain(self, max_batches: int = 10_000) -> int:
        """Serve until idle (or the safety cap); returns batches run. With
        ``max_wait_s`` holdback and a FakeClock, advances the clock past the
        holdback window instead of spinning."""
        n = 0
        while n < max_batches:
            if self.step():
                n += 1
                continue
            if self.pending() == 0:
                break
            # held-back partial batch: move time forward to its release
            self.clock.sleep(max(self.scheduler.max_wait_s, 1e-4))
        return n

    # ------------------------------------------------------------------
    # background driving (production)
    # ------------------------------------------------------------------
    def start(self, poll_interval_s: float = 0.001) -> None:
        assert self._thread is None, "engine already started"
        self._stop.clear()

        def loop():
            # supervised: _execute never raises, and even an unexpected
            # scheduler/metrics bug must not kill serving — count it,
            # back off one poll interval, keep going
            while not self._stop.is_set():
                try:
                    busy = self.step()
                except Exception:                    # noqa: BLE001
                    with self._lock:
                        self.metrics.on_loop_error()
                    busy = False
                if not busy:
                    self.clock.sleep(poll_interval_s)

        self._thread = threading.Thread(target=loop, name="vta-serve",
                                        daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        if self._thread is None:
            return
        if drain:
            while self.pending() > 0:
                self.clock.sleep(0.001)
        self._stop.set()
        self._thread.join()
        self._thread = None

    def close(self) -> None:
        """Release background resources: the serve loop (if running) and
        the worker pool's threads/child processes. Idempotent."""
        if self._thread is not None:
            self.stop(drain=False)
        if self.pool is not None:
            self.pool.shutdown()
