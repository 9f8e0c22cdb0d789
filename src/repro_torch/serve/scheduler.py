"""Continuous-batching scheduler: weighted fair, deadline-aware, bucketed.

The scheduler owns one ``BoundedQueue`` per tenant and assembles dynamic
batches for the execution backend. Its design constraints, in order:

* **Deterministic.** Every decision is a pure function of queue state and
  the injected clock's ``now`` — no wall-clock reads, no randomness, ties
  broken by tenant name. A fake clock replays any schedule exactly
  (tests/test_serve.py).

* **Starvation-free fairness.** Tenants are stride-scheduled: each lane
  carries a virtual ``pass`` value advanced by ``1/weight`` per dispatched
  request, and batch slots always go to the lowest-pass matching lane. A
  tenant with weight ``w`` gets a ``w``-proportional share under
  contention, and any backlogged tenant's pass eventually undercuts a
  flooding one's — no lane can starve. Re-activating lanes join at the
  current virtual time so idle tenants cannot hoard credit.

* **Batches are per (model, config) pair, padded to buckets.** One batch
  holds requests for a single served model only (one Program chain — one
  ``run_batched`` dispatch), filled from *all* tenants' matching heads, and
  is padded up to the smallest configured bucket size that fits. Buckets
  are what make XLA compiles reusable across batches: the jax backend keys
  its chunk cache on (trace structure, batch), so a handful of bucket sizes
  means a handful of compiles (see docs/serving.md).

* **Expired work is never dispatched.** Deadlines are checked at admission
  *and* at assembly; a request whose deadline passed while queued is
  dropped and surfaced, not executed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.serve.queues import (REJECT_NEW, Admission, BoundedQueue, Request)

DEFAULT_BUCKETS = (1, 2, 4, 8, 16)


@dataclass
class TenantLane:
    name: str
    queue: BoundedQueue
    weight: float = 1.0
    pass_value: float = 0.0      # stride-scheduling virtual time
    dispatched: int = 0

    @property
    def stride(self) -> float:
        return 1.0 / max(self.weight, 1e-9)


@dataclass
class BatchPlan:
    """One assembled dispatch: ``len(requests) <= bucket``; the pad slots
    (``bucket - len(requests)``) are dead weight the executor fills.
    ``origin`` distinguishes scheduler-assembled batches from the requeued
    kinds: ``"bisect"`` halves from failure bisection and
    ``"worker-requeue"`` whole batches handed back by a dead pool worker
    (engine.py). ``worker`` is stamped at placement when a worker pool is
    active (serve/workers.py); None under the single-executor engine."""
    model: str
    requests: list
    bucket: int
    origin: str = "scheduler"    # "scheduler" | "bisect" | "worker-requeue"
    worker: Optional[int] = None

    @property
    def filled(self) -> int:
        return len(self.requests)


@dataclass
class BatchScheduler:
    """State machine behind the engine. Not thread-safe by itself — the
    engine serializes access under its lock."""
    buckets: tuple = DEFAULT_BUCKETS
    queue_capacity: int = 64
    shed_policy: str = REJECT_NEW
    max_wait_s: float = 0.0      # hold a partial batch at most this long
    lanes: dict = field(default_factory=dict)    # tenant -> TenantLane
    virtual_time: float = 0.0    # pass of the most recently served lane

    def __post_init__(self):
        self.buckets = tuple(sorted(set(self.buckets)))
        assert self.buckets and all(b >= 1 for b in self.buckets)

    # ------------------------------------------------------------------
    # tenants + admission
    # ------------------------------------------------------------------
    def add_tenant(self, name: str, *, weight: float = 1.0,
                   capacity: Optional[int] = None) -> TenantLane:
        assert name not in self.lanes, f"tenant {name!r} already registered"
        assert weight > 0
        lane = TenantLane(name=name, weight=weight,
                          queue=BoundedQueue(capacity or self.queue_capacity,
                                             self.shed_policy))
        self.lanes[name] = lane
        return lane

    def lane(self, tenant: str) -> TenantLane:
        if tenant not in self.lanes:
            self.add_tenant(tenant)
        return self.lanes[tenant]

    def submit(self, req: Request, now: float) -> Admission:
        lane = self.lane(req.tenant)
        was_empty = len(lane.queue) == 0
        adm = lane.queue.push(req, now)
        if adm.accepted and was_empty:
            # join at the current virtual time: an idle lane must not bank
            # credit and then monopolize the backend on its return
            lane.pass_value = max(lane.pass_value, self.virtual_time)
        return adm

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def pending(self) -> int:
        return sum(len(ln.queue) for ln in self.lanes.values())

    def pending_for(self, model: str) -> int:
        return sum(1 for ln in self.lanes.values()
                   for r in ln.queue.items if r.model == model)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_bucket

    # ------------------------------------------------------------------
    # batch assembly
    # ------------------------------------------------------------------
    def _sorted_lanes(self) -> list:
        return [self.lanes[k] for k in sorted(self.lanes)]

    def _min_pass_lane(self, model: Optional[str] = None):
        """Lowest-pass lane with a pending head (optionally: whose head is
        for ``model``). Name order breaks ties — deterministic."""
        best = None
        for ln in self._sorted_lanes():
            head = ln.queue.head()
            if head is None or (model is not None and head.model != model):
                continue
            if best is None or ln.pass_value < best.pass_value:
                best = ln
        return best

    def next_batch(self, now: float) -> tuple:
        """(BatchPlan | None, expired requests). Purges deadline-expired
        work first; may return (None, [...]) when everything pending either
        expired or is being held back to fill a fuller bucket."""
        expired: list = []
        for ln in self._sorted_lanes():
            expired.extend(ln.queue.purge_expired(now))

        lead = self._min_pass_lane()
        if lead is None:
            return None, expired
        model = lead.queue.head().model

        # partial-batch holdback: with max_wait_s > 0, give a sub-max batch
        # a bounded chance to fill before burning a dispatch on it
        if self.max_wait_s > 0 and self.pending_for(model) < self.max_bucket:
            oldest = min(r.arrival_t for ln in self.lanes.values()
                         for r in ln.queue.items if r.model == model)
            if now - oldest < self.max_wait_s:
                return None, expired

        picked: list = []
        while len(picked) < self.max_bucket:
            ln = self._min_pass_lane(model)
            if ln is None:
                break
            req = ln.queue.pop()
            self.virtual_time = max(self.virtual_time, ln.pass_value)
            ln.pass_value += ln.stride
            ln.dispatched += 1
            picked.append(req)
        assert picked, "lead lane vanished mid-assembly"
        return BatchPlan(model=model, requests=picked,
                         bucket=self.bucket_for(len(picked))), expired
