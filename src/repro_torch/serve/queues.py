"""Request objects + bounded per-tenant queues for the serving engine.

A ``Request`` is one inference call: a single int8 image for a named served
model, owned by a tenant. Queues are strictly per-tenant and bounded:
admission control (capacity + deadline) happens at ``push`` time so a
flooding tenant can only ever displace its *own* traffic — cross-tenant
isolation is the scheduler's fairness job (serve/scheduler.py), not the
queue's.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

# shed policies for a full tenant queue
REJECT_NEW = "reject"            # refuse the incoming request (backpressure)
SHED_OLDEST = "shed_oldest"      # evict the tenant's oldest queued request
SHED_POLICIES = (REJECT_NEW, SHED_OLDEST)


@dataclass(eq=False)          # identity equality: payloads are arrays
class Request:
    """One queued inference request (mutable: the engine stamps progress)."""
    id: int
    tenant: str
    model: str                   # served-model key, e.g. "resnet18"
    payload: object              # (1, C, H, W) int8 image
    arrival_t: float = 0.0
    deadline: Optional[float] = None   # absolute engine-clock time
    # engine-stamped lifecycle (full state machine in docs/serving.md):
    # queued -> dispatched -> done, with supervision detours through
    # retrying (backoff between attempts) and back to queued (bisection
    # requeue); terminal: done|failed|rejected|shed|expired
    status: str = "queued"
    dispatch_t: float = -1.0
    done_t: float = -1.0
    result: object = None
    error: Optional[str] = None
    requeues: int = 0            # bisection requeues consumed (budgeted)
    worker: Optional[int] = None  # pool worker that dispatched it (if any)


@dataclass
class Admission:
    """Outcome of a ``push``: was the request queued, and at whose cost."""
    accepted: bool
    reason: Optional[str] = None      # "queue_full" | "deadline_expired"
    shed: Optional[Request] = None    # victim evicted by SHED_OLDEST


@dataclass
class BoundedQueue:
    """FIFO with a hard capacity and an explicit overflow policy."""
    capacity: int
    policy: str = REJECT_NEW
    items: deque = field(default_factory=deque)

    def __post_init__(self):
        assert self.capacity >= 1
        assert self.policy in SHED_POLICIES, self.policy

    def __len__(self) -> int:
        return len(self.items)

    def push(self, req: Request, now: float) -> Admission:
        if req.deadline is not None and req.deadline <= now:
            req.status = "rejected"
            req.error = "deadline_expired"
            return Admission(False, reason="deadline_expired")
        if len(self.items) >= self.capacity:
            if self.policy == REJECT_NEW:
                req.status = "rejected"
                req.error = "queue_full"
                return Admission(False, reason="queue_full")
            victim = self.items.popleft()
            victim.status = "shed"
            victim.error = "queue_full"
            self.items.append(req)
            return Admission(True, shed=victim)
        self.items.append(req)
        return Admission(True)

    def head(self) -> Optional[Request]:
        return self.items[0] if self.items else None

    def pop(self) -> Request:
        return self.items.popleft()

    def purge_expired(self, now: float) -> list:
        """Remove (in order) every queued request whose deadline has passed.
        Expired work is never dispatched — dropping it here is what keeps a
        deadline miss from also wasting accelerator time."""
        expired = [r for r in self.items
                   if r.deadline is not None and r.deadline <= now]
        if expired:
            self.items = deque(r for r in self.items if r not in expired)
            for r in expired:
                r.status = "expired"
                r.error = "deadline_expired"
        return expired
