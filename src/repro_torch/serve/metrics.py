"""Serving metrics: per-request and per-batch counters + latency histograms.

Purely in-memory and allocation-light: the engine records every completed
request (queue wait, end-to-end latency, tenant) and every dispatched batch
(occupancy, bucket, execution wall time); ``snapshot()`` reduces them to
the report the benchmark and the CI smoke job consume (p50/p99 latency,
batch occupancy, images/sec).
"""
from __future__ import annotations

from dataclasses import dataclass, field


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    s = sorted(values)
    k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[k])


@dataclass
class Histogram:
    values: list = field(default_factory=list)

    def record(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def mean(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0

    def p(self, q: float) -> float:
        return percentile(self.values, q)

    def summary(self) -> dict:
        return {"count": self.count, "mean": round(self.mean, 6),
                "p50": round(self.p(50), 6), "p99": round(self.p(99), 6),
                "max": round(max(self.values), 6) if self.values else 0.0}


@dataclass
class TenantMetrics:
    submitted: int = 0
    completed: int = 0
    rejected: int = 0            # bounded-queue admission refusals
    shed: int = 0                # evicted by the shed_oldest policy
    expired: int = 0             # deadline passed before dispatch
    failed: int = 0              # execution failed after retry + bisection
    queue_wait: Histogram = field(default_factory=Histogram)
    latency: Histogram = field(default_factory=Histogram)

    def to_dict(self) -> dict:
        return {"submitted": self.submitted, "completed": self.completed,
                "rejected": self.rejected, "shed": self.shed,
                "expired": self.expired, "failed": self.failed,
                "queue_wait_s": self.queue_wait.summary(),
                "latency_s": self.latency.summary()}


@dataclass
class WorkerMetrics:
    """One pool worker's share of the serve traffic (serve/workers.py)."""
    dispatches: int = 0          # batches this worker executed successfully
    images: int = 0              # real requests in those batches
    failures: int = 0            # failed attempts (raises + watchdog trips)
    busy_s: float = 0.0          # engine-clock execution time accumulated
    deaths: int = 0              # worker.die events (0 or 1 per worker)

    def to_dict(self) -> dict:
        return {"dispatches": self.dispatches, "images": self.images,
                "failures": self.failures, "busy_s": round(self.busy_s, 6),
                "deaths": self.deaths}


@dataclass
class ServeMetrics:
    """The engine-wide registry. All times in seconds on the engine clock."""
    tenants: dict = field(default_factory=dict)    # name -> TenantMetrics
    batches: int = 0
    images: int = 0              # real requests dispatched (pad slots excluded)
    padded_slots: int = 0
    occupancy: Histogram = field(default_factory=Histogram)   # filled/bucket
    batch_exec_s: Histogram = field(default_factory=Histogram)
    started_at: float = 0.0
    finished_at: float = 0.0
    # -- reliability (supervised execution, serve/faults.py + breaker.py) --
    retries: int = 0             # batch re-attempts after an executor failure
    bisections: int = 0          # failed multi-request batches split in two
    requeues: int = 0            # requests re-enqueued by bisection/death
    timeouts: int = 0            # executor watchdog trips
    loop_errors: int = 0         # unexpected serve-loop exceptions survived
    fallbacks: dict = field(default_factory=dict)   # backend -> executions
    breaker_log: list = field(default_factory=list)  # (key, old, new)
    faults: dict = field(default_factory=dict)       # fault site -> fires
    # -- scale-out (worker pool, serve/workers.py) -------------------------
    workers: dict = field(default_factory=dict)      # id -> WorkerMetrics
    affinity_hits: int = 0       # placements routed to the key's owner
    affinity_cold: int = 0       # first placement of a key (unavoidable)
    affinity_reassigned: int = 0  # owner dead/open -> key moved (cache cold)
    placement_skips: int = 0     # dispatch deferred: no admissible worker

    def tenant(self, name: str) -> TenantMetrics:
        if name not in self.tenants:
            self.tenants[name] = TenantMetrics()
        return self.tenants[name]

    # -- recording hooks (called by the engine) ----------------------------
    def on_submit(self, tenant: str) -> None:
        self.tenant(tenant).submitted += 1

    def on_reject(self, tenant: str) -> None:
        self.tenant(tenant).rejected += 1

    def on_shed(self, tenant: str) -> None:
        self.tenant(tenant).shed += 1

    def on_expire(self, tenant: str) -> None:
        self.tenant(tenant).expired += 1

    def on_batch(self, filled: int, bucket: int, exec_s: float) -> None:
        self.batches += 1
        self.images += filled
        self.padded_slots += bucket - filled
        self.occupancy.record(filled / bucket)
        self.batch_exec_s.record(exec_s)

    def on_complete(self, tenant: str, queue_wait_s: float,
                    latency_s: float) -> None:
        t = self.tenant(tenant)
        t.completed += 1
        t.queue_wait.record(queue_wait_s)
        t.latency.record(latency_s)

    # -- reliability hooks -------------------------------------------------
    def on_fail(self, tenant: str) -> None:
        self.tenant(tenant).failed += 1

    def on_retry(self) -> None:
        self.retries += 1

    def on_bisection(self) -> None:
        self.bisections += 1

    def on_requeue(self, n: int = 1) -> None:
        self.requeues += n

    def on_timeout(self) -> None:
        self.timeouts += 1

    def on_loop_error(self) -> None:
        self.loop_errors += 1

    def on_fallback(self, backend: str) -> None:
        self.fallbacks[backend] = self.fallbacks.get(backend, 0) + 1

    def on_breaker(self, key: str, old: str, new: str) -> None:
        self.breaker_log.append((key, old, new))

    def on_fault(self, site: str) -> None:
        self.faults[site] = self.faults.get(site, 0) + 1

    # -- worker-pool hooks (serve/workers.py) ------------------------------
    def worker(self, wid: int) -> WorkerMetrics:
        if wid not in self.workers:
            self.workers[wid] = WorkerMetrics()
        return self.workers[wid]

    def on_worker_batch(self, wid: int, filled: int, exec_s: float) -> None:
        w = self.worker(wid)
        w.dispatches += 1
        w.images += filled
        w.busy_s += exec_s

    def on_worker_failure(self, wid: int, exec_s: float = 0.0) -> None:
        w = self.worker(wid)
        w.failures += 1
        w.busy_s += exec_s

    def on_worker_death(self, wid: int) -> None:
        self.worker(wid).deaths += 1

    def on_affinity(self, kind: str) -> None:
        assert kind in ("hit", "cold", "reassigned"), kind
        if kind == "hit":
            self.affinity_hits += 1
        elif kind == "cold":
            self.affinity_cold += 1
        else:
            self.affinity_reassigned += 1

    def on_placement_skip(self) -> None:
        self.placement_skips += 1

    @property
    def affinity_hit_rate(self) -> float:
        """Stickiness of warm placements: hits over (hits + reassignments).
        Cold first placements are excluded — a key must be compiled
        *somewhere* once; what the rate measures is how rarely a warm key
        is torn off its owner (1.0 = perfect stickiness)."""
        denom = self.affinity_hits + self.affinity_reassigned
        return self.affinity_hits / denom if denom else 1.0

    # -- reduction ---------------------------------------------------------
    def _all(self, attr: str) -> list:
        out: list = []
        for t in self.tenants.values():
            out.extend(getattr(t, attr).values)
        return out

    def snapshot(self) -> dict:
        """Reduce everything recorded to one JSON-serializable report.

        The ``"reliability"`` key (asserted by the CI chaos baseline) has a
        stable schema::

            {"retries": int,        # batch re-attempts after a failure
             "bisections": int,     # failed multi-request batches split
             "requeues": int,       # requests re-enqueued (bisection halves
                                    #  + whole batches off a dead worker)
             "timeouts": int,       # executor watchdog trips
             "loop_errors": int,    # serve-loop exceptions survived
             "fallbacks": {backend: dispatches served off-top-rung},
             "breaker_transitions": [[key, old_state, new_state], ...],
             "faults": {fault_site: fires}}

        ``"workers"`` is the scale-out section (all-zero without a pool):
        per-worker dispatch/failure/busy-time counters keyed by worker id,
        the affinity counters behind ``affinity_hit_rate``, and
        ``placement_skips`` (dispatches deferred because no worker was
        admissible — the placement analog of backpressure).
        """
        lat = self._all("latency")
        wait = self._all("queue_wait")
        wall = max(self.finished_at - self.started_at, 0.0)
        done = sum(t.completed for t in self.tenants.values())
        return {
            "requests": {
                "submitted": sum(t.submitted for t in self.tenants.values()),
                "completed": done,
                "rejected": sum(t.rejected for t in self.tenants.values()),
                "shed": sum(t.shed for t in self.tenants.values()),
                "expired": sum(t.expired for t in self.tenants.values()),
                "failed": sum(t.failed for t in self.tenants.values()),
            },
            "reliability": {
                "retries": self.retries,
                "bisections": self.bisections,
                "requeues": self.requeues,
                "timeouts": self.timeouts,
                "loop_errors": self.loop_errors,
                "fallbacks": dict(sorted(self.fallbacks.items())),
                "breaker_transitions": [list(t) for t in self.breaker_log],
                "faults": dict(sorted(self.faults.items())),
            },
            "latency_s": {"p50": round(percentile(lat, 50), 6),
                          "p99": round(percentile(lat, 99), 6),
                          "mean": round(sum(lat) / len(lat), 6) if lat else 0.0},
            "queue_wait_s": {"p50": round(percentile(wait, 50), 6),
                             "p99": round(percentile(wait, 99), 6)},
            "workers": {
                "per_worker": {str(k): v.to_dict()
                               for k, v in sorted(self.workers.items())},
                "affinity": {
                    "hits": self.affinity_hits,
                    "cold": self.affinity_cold,
                    "reassigned": self.affinity_reassigned,
                    "hit_rate": round(self.affinity_hit_rate, 4),
                },
                "placement_skips": self.placement_skips,
            },
            "batches": self.batches,
            "images": self.images,
            "padded_slots": self.padded_slots,
            "batch_occupancy": round(self.occupancy.mean, 4),
            "wall_s": round(wall, 6),
            "images_per_sec": round(done / wall, 2) if wall > 0 else 0.0,
            "per_tenant": {k: v.to_dict() for k, v in self.tenants.items()},
        }
