"""The port's worker pool (repro_torch/serve/workers.py) on the CPU.

Mirrors tests/test_workers.py test for test: placement determinism, sticky
affinity, worker-death supervision and replay determinism on a FakeClock
with recording executors; the compile-reuse test becomes a capture-reuse
test on ``fsim_torch.capture_log()``; the process transport runs a spawned
child on ``"torch-cpu"``. Then what only the port has: the same seeded
chaos drill through the JAX package's pool and the port's gives the same
statuses, fault events, affinity map and breaker logs once backend names
are mapped; real ``"torch-cpu"`` workers on threads answer bit-exact
against the numpy oracle; the executor's plans are per capture scope, its
memos are built once under concurrent warm-up, and a capture records only
its own thread's launches. Every comparison is bit-exact (tolerance 0).
"""
import contextlib
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import (add_launch_counts, count_launch,
                                 launch_counts, reset_launch_counts, vta_gemm)
from repro_torch.serve.breaker import (CLOSED, HALF_OPEN, OPEN,
                                       DegradingBackendExecutor)
from repro_torch.serve.clock import FakeClock
from repro_torch.serve.engine import BackendExecutor, VTAServeEngine
from repro_torch.serve.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.serve.model import served_model
from repro_torch.serve.scheduler import BatchPlan
from repro_torch.serve.workers import WorkerPool
from repro_torch.vta import fsim_torch
from repro_torch.vta.backend import lowered
from repro_torch.vta.fsim_torch import TorchBackend

CPU_LADDER = ("torch-cpu", "numpy")


class RecordingFactory:
    """Per-worker recording executors sharing one call log."""

    def __init__(self, fail_for=()):
        self.calls = []              # (worker id, model, n images, bucket)
        self.fail_for = set(fail_for)

    def __call__(self, wid):
        def ex(model, images, bucket):
            self.calls.append((wid, model, len(images), bucket))
            if wid in self.fail_for:
                raise RuntimeError(f"worker{wid} injected failure")
            return [f"out:{p}" for p in images]
        return ex

    def workers_used(self, model=None):
        return {w for (w, m, _, _) in self.calls
                if model is None or m == model}


def _pool_engine(n=2, *, factory=None, faults=None, **kw):
    clock = FakeClock()
    factory = factory or RecordingFactory()
    pool = WorkerPool(n=n, transport="inline", clock=clock, faults=faults,
                      executor_factory=factory)
    eng = VTAServeEngine(clock=clock, faults=faults, workers=pool, **kw)
    eng.add_tenant("a")
    return eng, pool, factory, clock


def _plan(model, bucket=1):
    return BatchPlan(model=model, requests=[], bucket=bucket)


# ---------------------------------------------------------------------------
# placement unit tests (pool.place driven directly, no engine)
# ---------------------------------------------------------------------------
def test_cold_placement_least_loaded_lowest_id():
    def run():
        pool = WorkerPool(n=3, transport="inline", clock=FakeClock(),
                          executor_factory=RecordingFactory())
        return [pool.place(_plan(m), now=0.0).id
                for m in ("m1", "m2", "m3", "m4", "m1", "m2")]

    first, second = run(), run()
    assert first == second
    assert first == [0, 1, 2, 0, 0, 1]


def test_open_worker_skipped_and_half_open_gets_only_probe():
    pool = WorkerPool(n=2, transport="inline", clock=FakeClock(),
                      executor_factory=RecordingFactory(), cooldown_s=1.0)
    w0, w1 = pool.workers
    assert pool.place(_plan("m"), now=0.0) is w0
    for _ in range(3):
        w0.breaker.on_failure(0.0)
    assert w0.breaker.state == OPEN
    assert pool.place(_plan("m"), now=0.5) is w1
    assert pool.affinity_map()[("m", 1)] == 1
    assert pool.place(_plan("m2"), now=1.5) is w0
    assert w0.breaker.state == HALF_OPEN
    assert pool.place(_plan("m3"), now=1.5) is w1
    w0.breaker.on_success(1.6)
    assert w0.breaker.state == CLOSED
    assert pool.place(_plan("m4"), now=1.7) is w0


def test_busy_sticky_owner_defers_rather_than_reassigns():
    import queue
    pool = WorkerPool(n=2, transport="inline", clock=FakeClock(),
                      executor_factory=RecordingFactory())
    w0 = pool.workers[0]
    assert pool.place(_plan("m"), now=0.0) is w0
    w0.inbox = queue.Queue(maxsize=1)
    w0.inbox.put_nowait(("x", 0.0))
    assert pool.place(_plan("m"), now=0.1) is None
    assert pool.affinity_map()[("m", 1)] == 0


# ---------------------------------------------------------------------------
# engine integration on the inline transport (FakeClock)
# ---------------------------------------------------------------------------
def test_sticky_affinity_and_per_worker_metrics():
    eng, pool, fx, _ = _pool_engine(buckets=(1, 2, 4))
    tks = [eng.submit("a", "mA" if i % 2 else "mB", f"img{i}")
           for i in range(12)]
    eng.drain()
    assert all(t.ok for t in tks)
    assert len(fx.workers_used("mA")) == 1
    assert len(fx.workers_used("mB")) == 1
    assert fx.workers_used() == {0, 1}
    snap = eng.metrics.snapshot()["workers"]
    assert snap["affinity"]["cold"] == 2
    assert snap["affinity"]["reassigned"] == 0
    assert snap["affinity"]["hit_rate"] == 1.0
    per = snap["per_worker"]
    assert sum(w["images"] for w in per.values()) == 12
    assert all(w["failures"] == 0 and w["deaths"] == 0
               for w in per.values())


def test_worker_death_requeues_whole_batch_innocents_complete():
    inj = FaultInjector(FaultPlan(seed=3, specs=(
        FaultSpec("worker.die", key="0", times=1),)))
    eng, pool, fx, _ = _pool_engine(faults=inj, buckets=(1, 2, 4, 8))
    tks = [eng.submit("a", "m", f"img{i}") for i in range(6)]
    eng.drain()
    assert all(t.ok for t in tks), [t.status for t in tks]
    rel = eng.metrics.snapshot()["reliability"]
    assert rel["requeues"] == 6 and rel["bisections"] == 0
    snap = eng.metrics.snapshot()["workers"]
    assert snap["per_worker"]["0"]["deaths"] == 1
    assert snap["affinity"]["reassigned"] == 1
    assert (1, "m", 6, 8) in fx.calls
    assert not any(w == 0 for (w, _, _, _) in fx.calls)
    assert pool.live_count() == 1
    assert eng.pending() == 0


def test_all_workers_dead_fails_clean():
    inj = FaultInjector(FaultPlan(seed=3, specs=(FaultSpec("worker.die"),)))
    eng, pool, _, _ = _pool_engine(faults=inj, buckets=(1, 2, 4))
    tks = [eng.submit("a", "m", f"img{i}") for i in range(4)]
    eng.drain()
    assert pool.live_count() == 0
    assert all(t.status == "failed" for t in tks)
    assert all("AllWorkersDead" in t.request.error
               or "WorkerDied" in t.request.error for t in tks)
    assert eng.pending() == 0


def test_worker_stall_trips_watchdog_then_recovers():
    inj = FaultInjector(FaultPlan(seed=5, specs=(
        FaultSpec("worker.stall", key="0", times=1, hang_s=2.0),)))
    eng, pool, _, _ = _pool_engine(
        faults=inj, buckets=(1, 2), exec_timeout_s=0.5, max_retries=2)
    tks = [eng.submit("a", "m", f"img{i}") for i in range(2)]
    eng.drain()
    assert all(t.ok for t in tks)
    snap = eng.metrics.snapshot()
    assert snap["reliability"]["timeouts"] == 1
    assert snap["workers"]["per_worker"]["0"]["failures"] == 1
    assert pool.workers[0].breaker.state == CLOSED


def test_same_seed_chaos_runs_byte_identical():
    def run(seed):
        inj = FaultInjector(FaultPlan(seed=seed, specs=(
            FaultSpec("worker.die", key="0", after=3, times=1),
            FaultSpec("worker.stall", key="1", prob=0.4, times=2,
                      hang_s=1.0))))
        eng, pool, _, clock = _pool_engine(
            faults=inj, buckets=(1, 2, 4), exec_timeout_s=0.5)
        tks = []
        for i in range(16):
            clock.advance(0.003)
            tks.append(eng.submit("a", f"m{i % 2}", f"img{i}"))
            if i % 3 == 2:
                eng.step()
        eng.drain()
        snap = eng.metrics.snapshot()
        return json.dumps({
            "events": inj.events(),
            "statuses": sorted(t.status for t in tks),
            "workers": snap["workers"],
            "reliability": snap["reliability"],
            "breakers": pool.breaker_log(),
        }, sort_keys=True)

    assert run(11) == run(11)
    assert run(11) != run(12)


# ---------------------------------------------------------------------------
# real backend: sticky affinity keeps captures per-worker-warm
# ---------------------------------------------------------------------------
def test_affinity_capture_reuse_once_per_owning_worker():
    """Each (trace, chunk, bucket) is captured exactly once, under the
    scope of the worker that owns its (model, bucket) key, and a second
    identical wave captures nothing. Buckets 6 and 10 are used by no other
    test of the port, so no plan of theirs is warm."""
    models = {"resnet18": served_model("resnet18", "tiny"),
              "mobilenet": served_model("mobilenet", "tiny")}
    clock = FakeClock()
    pool = WorkerPool(n=2, transport="inline", clock=clock,
                      executor_factory=lambda wid: BackendExecutor(
                          models, "torch-cpu"))
    eng = VTAServeEngine(models, clock=clock, buckets=(6, 10), workers=pool)
    eng.add_tenant("a")
    outs = {}

    def wave():
        for model in ("resnet18", "mobilenet"):
            for b in (6, 10):
                imgs = models[model].random_images(b, seed=21)
                tks = [eng.submit("a", model, img) for img in imgs]
                eng.drain()
                outs[(model, b)] = (imgs, [t.result() for t in tks])

    fsim_torch.reset_capture_log()
    wave()
    assert pool.affinity_map() == {("resnet18", 6): 0, ("resnet18", 10): 1,
                                   ("mobilenet", 6): 0, ("mobilenet", 10): 1}
    log = fsim_torch.capture_log()
    assert log and all(count == 1 for count in log.values()), log
    # (trace key, chunk, arg shapes, batch, scope)
    assert {(sig[3], sig[4]) for sig in log} \
        == {(6, "worker0"), (10, "worker1")}
    before = sum(log.values())
    wave()
    assert sum(fsim_torch.capture_log().values()) == before
    snap = eng.metrics.snapshot()["workers"]
    assert snap["affinity"]["reassigned"] == 0
    assert snap["affinity"]["hit_rate"] == 1.0
    for (model, _), (imgs, got) in outs.items():
        want = models[model].run_batch(imgs, "numpy")
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_process_transport_smoke():
    m = served_model("mobilenet", "tiny")
    pool = WorkerPool(n=1, transport="process", backend="torch-cpu",
                      process_specs={"mobilenet": ("mobilenet", "tiny")})
    eng = VTAServeEngine({"mobilenet": m}, workers=pool)
    eng.add_tenant("a")
    imgs = m.random_images(2, seed=9)
    tks = [eng.submit("a", "mobilenet", img) for img in imgs]
    try:
        eng.drain()
        deadline = time.time() + 120
        while eng.pending() and time.time() < deadline:
            time.sleep(0.01)
        assert all(t.ok for t in tks), [t.status for t in tks]
        for img, tk in zip(imgs, tks):
            ref = m.run_single(img, backend="numpy")
            assert np.array_equal(np.asarray(tk.result()), ref)
        about = pool.workers[0].executor.describe()
        assert about["backend"] == "torch-cpu"
        assert about["device_name"] == "cpu"
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the port against the JAX package's pool, and on real threads
# ---------------------------------------------------------------------------
def _chaos_drill(pkg: str):
    """One seeded chaos drill on the inline transport, FakeClock: two
    models, two workers with their own ladders over the package's CPU
    backends, a worker death, stalls and a persistent top-rung GEMM fault
    that runs out. Returns what the run decided, backend names as given."""
    if pkg == "jax":
        from repro.serve import (clock as clocks, engine, faults, metrics,
                                 model, workers)
        ladder, top_impl = ("jax", "numpy"), "gemm:einsum"
    else:
        from repro_torch.serve import (clock as clocks, engine, faults,
                                       metrics, model, workers)
        ladder, top_impl = CPU_LADDER, "gemm:torch"
    models = {k: model.served_model(k, "tiny")
              for k in ("resnet18", "mobilenet")}
    # each engine's own FakeClock: its watchdog then waits on the clock
    clock = clocks.FakeClock()
    inj = faults.FaultInjector(faults.FaultPlan(seed=17, specs=(
        faults.FaultSpec("worker.die", key="0", after=2, times=1),
        faults.FaultSpec("worker.stall", key="1", prob=0.5, times=2,
                         hang_s=1.0),
        faults.FaultSpec("kernel.impl", key=top_impl, times=4))),
        clock=clock)
    counters = metrics.ServeMetrics()
    pool = workers.WorkerPool(models, 2, transport="inline", clock=clock,
                              faults=inj, metrics=counters, ladder=ladder)
    eng = engine.VTAServeEngine(models, clock=clock, faults=inj,
                                metrics=counters, buckets=(1, 2, 4),
                                exec_timeout_s=0.5, workers=pool)
    eng.add_tenant("a")
    imgs = models["resnet18"].random_images(12, seed=2)
    mimgs = models["mobilenet"].random_images(12, seed=3)
    tks = []
    for i in range(12):
        clock.advance(0.2)
        name, src = ("resnet18", imgs) if i % 3 else ("mobilenet", mimgs)
        tks.append(eng.submit("a", name, src[i]))
        if i % 2:
            eng.step()
    eng.drain()
    snap = eng.metrics.snapshot()
    return dict(
        statuses=[t.status for t in tks],
        outputs=[np.asarray(t.result()) if t.ok else None for t in tks],
        events=inj.events(),
        affinity=pool.affinity_map(),
        workers=pool.breaker_log(),
        rungs=[w.executor.breaker_log() for w in pool.workers],
        fallbacks=snap["reliability"]["fallbacks"])


def test_chaos_drill_matches_the_jax_pool():
    pytest.importorskip("jax")
    ref, got = _chaos_drill("jax"), _chaos_drill("torch")
    names = {"jax": "torch-cpu", "numpy": "numpy"}
    assert got["statuses"] == ref["statuses"]
    assert "done" in got["statuses"]
    assert all((a is None and b is None) or np.array_equal(a, b)
               for a, b in zip(got["outputs"], ref["outputs"]))
    for ev in ref["events"]:
        ev["key"] = ev["key"].replace("gemm:einsum", "gemm:torch")
    assert got["events"] == ref["events"]
    assert any(ev["site"] == "kernel.impl" for ev in got["events"])
    assert any(ev["site"] == "worker.die" for ev in got["events"])
    assert got["affinity"] == ref["affinity"]
    assert got["workers"] == ref["workers"]
    assert got["rungs"] == [{names[k]: v for k, v in r.items()}
                            for r in ref["rungs"]]
    assert got["fallbacks"] == {names[k]: v
                                for k, v in ref["fallbacks"].items()}
    assert got["fallbacks"].get("numpy", 0) > 0


def test_thread_workers_answer_bit_exact():
    """Two thread workers with real ``"torch-cpu"`` ladders serve two
    models at once: every answer equals the numpy oracle, each key sticks
    to one worker, nothing steps down the ladder."""
    models = {"resnet18": served_model("resnet18", "tiny"),
              "mobilenet": served_model("mobilenet", "tiny")}
    eng = VTAServeEngine(models, buckets=(1, 2, 4), workers=WorkerPool(
        models, 2, transport="thread", ladder=CPU_LADDER))
    try:
        imgs = {k: m.random_images(8, seed=5) for k, m in models.items()}
        tks = [(k, i, eng.submit("a", k, imgs[k][i]))
               for i in range(8) for k in models]
        eng.drain()
        want = {k: m.run_batch(imgs[k], "numpy") for k, m in models.items()}
        for k, i, t in tks:
            assert np.array_equal(t.result(timeout=60), want[k][i])
        snap = eng.metrics.snapshot()
        assert snap["reliability"]["fallbacks"] == {}
        assert snap["workers"]["affinity"]["reassigned"] == 0
        assert all(w.stream is None for w in eng.pool.workers)
    finally:
        eng.close()


def test_reset_metrics_keeps_counting_step_downs():
    """A step down the ladder after ``reset_metrics`` lands in the new
    metrics: the engine rewires each worker's ladder too."""
    m = served_model("mobilenet", "tiny")
    clock = FakeClock()
    inj = FaultInjector(FaultPlan(specs=(
        FaultSpec("kernel.impl", key="gemm:torch", times=1),)), clock=clock)
    eng = VTAServeEngine({"m": m}, clock=clock, buckets=(1,), workers=WorkerPool(
        {"m": m}, 1, transport="inline", clock=clock, faults=inj,
        ladder=CPU_LADDER))
    fresh = eng.reset_metrics()
    t = eng.submit("a", "m", m.random_images(1, seed=1)[0])
    eng.drain()
    assert t.ok and fresh.fallbacks == {"numpy": 1}
    assert eng.pool.workers[0].executor.metrics is fresh


def test_default_ladder_raises_without_cuda():
    """The default ladder names ``"torch"``: where there is no CUDA device
    the pool raises, never dropping the rung."""
    assert not torch.cuda.is_available()
    m = {"m": served_model("mobilenet", "tiny")}
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerPool(m, 1, transport="inline")
    with pytest.raises(RuntimeError, match="CUDA"):
        DegradingBackendExecutor(m)
    with pytest.raises(RuntimeError, match="CUDA"):
        VTAServeEngine(m, workers=1, worker_transport="inline")


# ---------------------------------------------------------------------------
# the executor under several workers
# ---------------------------------------------------------------------------
def _program_and_inputs(batch=2):
    m = served_model("resnet18", "tiny")
    seg = m.segments[0]
    shapes = dict(m.shapes) | {k: v.shape for k, v in m.weights.items()}
    shared = {k: m.weights[k] for k in seg.reads if k in m.weights}
    rng = np.random.default_rng(4)
    batched = {k: rng.integers(-32, 32, (batch,) + m.shapes[k],
                               dtype=np.int8)
               for k in set(seg.reads) | set(seg.writes)
               if k not in m.weights}
    return m, seg.program, shapes, shared, batched


def test_plans_are_per_capture_scope():
    """Two scopes on one key get distinct buffers (and one capture each);
    releasing a scope drops only its plans."""
    m, prog, _, shared, batched = _program_and_inputs(batch=7)
    be = TorchBackend(device="cpu")
    fsim_torch.reset_capture_log()
    outs = {}
    for label in ("scope-a", "scope-b"):
        prev = fsim_torch.set_capture_scope(label)
        try:
            outs[label] = be.run_batched(prog, m.hw, shared=shared,
                                         batched=batched)
        finally:
            fsim_torch.set_capture_scope(prev)
    trace = lowered(prog, m.hw, {k: v.shape for k, v in shared.items()}
                    | {k: v.shape[1:] for k, v in batched.items()})
    plans = {sig[0]: p for sig, (_, p) in trace.__dict__["_torch_plans"]
             .items() if sig[0] in ("scope-a", "scope-b")}
    assert set(plans) == {"scope-a", "scope-b"}
    a, b = plans["scope-a"], plans["scope-b"]
    for k in ("inp", "wgt", "acc"):
        assert a.st[k].data_ptr() != b.st[k].data_ptr()
    assert {sig[4] for sig in fsim_torch.capture_log()} \
        == {"scope-a", "scope-b"}
    for t in outs["scope-a"]:
        assert torch.equal(outs["scope-a"][t], outs["scope-b"][t])
    assert fsim_torch.release_capture_scope("scope-a") == 1
    left = {sig[0] for sig in trace.__dict__["_torch_plans"]}
    assert "scope-a" not in left and "scope-b" in left
    assert fsim_torch.release_capture_scope("scope-b") == 1


def test_concurrent_warmup_builds_each_memo_once(monkeypatch):
    """Two threads warming the same Trace at once (two workers' first
    dispatches of one model at two buckets) end with one ``_torch_ops``
    entry and one chunk list, which both were given. The build is slowed
    so that, unlocked, the threads would overlap in it."""
    m, prog, shapes, _, _ = _program_and_inputs()
    trace = lowered(prog, m.hw, shapes)
    for k in ("_torch_ops", "_torch_chunks"):
        trace.__dict__.pop(k, None)
    winners = fsim_torch._winners

    def slow_winners(*a, **kw):
        time.sleep(0.002)
        return winners(*a, **kw)

    monkeypatch.setattr(fsim_torch, "_winners", slow_winners)
    be = TorchBackend(device="cpu")
    start = threading.Barrier(2)
    got = [None, None]

    def warm(i):
        start.wait()
        got[i] = be.chunks(trace)

    threads = [threading.Thread(target=warm, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got[0] is got[1]
    assert len(trace.__dict__["_torch_ops"]) == 1
    assert len(trace.__dict__["_torch_chunks"]) == 1


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a capture on the CPU."""

    def capture_begin(self, pool=None, capture_error_mode=None):
        pass

    def capture_end(self):
        pass


def test_capture_records_only_its_own_thread(monkeypatch):
    """``TorchBackend._capture`` with the CUDA graph calls stubbed: while
    this thread captures a chunk (its wrapper counting two launches of the
    GEMM), another thread replays a graph (``add_launch_counts``) and
    launches once itself. The capture records 2, the counters hold the
    other thread's 6, and nothing is subtracted from them."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            synchronize=lambda: None))
    monkeypatch.setattr(torch.cuda, "default_stream", lambda device=None: None)
    be = TorchBackend(device="cpu")
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait()
        add_launch_counts({"gemm": 5})
        count_launch(vta_gemm.LAUNCHES, "gemm")
        done.set()

    def run_chunk(st, chunks, i):
        count_launch(vta_gemm.LAUNCHES, "gemm")
        go.set()
        done.wait()
        count_launch(vta_gemm.LAUNCHES, "gemm")

    monkeypatch.setattr(be, "_run_chunk", run_chunk)
    plan = types.SimpleNamespace(st={}, pool=None, graphs=None, chunks=None)
    reset_launch_counts()
    th = threading.Thread(target=other)
    th.start()
    be._capture(plan, [("chunk",)])
    th.join()
    assert [launches for _, launches in plan.graphs] == [{"gemm": 2}]
    assert launch_counts()["gemm"] == 6
    assert plan.chunks == [("chunk",)]


def test_capture_stream_is_the_workers_own(monkeypatch):
    """A thread on a stream of its own (a serving worker) captures on it;
    a thread on the default stream captures on one side stream that it
    makes once and keeps; another thread gets another. No capture takes a
    fresh pooled stream, which could be another worker's."""
    made = []

    def make(device=None):
        made.append(types.SimpleNamespace(cuda_stream=len(made) + 1))
        return made[-1]

    default, worker = object(), object()
    current = threading.local()
    monkeypatch.setattr(torch.cuda, "Stream", make)
    monkeypatch.setattr(fsim_torch, "_STREAM_OWNERS", {})
    monkeypatch.setattr(torch.cuda, "default_stream", lambda device=None:
                        default)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        getattr(current, "s", default))
    monkeypatch.setattr(fsim_torch._SCOPE, "side_streams", {},
                        raising=False)
    dev = torch.device("cuda", 0)
    current.s = worker
    assert fsim_torch._capture_stream(dev) is worker and made == []
    current.s = default
    side = fsim_torch._capture_stream(dev)
    assert fsim_torch._capture_stream(dev) is side and made == [side]
    got = []
    th = threading.Thread(target=lambda: got.append(
        fsim_torch._capture_stream(dev)))
    th.start()
    th.join()
    assert got[0] is not side and made == [side, got[0]]


def test_stream_registry_keeps_owners_apart(monkeypatch):
    """PyTorch hands its 32 pooled streams out in turn. Two pools of card
    workers alive at once, with 30 unregistered streams drawn between them
    (the pool wraps around), and a thread capturing from the default
    stream, never share a stream; the 33rd owner raises; a stopped pool's
    and an ended thread's streams are free again."""
    pooled = [types.SimpleNamespace(cuda_stream=0x100 + i)
              for i in range(fsim_torch.POOLED_STREAMS)]
    turn = iter(range(10 ** 6))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: pooled[
        next(turn) % len(pooled)])
    default = types.SimpleNamespace(cuda_stream=0)
    monkeypatch.setattr(torch.cuda, "default_stream",
                        lambda device=None: default)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: default)
    monkeypatch.setattr(fsim_torch, "_STREAM_OWNERS", {})
    dev = torch.device("cuda", 0)
    monkeypatch.setattr("repro_torch.serve.workers._card_device",
                        lambda executor: dev)

    def pool():
        return WorkerPool(n=2, transport="inline", clock=FakeClock(),
                          executor_factory=RecordingFactory())

    first = pool()
    for _ in range(30):
        torch.cuda.Stream(dev)
    second = pool()
    got = []
    th = threading.Thread(target=lambda: got.append(
        fsim_torch._capture_stream(dev)))
    th.start()
    th.join(timeout=5)
    assert not th.is_alive()
    streams = [w.stream.cuda_stream for p in (first, second)
               for w in p.workers] + [got[0].cuda_stream]
    assert len(set(streams)) == 5
    del got, th
    import gc
    gc.collect()                       # the ended thread's stream is free
    assert len(fsim_torch._STREAM_OWNERS) == 4
    rest = [fsim_torch.claim_stream(dev, f"owner{i}") for i in range(28)]
    assert len({s.cuda_stream for s in rest} | set(streams[:4])) == 32
    with pytest.raises(RuntimeError, match="all 32 pooled CUDA streams"):
        fsim_torch.claim_stream(dev, "owner33")
    second.shutdown()
    again = {fsim_torch.claim_stream(dev, "after").cuda_stream
             for _ in range(2)}
    assert again == set(streams[2:4])


def test_counters_survive_concurrent_updates():
    """Launch counts and the dispatch counter under 16 threads with a
    shortened switch interval: no update is lost."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    reps, n = 2000, 16

    def work():
        for _ in range(reps):
            count_launch(vta_gemm.LAUNCHES, "gemm")
            add_launch_counts({"gemm": 1})
            fsim_torch._count_dispatch()

    try:
        reset_launch_counts()
        fsim_torch.reset_kernel_launch_log()
        threads = [threading.Thread(target=work) for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert launch_counts()["gemm"] == 2 * n * reps
    assert fsim_torch.kernel_launch_log() == n * reps
