"""The port's circuit breakers and degradation ladder on the CPU.

Mirrors the breaker, ladder and chaos tests of tests/test_faults.py with
the port's modules: the ladder runs ``("torch-cpu", "numpy")`` with the
fault keyed ``gemm:torch`` on ``"torch-cpu"``, every output held bit-exact
(tolerance 0) to the numpy oracle of the JAX package and of the port. The
port's own ladder, ``DEGRADATION_LADDER = ("torch", "torch-cpu",
"numpy")``, cannot be built here: it names the card.
"""
import numpy as np
import pytest

from repro.serve.model import served_model as j_served_model
from repro_torch.serve.breaker import (CLOSED, HALF_OPEN, OPEN,
                                       AllBackendsFailed, CircuitBreaker,
                                       DegradingBackendExecutor)
from repro_torch.serve.clock import FakeClock
from repro_torch.serve.engine import VTAServeEngine
from repro_torch.serve.faults import FaultInjector, FaultPlan, FaultSpec
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.model import served_model
from repro_torch.vta.backend import DEGRADATION_LADDER, backend_kernel_impls


def _img(i, shape=(4,)):
    return np.full(shape, i % 100, np.int8)


class EchoExecutor:
    """Returns each payload unchanged; optionally burns fake time."""

    def __init__(self, clock=None, exec_s=0.0):
        self.clock, self.exec_s = clock, exec_s
        self.calls = []

    def __call__(self, model, images, bucket):
        self.calls.append((model, [np.array(p) for p in images], bucket))
        if self.clock is not None and self.exec_s:
            self.clock.advance(self.exec_s)
        return [np.array(p) for p in images]


def test_circuit_breaker_state_machine():
    br = CircuitBreaker("k", fail_threshold=2, cooldown_s=1.0)
    assert br.allow(0.0) and br.state == CLOSED
    br.on_failure(0.0)
    assert br.state == CLOSED
    br.on_failure(0.1)
    assert br.state == OPEN
    assert not br.allow(0.5)
    assert br.allow(1.2) and br.state == HALF_OPEN
    br.on_failure(1.2)
    assert br.state == OPEN
    assert not br.allow(1.5)
    assert br.allow(2.3) and br.state == HALF_OPEN
    br.on_success(2.3)
    assert br.state == CLOSED and br.consecutive_failures == 0
    assert br.transitions == [(CLOSED, OPEN), (OPEN, HALF_OPEN),
                              (HALF_OPEN, OPEN), (OPEN, HALF_OPEN),
                              (HALF_OPEN, CLOSED)]


def test_the_ladder_is_card_then_cpu_then_numpy():
    assert DEGRADATION_LADDER == ("torch", "torch-cpu", "numpy")
    assert backend_kernel_impls("torch-cpu") == (
        ("gemm", "torch"), ("alu_chain", "torch"), ("alu_sweep", "torch"))
    assert backend_kernel_impls("numpy") == ()
    with pytest.raises(RuntimeError, match="CUDA"):
        backend_kernel_impls("torch")


def test_ladder_degrades_and_recovers_bit_exact():
    """A ``gemm:torch`` fault that fires three times: the batches move to
    numpy and back, every output bit-equal to both numpy oracles, every
    step down counted."""
    m = served_model("mobilenet", "tiny")
    img = m.random_images(1, seed=21)[0]
    ref = m.run_single(img, backend="numpy")
    assert np.array_equal(
        ref, j_served_model("mobilenet", "tiny").run_single(img, "numpy"))
    clock = FakeClock()
    metrics = ServeMetrics()
    inj = FaultInjector(FaultPlan(seed=4, specs=(
        FaultSpec("kernel.impl", key="gemm:torch", times=3),)), clock=clock)
    ladder = DegradingBackendExecutor({"mobilenet": m}, ("torch-cpu", "numpy"),
                                      clock=clock, faults=inj, metrics=metrics,
                                      fail_threshold=2, cooldown_s=0.5)
    outs = []
    for _ in range(6):
        outs.append(ladder("mobilenet", [img], 1)[0])
        clock.advance(0.3)
    for out in outs:
        assert np.array_equal(out, ref)
    log = ladder.breaker_log()["torch-cpu"]
    assert log == ["closed->open", "open->half_open", "half_open->open",
                   "open->half_open", "half_open->closed"]
    assert ladder.breaker_states()["torch-cpu"] == CLOSED
    assert ladder.active_backend == "torch-cpu"
    assert metrics.fallbacks == {"numpy": 5}
    assert inj.summary() == {"kernel.impl": 3}


def test_ladder_all_rungs_failing_raises():
    m = served_model("mobilenet", "tiny")
    inj = FaultInjector(FaultPlan(specs=(
        FaultSpec("kernel.impl", key="*"),)), clock=FakeClock())

    class Broken:
        def __call__(self, *a):
            raise RuntimeError("down")

    ladder = DegradingBackendExecutor({"mobilenet": m}, ("numpy",),
                                      clock=FakeClock(), faults=inj)
    ladder.rungs[0].executor = Broken()
    with pytest.raises(AllBackendsFailed):
        ladder("mobilenet", [m.random_images(1)[0]], 1)


def test_card_rung_raises_a_real_fault_and_steps_down_only_when_injected():
    """A rung on a CUDA device (here ``"torch-cpu"`` marked so, since no
    card is present) raises a kernel build or launch error as it is, with
    its breaker untouched and no step down; an injected fault there still
    steps down, counted. A rung off the card steps down for any error."""
    from repro_torch.serve.faults import InjectedFault
    m = served_model("mobilenet", "tiny")
    img = m.random_images(1, seed=3)[0]
    ref = m.run_single(img, backend="numpy")
    assert [r.on_card for r in DegradingBackendExecutor(
        {"m": m}, ("torch-cpu", "numpy")).rungs] == [False, False]

    def ladder_failing_with(err, on_card):
        metrics = ServeMetrics()
        ladder = DegradingBackendExecutor({"m": m}, ("torch-cpu", "numpy"),
                                          clock=FakeClock(), metrics=metrics,
                                          fail_threshold=1)
        ladder.rungs[0].on_card = on_card

        def broken(*a):
            raise err
        ladder.rungs[0].executor = broken
        return ladder, metrics

    build = RuntimeError("nvcc failed for vta_gemm.cu")
    ladder, metrics = ladder_failing_with(build, on_card=True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ladder("m", [img], 1)
    assert metrics.fallbacks == {} and metrics.breaker_log == []
    assert ladder.breaker_log() == {"torch-cpu": [], "numpy": []}
    for err, on_card in ((InjectedFault("kernel.impl", "gemm:cuda"), True),
                         (build, False)):
        ladder, metrics = ladder_failing_with(err, on_card)
        assert np.array_equal(ladder("m", [img], 1)[0], ref)
        assert metrics.fallbacks == {"numpy": 1}
        assert ladder.breaker_log()["torch-cpu"] == ["closed->open"]


def test_rung_breakers_are_keyed_by_their_impls():
    ladder = DegradingBackendExecutor(
        {"m": served_model("mobilenet", "tiny")}, ("torch-cpu", "numpy"),
        key_prefix="w0:")
    assert [r.breaker.key for r in ladder.rungs] == [
        "w0:torch-cpu[gemm:torch,alu_chain:torch,alu_sweep:torch]",
        "w0:numpy[reference]"]


def test_chaos_replays_identically():
    plan = FaultPlan(seed=9, specs=(
        FaultSpec("executor.raise", prob=0.3, times=3),
        FaultSpec("payload.bitflip", prob=0.25, times=2),
        FaultSpec("executor.hang", times=1, after=3, hang_s=0.4),))

    def run():
        clock = FakeClock()
        eng = VTAServeEngine(clock=clock, executor=EchoExecutor(clock),
                             faults=FaultInjector(plan, clock=clock),
                             buckets=(1, 2, 4, 8), max_retries=1,
                             retry_backoff_s=0.01, exec_timeout_s=0.2)
        eng.add_tenant("a")
        tks = []
        for i in range(24):
            clock.advance(0.003)
            tks.append(eng.submit("a", "mn"[i % 2] * 2, _img(i)))
            if i % 3 == 2:
                eng.step()
        eng.drain()
        assert all(t.done() for t in tks)
        return ([t.status for t in tks], eng.faults.events(),
                eng.metrics.snapshot())

    assert run() == run()
