"""The port's roofline and collective accounting (repro_torch/core/roofline,
analysis/{roofline,collectives}, launch/dryrun.DeviceCost) against the JAX
package's and against bytes and flops known by hand.

Mirrors ``tests/test_analysis.py``'s roofline tests (``tpu_terms`` as
``h100_terms``), ``model_flops`` equal to the JAX package's for every
runnable cell, and the VTA roofline. The reference's HLO tests
(``shape_bytes``, ``parse_collectives``) have no counterpart: the port
counts collectives from dispatch, which the fake-mesh tests below check
instead. Tolerance: 0 (byte and flop counts are integers).
"""
import pytest
import torch

from repro.analysis.roofline import model_flops as j_model_flops
from repro.configs import ARCHS as J_ARCHS
from repro.core.dse import make_config as j_make_config
from repro.core.roofline import vta_attainable as j_vta_attainable
from repro_torch.analysis import roofline as troofline
from repro_torch.analysis.collectives import CollectiveCounter
from repro_torch.analysis.roofline import model_flops
from repro_torch.configs import ARCHS
from repro_torch.core.area_model import area_breakdown, scaled_area
from repro_torch.core.dse import make_config
from repro_torch.core.roofline import (HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS,
                                       h100_terms, vta_attainable,
                                       vta_bounds, vta_roofline_point)
from repro_torch.launch.dryrun import DeviceCost, runnable_cells
from repro_torch.launch.mesh import (destroy_process_group, init_process_group,
                                     make_mesh)


@pytest.fixture
def mesh24():
    """A (2, 4) mesh on a fake process group of 8 ranks, destroyed after."""
    init_process_group("fake", 8)
    yield make_mesh((2, 4), ("data", "model"), device_type="cpu")
    destroy_process_group()


def test_h100_terms_math():
    t = h100_terms(PEAK_FLOPS, HBM_BW, 0.0)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.dominant in ("compute", "memory")
    t2 = h100_terms(1e12, 1e9, 200e9 * 4)
    assert t2.dominant == "collective"
    assert 0 < t2.fraction_of_roofline() < 1
    assert (PEAK_FLOPS, HBM_BW) == (989e12, 3.35e12)
    # NVLink inside one 8-GPU node, InfiniBand across nodes
    assert h100_terms(0, 0, NVLINK_BW, n_devices=8).collective_s == 1.0
    assert h100_terms(0, 0, IB_BW, n_devices=256).collective_s == 1.0


def test_model_flops_scaling():
    dense = model_flops(ARCHS["qwen3-0.6b"], "train_4k")
    n = ARCHS["qwen3-0.6b"].active_param_count()
    assert dense >= 6 * n * 256 * 4096
    moe = ARCHS["mixtral-8x22b"]
    assert model_flops(moe, "train_4k") < 6 * moe.param_count() * 256 * 4096
    pf = model_flops(ARCHS["qwen3-0.6b"], "prefill_32k")
    dc = model_flops(ARCHS["qwen3-0.6b"], "decode_32k")
    assert dc < pf


@pytest.mark.parametrize("cell", runnable_cells(), ids="/".join)
def test_model_flops_matches_jax(cell):
    arch, shape = cell
    assert model_flops(ARCHS[arch], shape) == j_model_flops(J_ARCHS[arch],
                                                            shape)


def test_vta_roofline_and_area():
    hw = make_config(4, 8, 1)
    peak, bw = vta_bounds(hw)
    assert peak == 2 * 256
    assert vta_attainable(hw, 1e9) == peak
    assert vta_attainable(hw, 1.0) == bw
    for x in (0.25, 1.0, 7.0, 1e9):
        assert vta_attainable(hw, x) == j_vta_attainable(
            j_make_config(4, 8, 1), x)
    assert vta_roofline_point(10, 5, 4) == {"ops_per_byte": 5.0,
                                            "ops_per_cycle": 4.0}
    big = make_config(6, 64, 1)
    ratio = scaled_area(big, hw)
    assert 8 < ratio < 16
    bd = area_breakdown(hw)
    assert bd["sram"] > bd["mac"]


def test_long_context_skip_rule():
    cells = runnable_cells()
    longs = {a for a, s in cells if s == "long_500k"}
    assert longs == {"rwkv6-1.6b", "recurrentgemma-9b", "mixtral-8x22b",
                     "gemma2-27b"}
    assert len(cells) == 10 * 3 + 4


def test_roofline_row_takes_counts_as_they_are():
    """No depth extrapolation and no x grad_accum: a cell's terms are its
    JSON's numbers over the H100 constants."""
    res = {"arch": "qwen2.5-32b", "shape": "train_4k", "chips": 256,
           "flops_per_device": 989e12, "hbm_bytes_per_device": 6.7e12,
           "collectives": {"total_bytes": 25e9}, "compile_s": 1.0,
           "memory": {"peak_est_bytes": 2 ** 31}, "n_groups": 64}
    row = troofline.roofline_of(res, ARCHS["qwen2.5-32b"])
    assert row.terms.compute_s == 1.0 and row.terms.memory_s == 2.0
    assert row.terms.collective_s == 0.5 and row.terms.dominant == "memory"
    assert row.peak_hbm_gib == 2.0
    assert row.model_flops_total == model_flops(ARCHS["qwen2.5-32b"],
                                                "train_4k")
    assert "qwen2.5-32b" in troofline.format_table([row])


# --------------------------------------------------------------------------
# collectives and per-device flops on a (2, 4) fake mesh
# --------------------------------------------------------------------------
def test_collective_counter_fsdp_matmul(mesh24):
    """An FSDP matmul: the weight (64, 32) f32 sharded on "data" is
    gathered (operand: the 32 x 32 shard, 4096 bytes), and its gradient
    reduce-scattered back (operand: the whole 64 x 32 gradient, 8192
    bytes), both over "data"; a start and its wait count once."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh24,
                          [Shard(0), Replicate()]).requires_grad_()
    x = distribute_tensor(torch.empty(16, 64, device="meta"), mesh24,
                          [Shard(0), Replicate()])
    with CollectiveCounter(mesh24) as c:
        y = x @ w.redistribute(mesh24, [Replicate(), Replicate()])
        y.sum().backward()
    assert list(w.grad.placements) == [Shard(0), Replicate()]
    assert c.stats.to_dict() == {
        "total_bytes": 4096 + 8192,
        "bytes_by_kind": {"all-gather": 4096, "reduce-scatter": 8192},
        "count_by_kind": {"all-gather": 1, "reduce-scatter": 1},
        "bytes_by_axis": {"data": 4096 + 8192}}


def test_per_device_flops_count_local_shapes(mesh24):
    """A replicated matmul counts whole on each device; one sharded over
    all 8 ranks counts its shard: 1/8. Ops DTensor runs on fake tensors to
    propagate shapes are not counted, and views move no bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    full = 2 * 64 * 128 * 32

    def run(placements):
        a = distribute_tensor(torch.empty(64, 128, device="meta"), mesh24,
                              placements)
        b = distribute_tensor(torch.empty(128, 32, device="meta"), mesh24,
                              [Replicate(), Replicate()])
        cost = DeviceCost(mesh24, (a, b))
        with cost:
            out = (a @ b).t()
        return cost, out
    cost, out = run([Replicate(), Replicate()])
    assert cost.flops == full and cost.stats.total_bytes == 0
    assert cost.hbm_bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert cost.peak == 64 * 32 * 4
    cost, out = run([Shard(0), Shard(0)])
    assert cost.flops == full // 8
    assert tuple(out.to_local().shape) == (32, 8)
    assert cost.peak == 8 * 32 * 4 and cost.alias_bytes(out) == 0


def test_device_cost_live_bytes_and_aliases(mesh24):
    """The live-bytes peak counts what is alive at once: a temporary freed
    before the next allocation does not add; an output written into an
    argument is an alias."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    a = distribute_tensor(torch.empty(256, device="meta"), mesh24,
                          [Replicate(), Replicate()])
    cost = DeviceCost(mesh24, (a,))
    with cost:
        for _ in range(3):
            t = a * 2          # 1 KiB, freed before the next
            del t
        assert cost.peak == 1024 and cost.live == 0
        keep = [a * 2, a * 3]
        assert cost.peak == 2 * 1024 == cost.live
        a.add_(1.0)
    assert cost.alias_bytes((a, keep)) == 1024


def test_sweep_and_hillclimb_runners():
    """The sweep runs every cell once at full depth on each mesh (no
    d1/d2 probes: nothing is extrapolated), and the hillclimb's summary
    takes a variant's terms from its one JSON."""
    from repro_torch.analysis import hillclimb, sweep
    jobs = sweep.cell_jobs()
    assert len(jobs) == 2 * len(runnable_cells()) == 68
    assert {j["depth"] for j in jobs} == {"full"}
    assert sweep.job_tag(jobs[1]) == "qwen3-0.6b__train_4k__mp__full"
    assert hillclimb.parse_variant("dots:remat_policy=dots,grad_accum=2") \
        == ("dots", {"remat_policy": "dots", "grad_accum": 2})
    res = {"flops_per_device": 989e12, "hbm_bytes_per_device": 3.35e12,
           "collectives": {"total_bytes": 50e9}, "chips": 256,
           "memory": {"peak_est_bytes": 2 ** 30}, "compile_s": 3.0}
    row = hillclimb.summarize("base", res, {})
    assert (row["compute_s"], row["memory_s"], row["collective_s"]) == \
        (1.0, 1.0, 1.0)
    assert row["peak_gib"] == 1.0
