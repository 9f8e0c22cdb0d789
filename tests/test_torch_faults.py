"""The faults ``chip_smoke.py --plant-faults`` plants, checked on the CPU.

Each fault is a text substitution in one source of ``src/repro_torch``; the
planting raises on the card if its text is not in the source exactly once,
which would cost a chip run to find. These tests hold every fault's text to
its source here, and each fault to a route whose cases the run checks.
"""
import importlib.util
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.mark.parametrize("fault", sorted(CS.PLANTED_FAULTS))
def test_planted_fault_text_occurs_once(fault):
    route, path, text, stand_in = CS.PLANTED_FAULTS[fault]
    with open(os.path.join(ROOT, "src", "repro_torch", path)) as f:
        source = f.read()
    assert source.count(text) == 1
    assert text != stand_in
    assert fault.split(".")[0] == route


def test_every_fault_route_has_cases():
    """A route's fault is run against attention cases of that route, the
    phase-4 or phase-2 cases of its kernel, phase 3's checks of the
    captured path (with phase 3b's of the ResNet family for route
    ``resnet``), phase 6's checks of the worker pool or the ladder,
    phase 7's golden runs of the language-model session, the init in the
    serving dtypes, phase 8's golden training runs, phase 9's checks of
    the design-space sweep, or the part of phase 10 (the mesh layer) the
    fault lies in."""
    attention = {"decode", "mma", "tf32x3"}
    for route, *_ in CS.PLANTED_FAULTS.values():
        assert route in attention | set(CS.LAYER_FAULT_KEYS) | set(
            CS.VTA_FAULT_KEYS) | set(CS.SERVE_FAULT_KEYS) | set(
            CS.RESNET_FAULT_KEYS) | set(
            CS.POOL_FAULT_KEYS) | set(CS.LM_FAULT_KEYS) | set(
            CS.INIT_FAULT_KEYS) | set(CS.TRAIN_FAULT_KEYS) | set(
            CS.DSE_FAULT_KEYS) | set(CS.MESH_FAULT_KEYS)
    assert {f for f, spec in CS.PLANTED_FAULTS.items()
            if spec[0] in CS.RESNET_FAULT_KEYS} == {
        "resnet.fc2048_last_row_dropped"}
    assert {f for f, spec in CS.PLANTED_FAULTS.items()
            if spec[0] == "dse"} == {"dse.card_fault_absorbed",
                                     "dse.captured", "dse.verify_on_cpu"}
    assert {(f, spec[0]) for f, spec in CS.PLANTED_FAULTS.items()
            if spec[0] in CS.MESH_FAULT_KEYS} == {
        ("mesh_serve.dtensor_plain_attention", "mesh_serve"),
        ("mesh_restore.ignores_sharding_tree", "mesh_restore"),
        ("mesh_dryrun.global_flops", "mesh_dryrun"),
        ("mesh_dryrun.flops_counted_twice", "mesh_dryrun"),
        ("mesh_dryrun.moe_per_rank_capacity", "mesh_dryrun"),
        ("mesh_serve.shift_off_by_one", "mesh_serve")}
    assert {f for f, spec in CS.PLANTED_FAULTS.items()
            if spec[0] in CS.INIT_FAULT_KEYS} == {
        "lm_init.router_cast_bf16", "lm_init.keeps_f32_tree"}


def test_alu_edge_cases_reach_every_scalar_path():
    """The ALU edge cases lie where their names say, and among them are a
    scalar tail (the target of ``alu.skip_tail``), a scalar head at every
    misalignment of 2, 4, 6 and 10 bytes, and a y whose misalignment is
    not x's (the wrapper copies it); each with y and with an immediate."""
    import re

    import numpy as np
    import torch

    from repro_torch.kernels.alu import alu_plan
    cases = CS.alu_edge_cases(torch.device("cpu"), np.random.default_rng(0))
    heads, tails, moved = set(), 0, 0
    for op, name, args, kw in cases:
        assert op == "alu"
        at = [t.data_ptr() % 16 for t in args]
        m = re.search(r"offset (\d+) B", name)
        if m:
            assert at == [int(m.group(1))] * len(args)
            heads.add((args[0].dtype, at[0], len(args)))
        m = re.search(r"x at (\d+) B, y at (\d+) B", name)
        if m:
            assert at == [int(m.group(1)), int(m.group(2))] and at[0] != at[1]
            moved += 1
        head, _, _, _, tail = alu_plan(args[0].numel(),
                                       args[0].element_size(), at[0])
        tails += tail > 0
    assert {(torch.float32, 4, 1), (torch.float32, 4, 2)} <= heads
    assert {(torch.bfloat16, b, n) for b in (2, 6, 10) for n in (1, 2)} \
        <= heads
    assert moved >= 2 and tails >= 4
