"""The full-width MobileNet-1.0 trunk and the live weights of both trunks,
against the JAX package on the CPU.

Tolerance 0 everywhere: int8 outputs compared bit for bit, digests by
sha256. The JAX side builds its graphs with its own classes and runs on
its numpy backend (the Pallas kernels in interpret mode where the engine
runs the ``"jax-pallas"`` backend); the weights come from ``chip_smoke.py``'s
``live_weights`` (numpy, seeded), handed to the JAX package's
``ServedModel`` through its ``weights`` dict and to the port's through
``load_params``. Images: ``random_images(8, seed=0)``, images 0-1.
"""
import hashlib
import importlib.util
import os
import re

import numpy as np
import pytest

from repro.serve import engine as jengine
from repro.serve import model as jmodel
from repro.vta.backend import get_backend as j_get_backend
from repro.vta.isa import DEFAULT_VTA as J_DEFAULT_VTA
from repro_torch.serve.engine import VTAServeEngine
from repro_torch.serve.model import (ServedModel, load_params,
                                     mobilenet_trunk_graph,
                                     resnet18_trunk_graph, served_model)
from repro_torch.vta.isa import DEFAULT_VTA
from test_torch_serve import _j_trunk_graph

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
TRUNKS = (CS.TRUNK, CS.MBN)


def _port_graph(name: str):
    return {CS.TRUNK: resnet18_trunk_graph,
            CS.MBN: mobilenet_trunk_graph}[name]()


def _j_segments(model, imgs) -> tuple:
    """The JAX package's model run segment by segment on its numpy
    backend, as its ``run_batch`` runs it: (output, {tensor: (nonzero
    share, share at the int8 limits)} of every stored tensor)."""
    be = j_get_backend("numpy")
    n = imgs.shape[0]
    state = {model.input_name: np.ascontiguousarray(imgs, np.int8)}
    seen = {}
    for seg in model.segments:
        batched = {}
        for t in set(seg.reads) | set(seg.writes):
            if t in model.weights:
                continue
            if t not in state:
                state[t] = np.zeros((n,) + model.shapes[t], np.int8)
            batched[t] = state[t]
        shared = {t: model.weights[t] for t in seg.reads
                  if t in model.weights}
        outs = be.run_batched(seg.program, model.hw, shared=shared,
                              batched=batched)
        seen.update({t: CS.shares(np.asarray(v)) for t, v in outs.items()})
        state.update(outs)
    return np.asarray(state[model.output_name]), seen


@pytest.fixture(scope="module")
def jax_runs():
    """{(trunk, "live" | "default"): (JAX model, output, shares)} on images
    0-1, computed once for the module."""
    out = {}
    for name in TRUNKS:
        for weights in ("live", "default"):
            m = jmodel.ServedModel.compile(name, _j_trunk_graph(name),
                                           J_DEFAULT_VTA)
            if weights == "live":
                m.weights.update(CS.live_weights(m))
            imgs = m.random_images(8, seed=0)[:2]
            out[(name, weights)] = (m,) + _j_segments(m, imgs)
    return out


def test_mobilenet_trunk_graph_matches_jax():
    """26 segments with the reads, writes and tensor shapes the graph built
    from the JAX package's classes gives (tests/test_torch_drift.py holds
    their programs by bits), ``mbn.dw11`` fused into ``mbn.pw11`` over a
    resident edge and the GAP into ``mbn.fc``."""
    ja = jmodel.ServedModel.compile(CS.MBN, _j_trunk_graph(CS.MBN),
                                    J_DEFAULT_VTA)
    pb = ServedModel.compile(CS.MBN, mobilenet_trunk_graph(), DEFAULT_VTA)
    assert len(pb.segments) == len(ja.segments) == 26
    assert [(s.reads, s.writes) for s in pb.segments] == \
        [(s.reads, s.writes) for s in ja.segments]
    assert pb.shapes == ja.shapes
    assert (pb.image_shape, pb.output_shape) == \
        ((1, 32, 112, 112), (1, 1008, 1, 1))
    fused = [s for s in pb.segments if len([t for t in s.reads
                                            if t.endswith(".wgt")]) == 2]
    assert [s.writes for s in fused] == [("mbn.pw11",)]
    assert pb.segments[-1].writes == ("mbn.fc",)


@pytest.mark.parametrize("name", TRUNKS)
def test_live_weights_keep_every_segment_live(name, jax_runs):
    """On the JAX numpy backend, every segment output of the trunk under
    ``live_weights`` is at least LIVE_NONZERO nonzero and at most
    LIVE_SATURATED at the int8 limits."""
    _, _, seen = jax_runs[(name, "live")]
    m = jax_runs[(name, "live")][0]
    assert set(seen) == {t for s in m.segments for t in s.writes}
    for t, (nz, sat) in seen.items():
        assert nz >= CS.LIVE_NONZERO, (t, nz)
        assert sat <= CS.LIVE_SATURATED, (t, sat)


@pytest.mark.parametrize("name", TRUNKS)
def test_live_digest_from_jax_and_torch_cpu_equal(name, jax_runs):
    """Image 0's output under ``live_weights`` on the JAX numpy backend has
    the digest chip_smoke.py pins; the port on ``"torch-cpu"``, its weights
    installed by ``load_params``, equals the JAX output on images 0-1, and
    its segment-by-segment shares (``segment_shares``, which phase 3's
    ``live:`` lines read) equal the JAX run's."""
    m, ref, seen = jax_runs[(name, "live")]
    assert hashlib.sha256(ref[0].tobytes()).hexdigest() == CS.DIGESTS[name]
    b = ServedModel.compile(name, _port_graph(name), DEFAULT_VTA)
    load_params(b, CS.live_weights(b))
    for k, v in m.weights.items():
        np.testing.assert_array_equal(b.weights[k], v)
    got, port_seen = CS.segment_shares(b, m.random_images(8, seed=0)[:2])
    np.testing.assert_array_equal(got, ref)
    assert port_seen == seen


def test_serve_models_install_live_weights():
    """``serve_models`` compiles both trunks with ``live_weights``
    installed, each layer's weights spanning its range, every bias drawn;
    the small models keep the registry's weights."""
    models = CS.serve_models(DEFAULT_VTA)
    assert sorted(models) == sorted({m for m, _ in CS.SERVE_RUNS})
    for name, kind in ((CS.SMALL, "resnet18"), (CS.MBN_SMALL, "mobilenet")):
        reg = served_model(kind, "small")
        assert sorted(models[name].weights) == sorted(reg.weights)
        for k, v in reg.weights.items():
            np.testing.assert_array_equal(models[name].weights[k], v)
    for name in TRUNKS:
        m = models[name]
        assert m.name == name
        for k, v in m.weights.items():
            layer, role = k.rsplit(".", 1)
            if role == "wgt":
                r = CS.LIVE_RANGES[name][layer]
                assert v.dtype == np.int8 and np.abs(v).max() <= r
                assert np.abs(v).max() == r
            else:
                assert v.dtype == np.int32 and np.any(v)


def test_default_weights_are_blind(jax_runs):
    """Why ``live_weights``: under ``ServedModel.compile``'s weights
    (int8 in [-8, 8), every post-op a shift by 8) MobileNet-1.0 is zero at
    every output from ``mbn.pw0`` through ``mbn.pw12`` and its logits are
    the clipped fc bias, and the ResNet-18 trunk's fc sits at the int8
    limits everywhere."""
    m, out, seen = jax_runs[(CS.MBN, "default")]
    for i in range(13):
        assert seen[f"mbn.pw{i}"][0] == 0.0, i
    bias = np.clip(m.weights["mbn.fc.bias"], -128, 127).astype(np.int8)
    logits = out.reshape(out.shape[0], -1)
    np.testing.assert_array_equal(logits,
                                  np.broadcast_to(bias, logits.shape))
    _, _, rseen = jax_runs[(CS.TRUNK, "default")]
    assert rseen["resnet18.fc"][1] == 1.0


def test_chip_smoke_serves_both_trunks():
    """Phase 3 serves both trunks at buckets 2 and 8 and both
    serving-scale models at bucket 4; phase 6's two-tenant round takes the
    two trunks."""
    assert set(CS.SERVE_RUNS) == {
        (CS.TRUNK, 2), (CS.TRUNK, 8), (CS.MBN, 2), (CS.MBN, 8),
        (CS.SMALL, 4), (CS.MBN_SMALL, 4)}
    assert set(CS.DIGESTS) == set(TRUNKS)
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        text = f.read()
    m = re.search(r'MBN_DIGEST = \\\s*"([0-9a-f]{64})"', text)
    assert m and m.group(1) == CS.MBN_DIGEST


def test_mobilenet_small_engine_matches_jax_pallas():
    """mobilenet-small through the port's engine on ``"torch-cpu"`` equals
    the JAX package's engine on ``"jax-pallas"`` (its Pallas GEMM and ALU
    kernels in interpret mode on the CPU), request by request."""
    a = jmodel.served_model("mobilenet", "small")
    b = served_model("mobilenet", "small")
    for k, v in a.weights.items():
        np.testing.assert_array_equal(b.weights[k], v)
    imgs = a.random_images(6, seed=3)
    out = []
    for eng in (jengine.VTAServeEngine({"mobilenet": a}, backend="jax-pallas",
                                       buckets=(2, 4)),
                VTAServeEngine({"mobilenet": b}, backend="torch-cpu",
                               buckets=(2, 4))):
        tks = [eng.submit(f"t{i % 2}", "mobilenet", img)
               for i, img in enumerate(imgs)]
        eng.drain()
        out.append(np.stack([t.result(timeout=0) for t in tks]))
    np.testing.assert_array_equal(out[1], out[0])
    assert np.any(out[0])
