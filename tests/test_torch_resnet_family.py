"""The full-width ResNet-34, -50 and -101 VTA trunks against the JAX
package on the CPU.

Tolerance 0 everywhere: int8 outputs compared bit for bit, digests by
sha256. The JAX side builds each trunk with its own graph API and runs it
segment by segment on its numpy backend; the weights come from
``chip_smoke.py``'s ``live_weights`` (numpy, seeded), handed to the JAX
package's ``ServedModel`` through its ``weights`` dict and to the port's
through ``load_params``. Images: ``random_images(8, seed=0)``, images 0-1.
Each trunk runs once per package (the module fixture ``runs``); the file
takes about 3.5 minutes on one CPU worker.
"""
import dataclasses
import hashlib
import os
import re

import numpy as np
import pytest
import torch

from repro.serve import model as jmodel
from repro.vta.graph import Graph as JGraph
from repro.vta.isa import DEFAULT_VTA as J_DEFAULT_VTA
from repro.vta.workloads import resnet_graph as j_resnet_graph
from repro_torch.serve.model import (RESNET_DEPTHS, ServedModel, load_params,
                                     resnet18_trunk_graph, resnet_trunk_graph)
from repro_torch.vta.backend import get_backend
from repro_torch.vta.isa import DEFAULT_VTA
from test_torch_mobilenet_serve import CS, ROOT, _j_segments

DEPTHS = (34, 50, 101)
SEGMENTS = {34: 37, 50: 51, 101: 102}
# chunks of one forward on the default config: the dispatches phase 3b of
# chip_smoke.py counts (ResNet-18's trunk: 114)
CHUNK_PLAN = {34: 180, 50: 759, 101: 1269}
# sha256 of each trunk's output for image 0 under live_weights, from the
# JAX package's numpy backend; chip_smoke.RESNET_DIGESTS holds the same
RESNET_DIGESTS = {
    34: "5ed433faf78124ba107e3cbf56422cd3641ee39e15583fa6115de16c54191fc1",
    50: "114f55151cabb4b33cb0262d678d04b1a4c613b5e1536ce857a3aadb6487675b",
    101: "a679541ccbe520b0ec5e46261fa8d0cc148053bedef0b8642da8df0785aa11aa",
}


def _j_trunk_graph(depth: int):
    """The ResNet-``depth`` trunk built with the JAX package's own graph
    API: the full graph without its CPU-resident first conv, whose
    consumers read ``"image"`` (tests/test_torch_serve.py::_j_trunk_graph
    for these depths)."""
    full = j_resnet_graph(depth)
    cpu = {n.name for n in full.topo() if n.on_cpu}
    g = JGraph(name=f"resnet{depth}-trunk")
    g.input("image", (1, 64, 112, 112))
    for node in full.topo():
        if node.kind == "input" or node.on_cpu:
            continue
        g.add(dataclasses.replace(node, inputs=tuple(
            "image" if s in cpu else s for s in node.inputs)))
    g.validate()
    return g


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda d: f"resnet{d}")
def runs(request):
    """One trunk in both packages under ``live_weights``: the JAX model,
    its output and shares on images 0-1 (numpy backend, segment by
    segment), and the port's model, output and shares on ``"torch-cpu"``
    (``chip_smoke.segment_shares``)."""
    d = request.param
    name = f"resnet{d}-trunk"
    # the test workers share the cores: with torch's default of one
    # intra-op thread per core in every worker, ResNet-34's one-image
    # torch-cpu forward took 30x its time alone; two threads a worker do not
    # oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        jm = jmodel.ServedModel.compile(name, _j_trunk_graph(d),
                                        J_DEFAULT_VTA)
        jm.weights.update(CS.live_weights(jm))
        imgs = jm.random_images(8, seed=0)[:2]
        jout, jseen = _j_segments(jm, imgs)
        pm = ServedModel.compile(name, resnet_trunk_graph(d), DEFAULT_VTA)
        load_params(pm, CS.live_weights(pm))
        pout, pseen = CS.segment_shares(pm, imgs)
        yield dict(depth=d, name=name, jm=jm, jout=jout, jseen=jseen, pm=pm,
                   pout=pout, pseen=pseen, imgs=imgs)
    finally:
        torch.set_num_threads(threads)


def test_trunk_graph_matches_jax(runs):
    """``resnet_trunk_graph(d)`` is the JAX-built trunk: the same graph,
    the same segments with the same reads and writes, tensor shapes and
    weight shapes; fed (1, 64, 112, 112), out (1, 1008, 1, 1)."""
    d, jm, pm = runs["depth"], runs["jm"], runs["pm"]
    assert pm.name == f"resnet{d}-trunk"
    assert pm.graph.describe() == jm.graph.describe()
    assert len(pm.segments) == len(jm.segments) == SEGMENTS[d]
    assert [(s.reads, s.writes) for s in pm.segments] == \
        [(s.reads, s.writes) for s in jm.segments]
    assert pm.shapes == jm.shapes
    assert {k: v.shape for k, v in pm.weights.items()} == \
        {k: v.shape for k, v in jm.weights.items()}
    assert (pm.image_shape, pm.output_shape) == \
        ((1, 64, 112, 112), (1, 1008, 1, 1))


def test_live_digest_from_jax_and_torch_cpu_equal(runs):
    """Image 0 under ``live_weights`` on the JAX numpy backend has the
    pinned digest; the port on ``"torch-cpu"`` equals the JAX output on
    images 0-1, and its segment-by-segment shares equal the JAX run's."""
    d = runs["depth"]
    digest = hashlib.sha256(runs["jout"][0].tobytes()).hexdigest()
    assert digest == RESNET_DIGESTS[d]
    for k, v in runs["jm"].weights.items():
        np.testing.assert_array_equal(runs["pm"].weights[k], v)
    np.testing.assert_array_equal(runs["pout"], runs["jout"])
    assert runs["pseen"] == runs["jseen"]


def test_live_weights_keep_every_segment_live(runs):
    """Every segment output of the trunk under ``live_weights`` on images
    0-1 is at least LIVE_NONZERO nonzero and at most LIVE_SATURATED at the
    int8 limits."""
    seen, pm = runs["jseen"], runs["pm"]
    assert set(seen) == {t for s in pm.segments for t in s.writes}
    for t, (nz, sat) in seen.items():
        assert nz >= CS.LIVE_NONZERO, (t, nz)
        assert sat <= CS.LIVE_SATURATED, (t, sat)


def test_chunk_plan_length(runs):
    """The dispatches of one forward on the executor's default knobs."""
    be = get_backend("torch-cpu")
    assert CS.plan_length(runs["pm"], be) == CHUNK_PLAN[runs["depth"]]


def test_default_weights_are_blind(runs):
    """Why ``live_weights``: under ``ServedModel.compile``'s own weights
    the trunk's output on image 0 is at least 99% at the int8 limits."""
    d = runs["depth"]
    m = ServedModel.compile(runs["name"], resnet_trunk_graph(d), DEFAULT_VTA)
    out = m.run_batch(runs["imgs"][:1], "torch-cpu")
    assert np.mean(np.abs(out.astype(np.int32)) >= 127) >= 0.99


def test_chip_smoke_pins_the_same_digests():
    assert set(CS.RESNET_DIGESTS) == set(CS.RESNET_TRUNKS) == {
        f"resnet{d}-trunk" for d in DEPTHS}
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        text = f.read()
    for d in DEPTHS:
        assert CS.RESNET_DIGESTS[f"resnet{d}-trunk"] == RESNET_DIGESTS[d]
        m = re.search(rf'R{d}: "([0-9a-f]{{64}})"', text)
        assert m and m.group(1) == RESNET_DIGESTS[d]


def test_resnet18_trunk_is_unchanged():
    """``resnet18_trunk_graph()`` is ``resnet_trunk_graph(18)``, the graph
    the JAX package builds (tests/test_torch_drift.py holds its programs);
    depths outside ``RESNET_DEPTHS`` raise."""
    assert RESNET_DEPTHS == (18, 34, 50, 101)
    g = resnet18_trunk_graph()
    assert g.name == "resnet18-trunk"
    assert g.describe() == resnet_trunk_graph(18).describe() == \
        _j_trunk_graph(18).describe()
    with pytest.raises(ValueError):
        resnet_trunk_graph(152)


def test_live_weights_raise_on_a_layer_not_named(monkeypatch):
    """A range table that misses a layer of the trunk, or names one it
    does not have, is refused."""
    m = ServedModel.compile(CS.R50, resnet_trunk_graph(50), DEFAULT_VTA)
    table = dict(CS.LIVE_RANGES[CS.R50])
    assert set(table) == {k[:-4] for k in m.weights if k.endswith(".wgt")}
    table.pop("resnet50.s2b3.2")
    monkeypatch.setitem(CS.LIVE_RANGES, CS.R50, table)
    with pytest.raises(KeyError, match="s2b3.2"):
        CS.live_weights(m)
    monkeypatch.setitem(CS.LIVE_RANGES, CS.R50,
                        {**table, "resnet50.s2b3.2": 8, "resnet50.s9": 1})
    with pytest.raises(KeyError, match="s9"):
        CS.live_weights(m)
