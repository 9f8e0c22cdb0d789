"""The port's serving stack against the JAX package's, on the CPU.

Tolerance: 0 everywhere — int8 outputs compared bit for bit. Models are
built in both packages from the same graphs; weights come from the same
seeded generator (``_model_rng`` seeds from the model name and the printed
``VTAConfig``), images from ``random_images`` (numpy, seeded).
"""
import dataclasses
import hashlib
import os
import re

import numpy as np
import pytest

from repro.serve import model as jmodel
from repro.vta.graph import Graph as JGraph
from repro.vta.isa import DEFAULT_VTA as J_DEFAULT_VTA
from repro.vta.workloads import mobilenet_graph as j_mobilenet_graph
from repro.vta.workloads import resnet_graph as j_resnet_graph
from repro_torch.serve.engine import VTAServeEngine
from repro_torch.serve.model import (SERVE_GRAPHS, ServedModel, load_params,
                                     resnet18_trunk_graph, served_model)
from repro_torch.vta.isa import DEFAULT_VTA

# sha256 of the full-width trunk's output for image 0 of
# random_images(8, seed=0) on the JAX package's numpy backend, under the
# weights ServedModel.compile draws: a drift check of the CPU path (those
# weights saturate the trunk's deep layers, so the card runs use
# chip_smoke.py's live_weights instead)
DEFAULT_WEIGHTS_TRUNK_DIGEST = \
    "93a27c05b40128f109a1f863874468b3e9137bfb386ecd58fa59a5e5b7191b3e"
# the same under chip_smoke.live_weights, for both full-width trunks;
# chip_smoke.py holds the same digests for the card run, and
# tests/test_torch_mobilenet_serve.py derives them from the JAX package
TRUNK_DIGEST = \
    "6686d447b6462e98295895df574545f567ad7c023acafb6972bc3de923d1dbf1"
MBN_DIGEST = \
    "b926952d3de5609b1cb1a733bf7817fd1656544bf665a6046dee0058af096e0d"


def _j_trunk_graph(name: str = "resnet18-trunk"):
    """A full-width trunk built with the JAX package's own graph API: the
    full graph without its CPU-resident first conv, whose consumers read
    ``"image"``."""
    full, image = {
        "resnet18-trunk": (j_resnet_graph(18), (1, 64, 112, 112)),
        "mobilenet1.0-trunk": (j_mobilenet_graph(1), (1, 32, 112, 112)),
    }[name]
    cpu = {n.name for n in full.topo() if n.on_cpu}
    g = JGraph(name=name)
    g.input("image", image)
    for node in full.topo():
        if node.kind == "input" or node.on_cpu:
            continue
        g.add(dataclasses.replace(node, inputs=tuple(
            "image" if s in cpu else s for s in node.inputs)))
    g.validate()
    return g


@pytest.mark.parametrize("name", ["resnet18", "mobilenet"])
def test_served_model_weights_match_jax(name):
    a = jmodel.served_model(name, "tiny")
    b = served_model(name, "tiny")
    assert repr(b.hw) == repr(a.hw)
    assert sorted(b.weights) == sorted(a.weights)
    for k, v in a.weights.items():
        assert b.weights[k].dtype == v.dtype
        np.testing.assert_array_equal(b.weights[k], v)
    assert (b.image_shape, b.output_shape) == (a.image_shape, a.output_shape)


@pytest.mark.parametrize("name", ["resnet18", "mobilenet"])
def test_load_params_then_run_batch_matches_jax(name):
    """Weights drawn afresh on the JAX side, carried across by
    ``load_params``: torch-cpu ``run_batch`` equals the JAX ``run_batch``
    on "jax" and ``run_single`` on "numpy"."""
    graph = jmodel.SERVE_GRAPHS[name]("tiny")
    a = jmodel.ServedModel.compile(f"{name}-tiny", graph, J_DEFAULT_VTA)
    rng = np.random.default_rng(5)
    for k, v in a.weights.items():
        a.weights[k] = rng.integers(-8, 8, v.shape).astype(v.dtype)
    b = ServedModel.compile(f"{name}-tiny", SERVE_GRAPHS[name]("tiny"),
                            DEFAULT_VTA)
    load_params(b, a.weights)
    imgs = a.random_images(3, seed=2)
    got = b.run_batch(imgs, "torch-cpu")
    np.testing.assert_array_equal(got, a.run_batch(imgs, "jax"))
    for i in range(len(imgs)):
        np.testing.assert_array_equal(got[i], a.run_single(imgs[i], "numpy"))
    assert np.any(got)
    with pytest.raises(KeyError):
        load_params(b, {})
    bad = dict(a.weights)
    k0 = next(iter(bad))
    bad[k0] = bad[k0].astype(np.int32)
    with pytest.raises(ValueError):
        load_params(b, bad)


def test_engine_serves_bit_exact_on_torch_cpu():
    """A few requests across two models and two buckets through the port's
    engine equal the JAX numpy oracle image by image."""
    models = {"resnet18": served_model("resnet18", "tiny"),
              "mobilenet": served_model("mobilenet", "tiny")}
    eng = VTAServeEngine(models, backend="torch-cpu")
    reqs = []
    for i in range(5):
        name = "resnet18" if i % 2 == 0 else "mobilenet"
        img = models[name].random_images(1, seed=200 + i)[0]
        reqs.append((name, img, eng.submit(f"t{i % 2}", name, img)))
    eng.drain()
    snap = eng.metrics.snapshot()
    assert snap["requests"]["completed"] == 5
    for name, img, ticket in reqs:
        ref = jmodel.served_model(name, "tiny").run_single(img, "numpy")
        np.testing.assert_array_equal(ticket.result(timeout=0), ref)
    # the worker pool is ported: ``workers=2`` builds ladders over the
    # default DEGRADATION_LADDER, which names the card, so without one it
    # raises rather than drop the rung (tests/test_torch_workers.py serves
    # through pools on the CPU ladder)
    with pytest.raises(RuntimeError, match="CUDA"):
        VTAServeEngine(models, backend="torch-cpu", workers=2)


def test_full_width_trunk_matches_numpy_digest():
    """The full-width ResNet-18 trunk under ServedModel.compile's weights,
    image 0 of random_images(8, seed=0): the JAX numpy backend's output has
    the pinned digest, and torch-cpu equals it."""
    a = jmodel.ServedModel.compile("resnet18-trunk", _j_trunk_graph(),
                                   J_DEFAULT_VTA)
    b = ServedModel.compile("resnet18-trunk", resnet18_trunk_graph(),
                            DEFAULT_VTA)
    assert len(b.segments) == len(a.segments) == 21
    assert b.output_shape == a.output_shape == (1, 1008, 1, 1)
    img = a.random_images(8, seed=0)[:1]
    np.testing.assert_array_equal(img, b.random_images(8, seed=0)[:1])
    ref = a.run_batch(img, "numpy")
    assert hashlib.sha256(ref[0].tobytes()).hexdigest() == \
        DEFAULT_WEIGHTS_TRUNK_DIGEST
    np.testing.assert_array_equal(b.run_batch(img, "torch-cpu"), ref)


def test_chip_smoke_pins_the_same_digest():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    with open(path) as f:
        text = f.read()
    for name, digest in (("TRUNK_DIGEST", TRUNK_DIGEST),
                         ("MBN_DIGEST", MBN_DIGEST)):
        m = re.search(name + r' = \\\s*"([0-9a-f]{64})"', text)
        assert m and m.group(1) == digest
