"""Served models: a (network graph, VTAConfig) pair compiled to programs.

A ``ServedModel`` is the unit the serving engine batches over: the graph
compiler's segment Programs (fused adds, resident chains and all) plus
deterministic int8 weights, executable on the port's backends through
``Backend.run_batched`` — the whole batch of a dispatch runs batched on the
card (``"torch"``, the default) or on the CPU (``"torch-cpu"``). Segment
outputs stay on the backend's device between segments, and the weights are
moved there once per device. ``load_params`` installs weights from
elsewhere (the JAX package's ``ServedModel.weights``).

The registry ships *serving-scale* variants of the paper's two workload
families — a resnet18-flavored residual stack (fused conv→add→clip
segments) and a mobilenet-flavored depthwise-separable chain (resident
dw→pw edges) — at ``tiny`` (unit tests / CI smoke) and ``small`` (default
benchmark) scales. Full 224×224 graphs run through exactly the same code
path; ``resnet18_trunk_graph`` and ``mobilenet_trunk_graph`` are the
full-width ResNet-18 and MobileNet-1.0 VTA trunks, and ``resnet_trunk_graph``
gives the ResNet-34, -50 and -101 trunks.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
from dataclasses import dataclass, field
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.tps import ConvWorkload, heuristic_conv_tiling
from repro_torch.vta.backend import Backend, get_backend
from repro_torch.vta.compiler import compile_graph
from repro_torch.vta.graph import Graph
from repro_torch.vta.isa import DEFAULT_VTA, VTAConfig
from repro_torch.vta.lowering import lower_cached
from repro_torch.vta.runtime import Program
from repro_torch.vta.scheduler import (schedule_add, schedule_conv,
                                 schedule_depthwise, schedule_pool)
from repro_torch.vta.workloads import (Layer, _add, _conv, mobilenet_graph,
                                      pad_for_blocking, resnet_graph)


@dataclass
class SegmentExec:
    """One dispatchable Program + the DRAM tensor names it touches."""
    program: Program
    reads: tuple
    writes: tuple


def _tensor_roles(node) -> dict:
    """The compiler's DRAM naming convention, applied to fallback nodes."""
    return {"inp": node.inputs[0], "wgt": f"{node.name}.wgt",
            "bias": f"{node.name}.bias", "out": node.name}


def _fallback_program(node, hw: VTAConfig) -> Program:
    """Lower a single-node segment with node-named tensors (the per-layer
    path names them inp/wgt/out, which cannot chain across a network)."""
    layer = node.layer
    wl = layer.wl
    roles = _tensor_roles(node)
    if node.kind in ("conv", "dense"):
        tiling = heuristic_conv_tiling(wl, hw, prefer_db=True)
        return schedule_conv(wl, tiling, hw, post_op=layer.post_op,
                             bias=layer.bias, tensors=roles).program
    if node.kind == "depthwise":
        return schedule_depthwise(wl, hw, post_op=layer.post_op,
                                  tensors=roles).program
    if node.kind in ("maxpool", "avgpool"):
        return schedule_pool(wl, hw, mode=node.kind[:3],
                             tensors=roles).program
    if node.kind == "add":
        return schedule_add(wl, hw, tensors={
            "add_a": node.inputs[0], "add_b": node.inputs[1],
            "out": node.name}).program
    raise ValueError(f"cannot serve node kind {node.kind!r}")


def _model_rng(name: str, hw: VTAConfig) -> np.random.Generator:
    seed = hashlib.sha256(f"{name}:{hw}".encode()).hexdigest()[:8]
    return np.random.default_rng(int(seed, 16))


@dataclass
class ServedModel:
    """Compiled, weight-initialized, backend-agnostic network."""
    name: str
    hw: VTAConfig
    graph: Graph
    segments: list = field(default_factory=list)     # SegmentExec, topo order
    weights: dict = field(default_factory=dict)      # shared DRAM tensors
    shapes: dict = field(default_factory=dict)       # per-image tensor shapes
    input_name: str = ""
    output_name: str = ""
    _device_weights: dict = field(default_factory=dict, repr=False,
                                  compare=False)
    _weights_lock: threading.Lock = field(default_factory=threading.Lock,
                                          repr=False, compare=False)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def compile(cls, name: str, graph: Graph, hw: VTAConfig) -> "ServedModel":
        graph.validate()
        m = cls(name=name, hw=hw, graph=graph)
        rng = _model_rng(name, hw)
        consumed: set = set()
        for node in graph.topo():
            m.shapes[node.name] = tuple(node.shape)
            consumed.update(node.inputs)
            if node.kind == "input":
                m.input_name = node.name
                continue
            assert not node.on_cpu, \
                f"{node.name}: CPU layers cannot be served on the VTA path"
            wl = node.layer.wl if node.layer is not None else None
            if wl is not None and pad_for_blocking(wl, hw) != wl:
                raise ValueError(
                    f"{node.name}: serve graphs must be block-aligned for "
                    f"the target config (channels % {hw.block_in}, batch % "
                    f"{hw.batch})")
            if node.kind in ("conv", "dense"):
                m.weights[f"{node.name}.wgt"] = rng.integers(
                    -8, 8, (wl.fo, wl.fi, wl.kh, wl.kw), dtype=np.int8)
                if node.layer.bias:
                    m.weights[f"{node.name}.bias"] = rng.integers(
                        -100, 100, (wl.fo,), dtype=np.int32)
            elif node.kind == "depthwise":
                m.weights[f"{node.name}.wgt"] = rng.integers(
                    -8, 8, (wl.fi, wl.kh, wl.kw), dtype=np.int8)
        assert m.input_name, "serve graphs need exactly one input node"
        sinks = [n.name for n in graph.topo()
                 if n.is_compute and n.name not in consumed]
        assert len(sinks) == 1, f"need exactly one sink, got {sinks}"
        m.output_name = sinks[0]

        for seg in compile_graph(graph, hw):
            prog = seg.program
            if prog is None:
                assert len(seg.nodes) == 1
                prog = _fallback_program(seg.nodes[0], hw)
            trace = lower_cached(prog, hw, m.shapes | {
                k: v.shape for k, v in m.weights.items()})
            m.segments.append(SegmentExec(program=prog,
                                          reads=trace.tensors_read,
                                          writes=trace.tensors_written))
        return m

    # ------------------------------------------------------------------
    # shapes + synthetic inputs
    # ------------------------------------------------------------------
    @property
    def image_shape(self) -> tuple:
        """Per-request input shape (1, C, H, W) — b=1 per image."""
        return self.shapes[self.input_name]

    @property
    def output_shape(self) -> tuple:
        return self.shapes[self.output_name]

    def random_images(self, n: int, seed: int = 0) -> np.ndarray:
        """(n,) + image_shape int8 stack, deterministic per seed."""
        rng = np.random.default_rng(seed)
        return rng.integers(-32, 32, (n,) + self.image_shape, dtype=np.int8)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def weights_on(self, device: torch.device) -> dict:
        """The weights as tensors on ``device``, copied there once, under a
        lock: serving workers that dispatch at once share one copy (the
        executor's plans key on its addresses). A copy from host memory
        blocks until it is done, so any stream may read them."""
        key = str(device)
        with self._weights_lock:
            hit = self._device_weights.get(key)
            if hit is None:
                hit = {k: torch.tensor(v, device=device)
                       for k, v in self.weights.items()}
                self._device_weights[key] = hit
        return hit

    def run_batch(self, images: np.ndarray,
                  backend: Union[str, Backend, None] = None,
                  on_segment=None) -> np.ndarray:
        """Execute a (N,) + image_shape stack; returns (N,) + output_shape.

        Segments chain through a per-image state dict of tensors on the
        backend's device; each dispatch passes only the tensors that
        segment touches, so the backend's lowering caches key on stable
        small shape sets. ``on_segment(segment, outputs)``, if given, sees
        each segment's stored tensors as it finishes.
        """
        be = get_backend(backend)
        device = getattr(be, "device", torch.device("cpu"))
        images = np.ascontiguousarray(images, dtype=np.int8)
        assert images.shape[1:] == self.image_shape, \
            (images.shape, self.image_shape)
        n = images.shape[0]
        weights = self.weights_on(device)
        state: dict = {self.input_name: torch.tensor(images, device=device)}
        for seg in self.segments:
            batched = {}
            for t in set(seg.reads) | set(seg.writes):
                if t in self.weights:
                    continue
                if t not in state:      # intermediate first touched here
                    state[t] = torch.zeros((n,) + self.shapes[t],
                                           dtype=torch.int8, device=device)
                batched[t] = state[t]
            shared = {t: weights[t] for t in seg.reads if t in self.weights}
            outs = be.run_batched(seg.program, self.hw, shared=shared,
                                  batched=batched)
            if on_segment is not None:
                on_segment(seg, outs)
            state.update(outs)
        return state[self.output_name].cpu().numpy()

    def run_single(self, image: np.ndarray,
                   backend: Union[str, Backend, None] = None) -> np.ndarray:
        """Batch-1 execution of one image through ``Backend.run``."""
        be = get_backend(backend)
        assert image.shape == self.image_shape, \
            (image.shape, self.image_shape)
        dram = {self.input_name: np.array(image, dtype=np.int8)}
        for t, shape in self.shapes.items():
            if t not in dram:
                dram[t] = np.zeros(shape, np.int8)
        dram.update(self.weights)
        for seg in self.segments:
            be.run(seg.program, self.hw, dram)
        return dram[self.output_name].copy()


def load_params(model: ServedModel, params: dict) -> ServedModel:
    """Install ``params`` ({tensor name: numpy int8/int32 array}, e.g. the
    JAX package's ``ServedModel.weights``) as ``model``'s weights. Names,
    shapes and dtypes must match the model's own; the arrays are copied."""
    if set(params) != set(model.weights):
        raise KeyError(f"weight names differ: missing "
                       f"{sorted(set(model.weights) - set(params))}, "
                       f"unexpected {sorted(set(params) - set(model.weights))}")
    for k, v in params.items():
        v = np.asarray(v)
        old = model.weights[k]
        if v.shape != old.shape or v.dtype != old.dtype:
            raise ValueError(f"{k}: expected {old.dtype}{old.shape}, got "
                             f"{v.dtype}{v.shape}")
        model.weights[k] = v.copy()
    with model._weights_lock:
        model._device_weights.clear()
    return model


# ---------------------------------------------------------------------------
# Serving-scale graph builders
# ---------------------------------------------------------------------------
# (spatial size, channels) per scale — block-aligned for the default config
SERVE_SCALES = {"tiny": (8, 16), "small": (14, 32)}


def _resnet_serve_graph(scale: str) -> Graph:
    """Residual stack shaped like a resnet18 stage: two basic blocks whose
    adds fuse into the producing convs (conv→add→clip segments)."""
    size, c = SERVE_SCALES[scale]
    g = Graph(name=f"resnet18-{scale}")
    prev = g.input("image", (1, c, size, size)).name
    for blk in ("b0", "b1"):
        a = g.layer(_conv(f"{blk}.a", 1, size, c, c, 3, 1, 1), prev).name
        b = g.layer(_conv(f"{blk}.b", 1, size, c, c, 3, 1, 1), a).name
        prev = g.residual_add(f"{blk}.add", b, prev,
                              layer=_add(f"{blk}.add", 1, size, c)).name
    g.validate()
    return g


def _mobilenet_serve_graph(scale: str) -> Graph:
    """Depthwise-separable chain shaped like a mobilenet stage: dw→pw pairs
    with resident on-chip edges where the compiler finds them."""
    size, c = SERVE_SCALES[scale]
    g = Graph(name=f"mobilenet-{scale}")
    prev = g.input("image", (1, c, size, size)).name
    for i in range(2):
        dw = ConvWorkload(f"dw{i}", 1, size, size, 3, 3, c, c, 1, 1, 1, 1,
                          depthwise=True)
        # dw keeps full precision (relu only); pw is the requantization
        # point (relu_shift) — shifting at every layer collapses the small
        # serve-scale activations to all-zero by the second block
        prev = g.layer(Layer("depthwise", dw, post_op="relu"), prev).name
        prev = g.layer(_conv(f"pw{i}", 1, size, c, c, 1, 0, 1,
                             post="relu_shift"), prev).name
    g.validate()
    return g


SERVE_GRAPHS = {
    "resnet18": _resnet_serve_graph,
    "mobilenet": _mobilenet_serve_graph,
}


def _trunk_graph(full: Graph, name: str, image: tuple) -> Graph:
    """``full`` without its CPU-resident nodes (served models take no CPU
    layers): their consumers read the graph's input ``"image"``, of
    per-image shape ``image``, instead."""
    cpu = {n.name for n in full.topo() if n.on_cpu}
    g = Graph(name=name)
    g.input("image", image)
    for node in full.topo():
        if node.kind == "input" or node.on_cpu:
            continue
        g.add(dataclasses.replace(node, inputs=tuple(
            "image" if s in cpu else s for s in node.inputs)))
    g.validate()
    return g


RESNET_DEPTHS = (18, 34, 50, 101)


def resnet_trunk_graph(depth: int) -> Graph:
    """The ResNet-``depth`` VTA trunk at the paper's published widths
    (``depth`` one of ``RESNET_DEPTHS``), named ``resnet{depth}-trunk``:
    ``resnet_graph(depth)`` without the CPU-resident ``conv1``, fed by the
    (1, 64, 112, 112) tensor that enters ``pool1`` — pool1, the basic
    blocks of 64-512 channels (18, 34) or the bottleneck blocks of 64-2048
    channels (50, 101), with downsample convs and residual adds, the 7x7
    global average pool and the fc to 1008."""
    if depth not in RESNET_DEPTHS:
        raise ValueError(f"no ResNet-{depth} trunk; depths {RESNET_DEPTHS}")
    return _trunk_graph(resnet_graph(depth), f"resnet{depth}-trunk",
                        (1, 64, 112, 112))


def resnet18_trunk_graph() -> Graph:
    """The ResNet-18 VTA trunk: ``resnet_trunk_graph(18)`` — pool1, 8 basic
    blocks of 64-512 channels with downsample convs and residual adds, the
    7x7 global average pool and the 512->1008 fc."""
    return resnet_trunk_graph(18)


def mobilenet_trunk_graph() -> Graph:
    """The MobileNet-1.0 VTA trunk at the paper's published widths:
    ``mobilenet_graph(1)`` without the CPU-resident ``mbn.conv1``, fed by
    the (1, 32, 112, 112) tensor that enters ``mbn.dw0`` — 13 depthwise
    3x3 / pointwise pairs of 32-1024 channels, the 7x7 global average pool
    and the 1024->1008 fc."""
    return _trunk_graph(mobilenet_graph(1), "mobilenet1.0-trunk",
                        (1, 32, 112, 112))


def list_served_models() -> list:
    return sorted(SERVE_GRAPHS)


@functools.lru_cache(maxsize=None)
def served_model(name: str, scale: str = "small",
                 hw: Optional[VTAConfig] = None) -> ServedModel:
    """Build (memoized) a registry model for ``hw`` (default config)."""
    if name not in SERVE_GRAPHS:
        raise KeyError(f"unknown served model {name!r}; "
                       f"known: {list_served_models()}")
    if scale not in SERVE_SCALES:
        raise KeyError(f"unknown scale {scale!r}; "
                       f"known: {sorted(SERVE_SCALES)}")
    hw = hw or DEFAULT_VTA
    return ServedModel.compile(f"{name}-{scale}", SERVE_GRAPHS[name](scale),
                               hw)
