"""Paper workloads: ResNet-18/34/50/101 + MobileNet-1.0 layer tables.

The C2-C11 convolution list matches the canonical TVM/VTA ResNet-18 workload
table (the layers of paper Fig 10); conv1 (3 input channels) runs on the CPU
as in the upstream stack (§IV.E). Channel counts are rounded up to the VTA
block size when a configuration's BLOCK exceeds a layer's channels (MobileNet
early layers on BLOCK=32/64) — the padding overhead is part of the measured
cost, as on the real machine.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from repro_torch.core.tps import ConvWorkload


@dataclass(frozen=True)
class Layer:
    kind: str                  # conv | depthwise | maxpool | avgpool | dense | add
    wl: ConvWorkload
    post_op: str = "clip_shift"
    bias: bool = False
    on_cpu: bool = False       # channel-light layers the stack leaves on CPU


def _conv(name, b, hw_, fi, fo, k, p, s, post="clip_shift") -> Layer:
    return Layer("conv", ConvWorkload(name, b, hw_, hw_, k, k, fi, fo, p, p, s, s),
                 post_op=post)


def _add(name, b, size, c) -> Layer:
    """Residual elementwise add: out = clip(a + b). Modeled as a 1x1 'conv'
    workload for shape bookkeeping; MACs are 0 (it is ALU work)."""
    return Layer("add", ConvWorkload(name, b, size, size, 1, 1, c, c, 0, 0, 1, 1),
                 post_op="clip")


# ---------------------------------------------------------------------------
# ResNet-18 C2-C11 (the canonical VTA conv workloads; Fig 10 layers)
# ---------------------------------------------------------------------------
def resnet18_convs(batch: int = 1) -> list[ConvWorkload]:
    t = [
        ("C2", 56, 64, 64, 3, 1, 1),
        ("C3", 56, 64, 128, 3, 1, 2),
        ("C4", 56, 64, 128, 1, 0, 2),
        ("C5", 28, 128, 128, 3, 1, 1),
        ("C6", 28, 128, 256, 3, 1, 2),
        ("C7", 28, 128, 256, 1, 0, 2),
        ("C8", 14, 256, 256, 3, 1, 1),
        ("C9", 14, 256, 512, 3, 1, 2),
        ("C10", 14, 256, 512, 1, 0, 2),
        ("C11", 7, 512, 512, 3, 1, 1),
    ]
    return [ConvWorkload(f"resnet18.{n}", batch, s, s, k, k, fi, fo, p, p, st, st)
            for (n, s, fi, fo, k, p, st) in t]


def _basic_block(g, name, prev, b, size, fi, fo, stride) -> str:
    """Two 3x3 convs + identity/downsample skip, joined by a residual add."""
    a = g.layer(_conv(f"{name}.a", b, size, fi, fo, 3, 1, stride), prev).name
    bb = g.layer(_conv(f"{name}.b", b, size // stride, fo, fo, 3, 1, 1), a).name
    skip = prev
    if stride != 1 or fi != fo:
        skip = g.layer(_conv(f"{name}.ds", b, size, fi, fo, 1, 0, stride),
                       prev).name
    g.residual_add(f"{name}.add", bb, skip,
                   layer=_add(f"{name}.add", b, size // stride, fo))
    return f"{name}.add"


def _bottleneck(g, name, prev, b, size, fi, mid, fo, stride) -> str:
    c1 = g.layer(_conv(f"{name}.1", b, size, fi, mid, 1, 0, 1), prev).name
    c2 = g.layer(_conv(f"{name}.2", b, size, mid, mid, 3, 1, stride), c1).name
    c3 = g.layer(_conv(f"{name}.3", b, size // stride, mid, fo, 1, 0, 1),
                 c2).name
    skip = prev
    if stride != 1 or fi != fo:
        skip = g.layer(_conv(f"{name}.ds", b, size, fi, fo, 1, 0, stride),
                       prev).name
    g.residual_add(f"{name}.add", c3, skip,
                   layer=_add(f"{name}.add", b, size // stride, fo))
    return f"{name}.add"


def _resnet_graph(name: str, blocks: list[int], bottleneck: bool, batch: int):
    from repro_torch.vta.graph import Graph
    g = Graph(name=name)
    prev = g.input("image", (batch, 3, 224, 224)).name
    prev = g.layer(Layer("conv", ConvWorkload(f"{name}.conv1", batch, 224, 224,
                                              7, 7, 3, 64, 3, 3, 2, 2),
                         on_cpu=True), prev).name
    prev = g.layer(Layer("maxpool", ConvWorkload(f"{name}.pool1", batch, 112,
                                                 112, 3, 3, 64, 64, 1, 1, 2, 2)),
                   prev).name
    size = 56
    fi = 64
    for stage, n in enumerate(blocks):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            if bottleneck:
                mid = 64 * (2 ** stage)
                fo = mid * 4
                prev = _bottleneck(g, f"{name}.s{stage}b{i}", prev, batch,
                                   size, fi, mid, fo, stride)
            else:
                fo = 64 * (2 ** stage)
                prev = _basic_block(g, f"{name}.s{stage}b{i}", prev, batch,
                                    size, fi, fo, stride)
            size //= stride
            fi = fo
    prev = g.layer(Layer("avgpool", ConvWorkload(f"{name}.gap", batch, 7, 7,
                                                 7, 7, fi, fi, 0, 0, 7, 7)),
                   prev).name
    g.layer(Layer("dense", ConvWorkload(f"{name}.fc", batch, 1, 1, 1, 1,
                                        fi, 1008, 0, 0, 1, 1),
                  post_op="none", bias=True), prev)
    g.validate()
    return g


def resnet_graph(depth: int, batch: int = 1):
    cfg = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
           50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True)}[depth]
    return _resnet_graph(f"resnet{depth}", cfg[0], cfg[1], batch)


def resnet(depth: int, batch: int = 1) -> list[Layer]:
    """Legacy per-layer table — now derived from the graph, so the residual
    adds that used to be missing are counted even on the unfused path."""
    return resnet_graph(depth, batch).layers()


# ---------------------------------------------------------------------------
# MobileNet 1.0 (depthwise-separable; §IV.D.3 / IV.E) — a pure chain
# ---------------------------------------------------------------------------
def mobilenet_graph(batch: int = 1):
    from repro_torch.vta.graph import Graph
    g = Graph(name="mobilenet1.0")
    prev = g.input("image", (batch, 3, 224, 224)).name
    prev = g.layer(Layer("conv", ConvWorkload("mbn.conv1", batch, 224, 224, 3,
                                              3, 3, 32, 1, 1, 2, 2),
                         on_cpu=True), prev).name
    spec = [  # (size_in, cin, cout, stride)
        (112, 32, 64, 1), (112, 64, 128, 2), (56, 128, 128, 1),
        (56, 128, 256, 2), (28, 256, 256, 1), (28, 256, 512, 2),
        (14, 512, 512, 1), (14, 512, 512, 1), (14, 512, 512, 1),
        (14, 512, 512, 1), (14, 512, 512, 1), (14, 512, 1024, 2),
        (7, 1024, 1024, 1),
    ]
    for i, (size, ci, co, s) in enumerate(spec):
        prev = g.layer(Layer("depthwise",
                             ConvWorkload(f"mbn.dw{i}", batch, size, size, 3,
                                          3, ci, ci, 1, 1, s, s),
                             post_op="relu_shift"), prev).name
        prev = g.layer(_conv(f"mbn.pw{i}", batch, size // s, ci, co, 1, 0, 1,
                             post="relu_shift"), prev).name
    prev = g.layer(Layer("avgpool", ConvWorkload("mbn.gap", batch, 7, 7, 7, 7,
                                                 1024, 1024, 0, 0, 7, 7)),
                   prev).name
    g.layer(Layer("dense", ConvWorkload("mbn.fc", batch, 1, 1, 1, 1,
                                        1024, 1008, 0, 0, 1, 1),
                  post_op="none", bias=True), prev)
    g.validate()
    return g


def mobilenet_v1(batch: int = 1) -> list[Layer]:
    return mobilenet_graph(batch).layers()


def pad_for_blocking(wl: ConvWorkload, hw) -> ConvWorkload:
    """Round channel counts up to the VTA block sizes (cost of mis-fit)."""
    from dataclasses import replace
    fi = max(wl.fi, hw.block_in) if not wl.depthwise else max(wl.fi, hw.block_out)
    fo = max(wl.fo, hw.block_out)
    fi = -(-fi // hw.block_in) * hw.block_in if not wl.depthwise else \
        -(-fi // hw.block_out) * hw.block_out
    fo = -(-fo // hw.block_out) * hw.block_out
    if wl.depthwise:
        fi = fo = max(fi, fo)
    b = -(-wl.b // hw.batch) * hw.batch
    return replace(wl, fi=fi, fo=fo, b=b)


NETWORKS = {
    "resnet18": lambda b=1: resnet(18, b),
    "resnet34": lambda b=1: resnet(34, b),
    "resnet50": lambda b=1: resnet(50, b),
    "resnet101": lambda b=1: resnet(101, b),
    "mobilenet1.0": mobilenet_v1,
}

GRAPHS = {
    "resnet18": lambda b=1: resnet_graph(18, b),
    "resnet34": lambda b=1: resnet_graph(34, b),
    "resnet50": lambda b=1: resnet_graph(50, b),
    "resnet101": lambda b=1: resnet_graph(101, b),
    "mobilenet1.0": mobilenet_graph,
}


def network_graph(name: str, batch: int = 1):
    """The graph IR for a network (compiler entry point)."""
    return GRAPHS[resolve_network(name)](batch)

_ALIASES = {
    "mobilenet": "mobilenet1.0",
    "mobilenetv1": "mobilenet1.0",
    "mobilenet_v1": "mobilenet1.0",
    "mobilenet-1.0": "mobilenet1.0",
}


def resolve_network(name: str) -> str:
    """Canonical NETWORKS key for a user-supplied name (CLI aliases)."""
    key = name.strip().lower().replace("resnet-", "resnet")
    key = _ALIASES.get(key, key)
    if key not in NETWORKS:
        known = ", ".join(sorted(NETWORKS))
        raise KeyError(f"unknown network {name!r}; known: {known}")
    return key


@functools.lru_cache(maxsize=None)
def network_fingerprint(name: str, batch: int = 1) -> str:
    """Content hash of a network's graph (nodes, shapes AND edges).

    Part of the DSE cache key: editing a workload definition — or rewiring a
    skip connection — invalidates every cached point that depends on it,
    nothing else. Memoized — the tables are module-level constants within a
    process.
    """
    import hashlib
    desc = network_graph(name, batch).describe()
    return hashlib.sha256(repr(desc).encode()).hexdigest()[:16]
