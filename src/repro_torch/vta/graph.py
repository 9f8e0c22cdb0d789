"""Network IR for the graph-level VTA compiler.

A ``Graph`` is a DAG of named nodes. Compute nodes wrap today's per-layer
``Layer`` descriptors (conv / depthwise / pool / dense); two new node kinds
model what the per-layer tables could not express:

  * ``add``    — the elementwise residual add of ResNet skip connections
                 (two inputs of identical shape; out = clip(a + b));
  * ``concat`` — channel concatenation (Inception-style branches).

Edges carry tensor shapes: every node records its output ``(B, C, H, W)``
int8 activation shape, and ``validate()`` checks that each node's declared
input shapes agree with what its producers emit — the shape errors a
graph-level compiler must catch before lowering.

The IR is deliberately small: the compiler (``vta/compiler.py``) only needs
topological order, consumer counts (to find fusable linear chains) and
shapes (to size scratchpad residency).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Iterator, Optional

if TYPE_CHECKING:                      # avoid the workloads <-> graph cycle
    from repro_torch.vta.workloads import Layer


@dataclass(frozen=True)
class Node:
    """One IR node. ``kind`` mirrors Layer kinds plus add/concat/input."""
    name: str
    kind: str                      # input|conv|depthwise|maxpool|avgpool|dense|add|concat
    shape: tuple                   # output activation shape (B, C, H, W)
    inputs: tuple = ()             # producer node names, in argument order
    layer: Optional[Layer] = None  # the per-layer descriptor (compute nodes)

    @property
    def is_compute(self) -> bool:
        return self.kind != "input"

    @property
    def on_cpu(self) -> bool:
        return self.layer is not None and self.layer.on_cpu


class GraphError(ValueError):
    pass


@dataclass
class Graph:
    """A DAG of Nodes in insertion order (builders append topologically)."""
    name: str
    nodes: dict = field(default_factory=dict)    # name -> Node, ordered

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def add(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise GraphError(f"duplicate node {node.name!r}")
        for src in node.inputs:
            if src not in self.nodes:
                raise GraphError(f"{node.name!r} references unknown input "
                                 f"{src!r} (nodes must be added topologically)")
        self.nodes[node.name] = node
        return node

    def input(self, name: str, shape: tuple) -> Node:
        return self.add(Node(name=name, kind="input", shape=tuple(shape)))

    def layer(self, layer: Layer, src: str) -> Node:
        """Append a compute layer consuming ``src``; shape from its workload."""
        wl = layer.wl
        shape = (wl.b, wl.fo, wl.oh, wl.ow)
        return self.add(Node(name=wl.name, kind=layer.kind, shape=shape,
                             inputs=(src,), layer=layer))

    def residual_add(self, name: str, a: str, b: str,
                     layer: Optional[Layer] = None) -> Node:
        sa, sb = self.nodes[a].shape, self.nodes[b].shape
        if sa != sb:
            raise GraphError(f"add {name!r}: input shapes differ {sa} vs {sb}")
        return self.add(Node(name=name, kind="add", shape=sa, inputs=(a, b),
                             layer=layer))

    def concat(self, name: str, srcs: list,
               layer: Optional[Layer] = None) -> Node:
        shapes = [self.nodes[s].shape for s in srcs]
        b, _, h, w = shapes[0]
        for s in shapes[1:]:
            if (s[0], s[2], s[3]) != (b, h, w):
                raise GraphError(f"concat {name!r}: non-channel dims differ "
                                 f"{shapes[0]} vs {s}")
        shape = (b, sum(s[1] for s in shapes), h, w)
        return self.add(Node(name=name, kind="concat", shape=shape,
                             inputs=tuple(srcs), layer=layer))

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def topo(self) -> Iterator[Node]:
        """Topological order (== insertion order, enforced by add())."""
        return iter(self.nodes.values())

    def consumers(self) -> dict:
        """node name -> list of consumer node names."""
        out: dict = {n: [] for n in self.nodes}
        for node in self.nodes.values():
            for src in node.inputs:
                out[src].append(node.name)
        return out

    def compute_nodes(self) -> list:
        return [n for n in self.nodes.values() if n.is_compute]

    def layers(self) -> list:
        """Flatten to the legacy per-layer table (topo order, adds included).

        This is the unfused fallback view: every compute node becomes one
        Layer evaluated with a DRAM round trip between layers — exactly
        today's per-layer path, now with the residual adds that used to be
        silently missing from every ResNet total.
        """
        out = []
        for node in self.compute_nodes():
            if node.layer is None:
                raise GraphError(f"node {node.name!r} ({node.kind}) has no "
                                 f"layer descriptor")
            out.append(node.layer)
        return out

    def validate(self) -> None:
        """Shape/structure checks; raises GraphError on the first violation."""
        for node in self.nodes.values():
            if node.kind == "input":
                if node.inputs:
                    raise GraphError(f"input {node.name!r} has inputs")
                continue
            if not node.inputs:
                raise GraphError(f"{node.name!r} ({node.kind}) has no inputs")
            in_shapes = [self.nodes[s].shape for s in node.inputs]
            if node.kind == "add":
                if len(in_shapes) != 2 or in_shapes[0] != in_shapes[1]:
                    raise GraphError(f"add {node.name!r}: needs 2 equal-shape "
                                     f"inputs, got {in_shapes}")
                if node.shape != in_shapes[0]:
                    raise GraphError(f"add {node.name!r}: output shape "
                                     f"{node.shape} != input {in_shapes[0]}")
            elif node.kind == "concat":
                b, c, h, w = node.shape
                if c != sum(s[1] for s in in_shapes):
                    raise GraphError(f"concat {node.name!r}: channel sum "
                                     f"mismatch")
            else:
                if len(in_shapes) != 1:
                    raise GraphError(f"{node.name!r} ({node.kind}) takes one "
                                     f"input, got {len(in_shapes)}")
                wl = node.layer.wl
                b, c, h, w = in_shapes[0]
                # conv1 on CPU may take the raw 3-channel image
                if (h, w) != (wl.h, wl.w) or (wl.b != b):
                    raise GraphError(
                        f"{node.name!r}: workload expects input "
                        f"{(wl.b, wl.fi, wl.h, wl.w)}, producer emits "
                        f"{in_shapes[0]}")
                if not node.layer.wl.depthwise and node.kind in \
                        ("conv", "dense") and c != wl.fi:
                    raise GraphError(
                        f"{node.name!r}: channel mismatch fi={wl.fi} vs "
                        f"producer C={c}")

    def describe(self) -> list:
        """Stable structural description (drives network fingerprints)."""
        import dataclasses
        out = []
        for node in self.nodes.values():
            l = node.layer
            out.append((node.name, node.kind, node.shape, node.inputs,
                        None if l is None else
                        (l.kind, l.post_op, l.bias, l.on_cpu,
                         dataclasses.astuple(l.wl))))
        return out
