"""Compression graphs — the port's copy of ``repro.core.graph``.

A :class:`Plan` is the static description of a compressor: a DAG whose nodes
are codecs (or *selectors*, which expand at compression time) and whose
edges are streams.  Edge ids are assigned topologically: ``0 .. n_inputs-1``
are the graph inputs and each node's outputs take the next consecutive ids.
Every edge has one producer and at most one consumer; edges nobody consumes
are terminal and their streams are what the wire stores.

``plan_from_dict`` (``core/serialize.py``, re-exported here) reads the dict
form of a serialized compressor, the ``.ozp`` plan file.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .codec import get_codec

__all__ = ["PlanNode", "Plan", "GraphBuilder", "pipeline", "plan_from_dict"]

KIND_CODEC = "codec"
KIND_SELECTOR = "selector"


def _freeze(obj):
    """Recursively freeze params into hashable structures."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def _thaw(obj):
    if isinstance(obj, tuple) and all(
        isinstance(kv, tuple) and len(kv) == 2 and isinstance(kv[0], str) for kv in obj
    ):
        return {k: _thaw(v) for k, v in obj}
    if isinstance(obj, tuple):
        return [_thaw(v) for v in obj]
    return obj


@dataclass(frozen=True)
class PlanNode:
    kind: str  # KIND_CODEC | KIND_SELECTOR
    name: str
    inputs: Tuple[int, ...]
    n_out: int
    params: tuple = ()  # frozen dict items

    def param_dict(self) -> dict:
        return _thaw(self.params) if self.params else {}


@dataclass(frozen=True)
class Plan:
    """A (possibly dynamic) compression graph."""

    n_inputs: int
    nodes: Tuple[PlanNode, ...]
    name: str = ""

    def validate(self) -> "Plan":
        next_edge = self.n_inputs
        consumed: Dict[int, int] = {}
        for i, node in enumerate(self.nodes):
            if node.kind not in (KIND_CODEC, KIND_SELECTOR):
                raise ValueError(f"node {i}: bad kind {node.kind!r}")
            for e in node.inputs:
                if not (0 <= e < next_edge):
                    raise ValueError(f"node {i} ({node.name}): input edge {e} undefined")
                if e in consumed:
                    raise ValueError(
                        f"edge {e} consumed twice (nodes {consumed[e]} and {i});"
                        " use the 'dup' codec for fan-out"
                    )
                consumed[e] = i
            if node.kind == KIND_SELECTOR and node.n_out != 0:
                raise ValueError(f"selector node {i} must have n_out == 0")
            if node.kind == KIND_CODEC:
                spec = get_codec(node.name)
                if spec.n_inputs >= 0 and len(node.inputs) != spec.n_inputs:
                    raise ValueError(
                        f"node {i} ({node.name}): wants {spec.n_inputs} inputs,"
                        f" wired {len(node.inputs)}"
                    )
                if spec.n_outputs >= 0 and node.n_out != spec.n_outputs:
                    raise ValueError(
                        f"node {i} ({node.name}): spec has {spec.n_outputs} outputs,"
                        f" declared {node.n_out}"
                    )
            next_edge += node.n_out
        return self

    @property
    def is_resolved(self) -> bool:
        return all(n.kind == KIND_CODEC for n in self.nodes)


class GraphBuilder:
    """Imperative builder for :class:`Plan` (the public authoring API)."""

    def __init__(self, n_inputs: int = 1):
        self.n_inputs = n_inputs
        self._nodes: List[PlanNode] = []
        self._next_edge = n_inputs

    def input(self, i: int = 0) -> int:
        if not (0 <= i < self.n_inputs):
            raise IndexError(f"graph has {self.n_inputs} inputs")
        return i

    def add(self, codec: str, *inputs: int, n_out: Optional[int] = None, **params):
        spec = get_codec(codec)
        if n_out is None:
            if spec.n_outputs < 0:
                raise ValueError(
                    f"codec {codec} has variadic outputs; pass n_out= explicitly"
                )
            n_out = spec.n_outputs
        node = PlanNode(KIND_CODEC, codec, tuple(inputs), n_out, _freeze(params))
        self._nodes.append(node)
        outs = list(range(self._next_edge, self._next_edge + n_out))
        self._next_edge += n_out
        if len(outs) == 1:
            return outs[0]
        return outs

    def select(self, selector: str, *inputs: int, **params) -> None:
        """Attach a function graph (expands at compression time)."""
        node = PlanNode(KIND_SELECTOR, selector, tuple(inputs), 0, _freeze(params))
        self._nodes.append(node)

    def build(self, name: str = "") -> Plan:
        return Plan(self.n_inputs, tuple(self._nodes), name).validate()


def pipeline(*codecs, name: str = "") -> Plan:
    """Linear chain convenience: each entry is a codec name or (name, params).

    Multi-output codecs in the middle route output 0 onward; other outputs
    terminate.  The last stage's outputs all terminate.
    """
    g = GraphBuilder(1)
    cur = g.input(0)
    for item in codecs:
        cname, params = (item, {}) if isinstance(item, str) else (item[0], dict(item[1]))
        n_out = params.pop("n_out", None)
        outs = g.add(cname, cur, n_out=n_out, **params)
        cur = outs if isinstance(outs, int) else outs[0]
    return g.build(name or "+".join(c if isinstance(c, str) else c[0] for c in codecs))


# ``plan_from_dict`` lives with the plan files; importable from here too
from .serialize import plan_from_dict  # noqa: E402
