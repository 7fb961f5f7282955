"""The two-phase execution engine — the port's copy of ``repro.core.engine``.

Compression is split into:

  * **resolve** — ``resolve(plan, streams, ctx) -> ResolvedPlan``: selector
    expansion.  Walks the plan in topological order, expanding selectors
    recursively by trial compression, and emits a linear codec-only program.
    (The reference memoizes this in an LRU cache; the port resolves afresh.)
  * **execute** — ``execute(resolved, streams) -> frame``: runs each codec's
    encoder over the concrete streams.  A stream's tensor stays on its device
    from codec to codec; on the card every codec with a kernel launches it.

``compress()`` composes the two on the device the caller names (the card by
default).  ``decompress()`` is the universal decoder, on the card by default
too: parse the frame on the host, copy each stored payload to the device
once, and run every codec's decoder there in reverse topological order —
no parameters and no selectors.

Not in this slice: the delta+bitpack fusion pass (``bitpack`` is not ported,
so no plan can ask for it) and chunked compression into multi-chunk
containers (``chunk_bytes`` raises).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import _device
from . import wire
from .codec import get_codec, get_codec_by_id
from .graph import KIND_CODEC, Plan, _thaw
from .message import Stream, serial
from .selector import get_selector
from .versioning import CURRENT_FORMAT_VERSION, check_compress_version, check_decode_version

__all__ = [
    "CompressionCtx",
    "ResolvedNode",
    "ResolvedStep",
    "ResolvedPlan",
    "resolve",
    "execute",
    "compress",
    "decompress",
]


@dataclass
class CompressionCtx:
    """Knobs visible to selectors during expansion."""

    format_version: int = CURRENT_FORMAT_VERSION
    level: int = 5  # 1 (fastest) .. 9 (smallest); selectors may consult this


@dataclass(frozen=True)
class ResolvedNode:
    """One executed codec as recorded on the wire (headers are per-call)."""

    codec_id: int
    inputs: Tuple[int, ...]
    n_out: int
    header: bytes


@dataclass(frozen=True)
class ResolvedStep:
    """One codec invocation in a resolved program (resolved-plan edge ids)."""

    name: str
    codec_id: int
    inputs: Tuple[int, ...]
    n_out: int
    params: tuple = ()  # frozen dict items (graph._freeze format)

    def param_dict(self) -> dict:
        return _thaw(self.params) if self.params else {}


@dataclass(frozen=True)
class ResolvedPlan:
    """A selector-free compression program."""

    n_inputs: int
    steps: Tuple[ResolvedStep, ...]
    format_version: int
    level: int
    name: str = ""

    def codec_names(self) -> List[str]:
        return [s.name for s in self.steps]


# ------------------------------------------------------------- resolve phase
class _Resolver:
    """Expands selectors by walking the plan over concrete streams.

    Intermediate streams are materialized because nested selectors sample
    their actual inputs; the encoded data is discarded and only the step list
    survives.
    """

    def __init__(self, ctx: CompressionCtx):
        self.ctx = ctx
        self.edges: List[Stream] = []
        self.consumed: List[bool] = []
        self.steps: List[ResolvedStep] = []

    def new_edge(self, s: Stream) -> int:
        self.edges.append(s)
        self.consumed.append(False)
        return len(self.edges) - 1

    def consume(self, e: int) -> Stream:
        if self.consumed[e]:
            raise AssertionError(f"edge {e} consumed twice at resolution")
        self.consumed[e] = True
        return self.edges[e]

    def run_plan(self, plan: Plan, input_edge_ids: Sequence[int], depth: int = 0):
        if depth > 64:
            raise RecursionError("selector expansion too deep (cycle?)")
        if len(input_edge_ids) != plan.n_inputs:
            raise ValueError(
                f"plan {plan.name!r} wants {plan.n_inputs} inputs,"
                f" got {len(input_edge_ids)}"
            )
        emap: Dict[int, int] = {i: eid for i, eid in enumerate(input_edge_ids)}
        next_plan_edge = plan.n_inputs
        for node in plan.nodes:
            in_ids = [emap[e] for e in node.inputs]
            if node.kind == KIND_CODEC:
                spec = _checked_codec(node.name, self.ctx.format_version)
                ins = [self.consume(e) for e in in_ids]
                outs, _header = spec.run_encode(ins, node.param_dict())
                if len(outs) != node.n_out:
                    raise AssertionError(
                        f"codec {node.name}: declared n_out={node.n_out},"
                        f" produced {len(outs)}"
                    )
                out_ids = [self.new_edge(o) for o in outs]
                self.steps.append(
                    ResolvedStep(
                        node.name, spec.codec_id, tuple(in_ids), node.n_out, node.params
                    )
                )
                for k, oid in enumerate(out_ids):
                    emap[next_plan_edge + k] = oid
                next_plan_edge += node.n_out
            else:  # selector: expand recursively
                sel = get_selector(node.name)
                ins = [self.edges[e] for e in in_ids]  # peek, not consume
                subplan = sel.fn(ins, node.param_dict(), self.ctx).validate()
                self.run_plan(subplan, in_ids, depth + 1)


def _checked_codec(name: str, format_version: int):
    spec = get_codec(name)
    if spec.min_version > format_version:
        raise ValueError(
            f"codec {name!r} requires format version"
            f" >= {spec.min_version}, compressing at {format_version}"
        )
    return spec


def _as_streams(inputs) -> List[Stream]:
    if isinstance(inputs, (bytes, bytearray, memoryview)):
        return [serial(inputs)]
    if isinstance(inputs, Stream):
        return [inputs]
    return list(inputs)


def resolve(
    plan: Plan,
    inputs: Union[Stream, bytes, Sequence[Stream]],
    ctx: Optional[CompressionCtx] = None,
) -> ResolvedPlan:
    """Phase 1: expand selectors -> a selector-free ResolvedPlan."""
    ctx = ctx or CompressionCtx()
    check_compress_version(ctx.format_version)
    streams = [s.validate() for s in _as_streams(inputs)]
    if len(streams) != plan.n_inputs:
        raise ValueError(
            f"plan {plan.name!r} wants {plan.n_inputs} inputs, got {len(streams)}"
        )
    plan.validate()
    if plan.is_resolved:
        steps = tuple(
            ResolvedStep(
                n.name,
                _checked_codec(n.name, ctx.format_version).codec_id,
                n.inputs,
                n.n_out,
                n.params,
            )
            for n in plan.nodes
        )
    else:
        r = _Resolver(ctx)
        in_ids = [r.new_edge(s) for s in streams]
        r.run_plan(plan, in_ids)
        steps = tuple(r.steps)
    return ResolvedPlan(len(streams), steps, ctx.format_version, ctx.level, plan.name)


# ------------------------------------------------------------- execute phase
class _Executor:
    """Runs a ResolvedPlan over concrete streams and writes the frame."""

    def __init__(self, resolved: ResolvedPlan, streams: Sequence[Stream]):
        self.resolved = resolved
        self.edges: List[Stream] = list(streams)
        self.consumed: List[bool] = [False] * len(self.edges)
        self.nodes: List[ResolvedNode] = []

    def run(self) -> bytes:
        for step in self.resolved.steps:
            spec = _checked_codec(step.name, self.resolved.format_version)
            ins = []
            for e in step.inputs:
                if self.consumed[e]:
                    raise AssertionError(f"edge {e} consumed twice at runtime")
                self.consumed[e] = True
                ins.append(self.edges[e])
            outs, header = spec.run_encode(ins, step.param_dict())
            if len(outs) != step.n_out:
                raise AssertionError(
                    f"codec {step.name}: resolved n_out={step.n_out},"
                    f" produced {len(outs)}"
                )
            self.edges.extend(outs)
            self.consumed.extend([False] * len(outs))
            self.nodes.append(ResolvedNode(spec.codec_id, step.inputs, len(outs), header))
        stored = [
            (eid, self.edges[eid])
            for eid in range(len(self.edges))
            if not self.consumed[eid]
        ]
        return wire.write_frame(
            self.resolved.format_version, self.resolved.n_inputs, self.nodes, stored
        )


def execute(
    resolved: ResolvedPlan, inputs: Union[Stream, bytes, Sequence[Stream]]
) -> bytes:
    """Phase 2: run a resolved program over concrete streams -> wire frame."""
    streams = [s.validate() for s in _as_streams(inputs)]
    if len(streams) != resolved.n_inputs:
        raise ValueError(
            f"resolved plan wants {resolved.n_inputs} inputs, got {len(streams)}"
        )
    return _Executor(resolved, streams).run()


# ------------------------------------------------------------------ frontend
def compress(
    plan: Plan,
    inputs: Union[Stream, bytes, Sequence[Stream]],
    ctx: Optional[CompressionCtx] = None,
    device: Union[str, torch.device, None] = "cuda",
    *,
    chunk_bytes: Optional[int] = None,
) -> bytes:
    """Compress ``inputs`` with ``plan`` into a self-describing frame.

    The streams are moved to ``device`` (the card unless the caller names the
    CPU) and every codec runs there.  Without a card, the default raises.
    """
    if chunk_bytes:
        raise NotImplementedError(
            "chunk_bytes (multi-chunk containers) is not yet ported to repro_torch"
        )
    dev = _device.resolve_device(device)
    streams = [s.validate().to(dev) for s in _as_streams(inputs)]
    resolved = resolve(plan, streams, ctx)
    return execute(resolved, streams)


def decompress(
    frame: bytes, device: Union[str, torch.device, None] = "cuda"
) -> List[Stream]:
    """The universal decoder: frame -> regenerated inputs on ``device``.

    The card unless the caller names the CPU; without a card, the default
    raises.  The returned streams' tensors lie on that device.
    """
    dev = _device.resolve_device(device)
    if bytes(frame[:4]) == b"OZLC":
        raise wire.FrameError(
            "multi-chunk container frames are not yet ported to repro_torch"
        )
    version, n_inputs, nodes, stored = wire.read_frame(frame, dev)
    check_decode_version(version)

    edges: Dict[int, Stream] = dict(stored)
    counter = n_inputs
    out_ids_per_node: List[Tuple[int, ...]] = []
    for node in nodes:
        out_ids_per_node.append(tuple(range(counter, counter + node.n_out)))
        counter += node.n_out

    for node, out_ids in zip(reversed(nodes), reversed(out_ids_per_node)):
        try:
            spec = get_codec_by_id(node.codec_id)
        except KeyError:
            raise wire.FrameError(
                f"frame v{version} references codec id {node.codec_id},"
                f" which repro_torch does not decode (not yet ported, newer"
                f" writer, or corrupt frame)"
            ) from None
        if spec.min_version > version:
            raise wire.FrameError(
                f"frame v{version} contains codec {spec.name!r}"
                f" (min_version {spec.min_version}) — corrupt frame?"
            )
        try:
            outs = [edges.pop(e) for e in out_ids]
        except KeyError as err:
            raise ValueError(f"corrupt frame: missing edge {err}") from None
        ins = spec.run_decode(outs, node.header)
        if len(ins) != len(node.inputs):
            raise ValueError(
                f"codec {spec.name} regenerated {len(ins)} inputs,"
                f" frame says {len(node.inputs)}"
            )
        for eid, s in zip(node.inputs, ins):
            if eid in edges:
                raise ValueError(f"corrupt frame: edge {eid} regenerated twice")
            edges[eid] = s

    try:
        return [edges[i] for i in range(n_inputs)]
    except KeyError as err:
        raise ValueError(f"corrupt frame: input edge {err} not regenerated") from None
