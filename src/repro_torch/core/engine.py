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

Between the two, ``execute`` runs the **fusion pass** (``fuse_resolved``):
an adjacent ``delta`` -> ``bitpack`` pair becomes one ``fused_delta_bitpack``
step, as the reference's device backend does by default, since the port's
frames are that backend's.  Where the fused codec refuses the data (its
lossless precondition fails), the executor lowers the step back to
``delta`` + ``bitpack``.

``compress(..., chunk_bytes=N)`` splits one input into element-aligned
chunks (views of its tensor on the device, no copy), resolves the plan once
on the first chunk and executes that resolution on every chunk, one after
another; a chunk whose codec refuses it (a ``ValueError``) is resolved
afresh, as the reference does.  The chunk frames go into one ``OZLC``
container.  ``decompress`` decodes each chunk onto the device and joins them
with one ``torch.cat`` there.

Not yet ported: the reference's sessions (worker pools, a resolve cache,
file streaming) and its ``trace`` and ``fuse=`` arguments of ``execute``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import _device
from . import wire
from .codec import get_codec, get_codec_by_id
from .graph import KIND_CODEC, Plan, _thaw
from .message import PACK_BITS, Stream, SType, serial
from .selector import get_selector
from .versioning import (
    CONTAINER_MIN_VERSION,
    CURRENT_FORMAT_VERSION,
    check_compress_version,
    check_decode_version,
)

__all__ = [
    "CompressionCtx",
    "ResolvedNode",
    "ResolvedStep",
    "ResolvedPlan",
    "FUSED_NAME",
    "resolve",
    "fuse_resolved",
    "execute",
    "compress",
    "decompress",
]


FUSED_NAME = "fused_delta_bitpack"


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


# ------------------------------------------------------------- fusion pass
def fuse_resolved(resolved: ResolvedPlan) -> ResolvedPlan:
    """Graph rewrite: adjacent ``delta`` -> ``bitpack`` chains become one
    ``fused_delta_bitpack`` step (K11 on the card).

    Static preconditions only: a ``delta`` with no params and one output
    feeds a one-input ``bitpack`` whose explicit ``bits`` is 0 or in the
    fused codec's choices.  The data-dependent lossless precondition (every
    wrapped u32 delta fits the packing width) is checked per call by the
    executor, which lowers the step back to its constituents when it fails.
    Gated on the fused codec's ``min_version`` (format v4).
    """
    fused_spec = get_codec(FUSED_NAME)
    if resolved.format_version < fused_spec.min_version:
        return resolved
    steps = resolved.steps
    out_edge_of: Dict[int, int] = {}  # step index -> its first output edge id
    e = resolved.n_inputs
    for i, s in enumerate(steps):
        out_edge_of[i] = e
        e += s.n_out
    delta_by_out = {
        out_edge_of[i]: i
        for i, s in enumerate(steps)
        if s.name == "delta" and s.n_out == 1 and not s.params
    }
    producer_of: Dict[int, int] = {}  # bitpack step index -> its delta's index
    for j, s in enumerate(steps):
        if s.name != "bitpack" or len(s.inputs) != 1:
            continue
        bits = int(s.param_dict().get("bits", 0))
        if bits and bits not in PACK_BITS:
            continue  # a width the 32-bit-word kernel cannot express
        i = delta_by_out.get(s.inputs[0])
        if i is not None:
            producer_of[j] = i
    if not producer_of:
        return resolved

    fused_deltas = set(producer_of.values())
    emap: Dict[int, int] = {i: i for i in range(resolved.n_inputs)}
    new_steps: List[ResolvedStep] = []
    next_new = resolved.n_inputs
    for i, s in enumerate(steps):
        if i in fused_deltas:
            continue  # its output edge is interior to the fused pair
        if i in producer_of:
            bits = int(s.param_dict().get("bits", 0))
            new_steps.append(
                ResolvedStep(
                    FUSED_NAME,
                    fused_spec.codec_id,
                    tuple(emap[e] for e in steps[producer_of[i]].inputs),
                    1,
                    (("bits", bits),) if bits else (),
                )
            )
        else:
            new_steps.append(
                ResolvedStep(
                    s.name, s.codec_id, tuple(emap[e] for e in s.inputs), s.n_out, s.params
                )
            )
        for k in range(s.n_out):
            emap[out_edge_of[i] + k] = next_new
            next_new += 1
    return ResolvedPlan(
        resolved.n_inputs, tuple(new_steps), resolved.format_version,
        resolved.level, resolved.name,
    )


# ------------------------------------------------------------- execute phase
class _Executor:
    """Runs a ResolvedPlan over concrete streams and writes the frame.

    Keeps its own runtime edge numbering (``emap``: resolved edge id ->
    runtime edge id), because a fused step may lower to two wire nodes with
    an interior edge that the resolved plan never saw.
    """

    def __init__(self, resolved: ResolvedPlan, streams: Sequence[Stream]):
        self.resolved = resolved
        self.edges: List[Stream] = list(streams)
        self.consumed: List[bool] = [False] * len(self.edges)
        self.nodes: List[ResolvedNode] = []
        self.emap: Dict[int, int] = {i: i for i in range(len(self.edges))}

    def _new_edge(self, s: Stream) -> int:
        self.edges.append(s)
        self.consumed.append(False)
        return len(self.edges) - 1

    def _consume(self, e: int) -> Stream:
        if self.consumed[e]:
            raise AssertionError(f"edge {e} consumed twice at runtime")
        self.consumed[e] = True
        return self.edges[e]

    def _commit(self, codec_id: int, rt_ins: List[int], outs, header: bytes) -> List[int]:
        out_ids = [self._new_edge(o) for o in outs]
        self.nodes.append(ResolvedNode(codec_id, tuple(rt_ins), len(outs), header))
        return out_ids

    def _run_codec(self, name: str, params: dict, rt_ins: List[int]) -> List[int]:
        spec = _checked_codec(name, self.resolved.format_version)
        outs, header = spec.run_encode([self._consume(e) for e in rt_ins], params)
        return self._commit(spec.codec_id, rt_ins, outs, header)

    def _run_fused(self, step: ResolvedStep, rt_ins: List[int]) -> List[int]:
        """Run the fused codec when lossless, else lower to delta + bitpack.

        The encoder checks the lossless precondition itself and refuses with
        a ValueError, which is the lowering signal.  The input edge is
        consumed only once the fused attempt commits.
        """
        spec = _checked_codec(FUSED_NAME, self.resolved.format_version)
        params = step.param_dict()
        try:
            outs, header = spec.run_encode([self.edges[rt_ins[0]]], params)  # peek
        except ValueError:
            explicit = int(params.get("bits", 0))
            d_out = self._run_codec("delta", {}, rt_ins)
            return self._run_codec("bitpack", {"bits": explicit} if explicit else {}, d_out)
        self._consume(rt_ins[0])
        return self._commit(spec.codec_id, rt_ins, outs, header)

    def run(self) -> bytes:
        next_resolved_edge = self.resolved.n_inputs
        for step in self.resolved.steps:
            rt_ins = [self.emap[e] for e in step.inputs]
            if step.name == FUSED_NAME:
                out_ids = self._run_fused(step, rt_ins)
            else:
                out_ids = self._run_codec(step.name, step.param_dict(), rt_ins)
                if len(out_ids) != step.n_out:
                    raise AssertionError(
                        f"codec {step.name}: resolved n_out={step.n_out},"
                        f" produced {len(out_ids)}"
                    )
            for k, oid in enumerate(out_ids):
                self.emap[next_resolved_edge + k] = oid
            next_resolved_edge += step.n_out
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
    """Phase 2: fuse, then run a resolved program over concrete streams -> frame."""
    streams = [s.validate() for s in _as_streams(inputs)]
    if len(streams) != resolved.n_inputs:
        raise ValueError(
            f"resolved plan wants {resolved.n_inputs} inputs, got {len(streams)}"
        )
    return _Executor(fuse_resolved(resolved), streams).run()


# ------------------------------------------------------------------ chunking
# chunks of the chunked path whose codecs refused the first chunk's
# resolution, so that they were resolved afresh; counted over the process,
# as the kernels' launches are (``kernels.ops``)
fresh_resolves = 0


def _split_chunks(s: Stream, chunk_bytes: int) -> List[Stream]:
    """Element-aligned split; every chunk holds at least one element.

    Each chunk is a view of ``s``'s tensor on its device.  STRING streams
    pack greedily: a chunk takes whole strings while its byte total stays
    <= ``chunk_bytes`` (the first string is always taken, however large).
    """
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    if s.stype == SType.STRING:
        lens = s.lengths if s.lengths is not None else np.zeros(0, np.uint32)
        if lens.size == 0:
            return [s]
        pre = np.zeros(lens.size + 1, np.int64)  # exclusive byte offsets
        np.cumsum(lens, dtype=np.int64, out=pre[1:])
        out: List[Stream] = []
        i = 0
        while i < lens.size:
            j = int(np.searchsorted(pre, pre[i] + chunk_bytes, side="right")) - 1
            j = max(j, i + 1)
            out.append(
                Stream(s.data[int(pre[i]) : int(pre[j])], SType.STRING, 1, lens[i:j])
            )
            i = j
        return out
    elt_bytes = s.width if s.stype in (SType.NUMERIC, SType.STRUCT) else 1
    per = max(1, chunk_bytes // elt_bytes)
    n = s.n_elts
    if n <= per:
        return [s]
    datum_per_elt = s.width if s.stype == SType.STRUCT else 1
    return [
        Stream(s.data[i * datum_per_elt : (i + per) * datum_per_elt], s.stype, s.width)
        for i in range(0, n, per)
    ]


def _concat_decoded(parts: List[Stream]) -> Stream:
    """Join a container's decoded chunks with one ``torch.cat`` on their device.

    A NUMERIC result has its width's carrier dtype; its bytes are the
    reference's unsigned join's.
    """
    s0 = parts[0]
    if any(p.stype != s0.stype or p.width != s0.width for p in parts):
        raise wire.FrameError("container chunks disagree on stream type")
    data = torch.cat([p.data for p in parts])
    if s0.stype == SType.STRING:
        lengths = np.concatenate(
            [p.lengths if p.lengths is not None else np.zeros(0, np.uint32) for p in parts]
        ).astype(np.uint32)
        return Stream(data, SType.STRING, 1, lengths).validate()
    return Stream(data, s0.stype, s0.width).validate()


def _compress_chunks(plan: Plan, chunks: List[Stream], ctx: CompressionCtx) -> bytes:
    """Resolve once on the first chunk, execute that on every chunk -> container.

    A chunk whose codec refuses the shared resolution with a ``ValueError``
    gets a fresh resolve of its own; a failure then is a genuine error.  A
    kernel's precondition or launch error is not a ``ValueError``
    (``ops.KernelError``, ``RuntimeError``) and propagates.
    """
    global fresh_resolves
    resolved = resolve(plan, chunks[:1], ctx)
    frames = []
    for ch in chunks:
        try:
            frames.append(execute(resolved, [ch]))
        except ValueError:
            fresh_resolves += 1
            frames.append(execute(resolve(plan, [ch], ctx), [ch]))
    return wire.write_container(ctx.format_version, frames)


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

    ``chunk_bytes=N`` splits the (single) input into chunks of about N bytes,
    compressed independently into a multi-chunk container frame (format
    v4+); a split into one chunk writes a plain frame.  ``chunk_bytes=0`` or
    ``None`` disables chunking.
    """
    dev = _device.resolve_device(device)
    ctx = ctx or CompressionCtx()
    streams = [s.validate().to(dev) for s in _as_streams(inputs)]
    if chunk_bytes:
        if len(streams) != 1:
            raise ValueError("chunked compression supports exactly one input")
        if ctx.format_version < CONTAINER_MIN_VERSION:
            raise ValueError(
                f"chunk_bytes requires format version >= {CONTAINER_MIN_VERSION}"
                f" (compressing at {ctx.format_version})"
            )
        chunks = _split_chunks(streams[0], chunk_bytes)
        if len(chunks) > 1:
            return _compress_chunks(plan, chunks, ctx)
    resolved = resolve(plan, streams, ctx)
    return execute(resolved, streams)


def decompress(
    frame: bytes, device: Union[str, torch.device, None] = "cuda"
) -> List[Stream]:
    """The universal decoder: frame or container -> regenerated inputs on
    ``device``.

    The card unless the caller names the CPU; without a card, the default
    raises.  The returned streams' tensors lie on that device.  A container's
    chunks each decode onto the device and join there into one stream.
    """
    dev = _device.resolve_device(device)
    if not wire.is_container(frame):
        return _decompress_single(frame, dev)
    version, sub_frames = wire.read_container(frame)
    check_decode_version(version)
    if not sub_frames:
        raise wire.FrameError("empty container")
    parts = [_decompress_single(sub, dev) for sub in sub_frames]
    if any(len(p) != 1 for p in parts):
        raise wire.FrameError("container chunks must be single-input frames")
    return [_concat_decoded([p[0] for p in parts])]


def _decompress_single(frame: bytes, dev: torch.device) -> List[Stream]:
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
        ins = spec.run_decode(outs, node.header, dev)
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
