"""The two-phase execution engine — the port's copy of ``repro.core.engine``.

Compression is split into:

  * **resolve** — ``resolve(plan, streams, ctx) -> ResolvedPlan``: selector
    expansion.  Walks the plan in topological order, expanding selectors
    recursively by trial compression, and emits a linear codec-only program.
    Resolution is memoized on ``(plan, stream metas, level, format_version)``
    in an LRU cache, as the reference's is, so a caller pays for selector
    trials once per stream shape (``use_cache=False`` resolves afresh).
    With the resolve check on (``REPRO_RESOLVE_CHECK=1`` or
    ``set_resolve_check(True)``) every resolve that misses the cache first
    type-checks the plan against its inputs' stream types and raises
    ``PlanTypeError`` before any encoder runs.
  * **execute** — ``execute(resolved, streams) -> frame``: runs each codec's
    encoder over the concrete streams.  A stream's tensor stays on its device
    from codec to codec; on the card every codec with a kernel launches it.

Between the two, ``execute`` runs the **fusion pass** (``fuse_resolved``):
an adjacent ``delta`` -> ``bitpack`` pair becomes one ``fused_delta_bitpack``
step, as the reference's device backend does by default, since the port's
frames are that backend's (``fuse=False`` skips it).  Where the fused codec
refuses the data (its lossless precondition fails), the executor lowers the
step back to ``delta`` + ``bitpack``.  ``trace=`` collects one
``(codec_name, input_bytes)`` pair per executed step.

Sessions
--------
:class:`CompressorSession` and :class:`DecompressorSession` are the
long-lived form of the one-shot calls: a session owns its plan, a
coder-table scratch (:class:`ExecScratch`), its device and a persistent
thread pool.  ``chunk_bytes=N`` splits one input into element-aligned
chunks (views of its tensor on the device), resolves the plan once on the
first chunk, and encodes the chunks in parallel on the pool, writing the
frames in order into one ``OZLC`` container behind a bounded in-flight
window; a chunk whose codec refuses the shared resolution (a ``ValueError``)
is resolved afresh.  The host stages that dominate a chunk (zlib, the
frame's copies) release the GIL, so the chunks really run in parallel.
Every pool thread launches on the CUDA stream that was current where the
call began, so a worker reads a chunk only after the caller's writes to it.
A kernel's error (``ops.KernelError``) or a CUDA fault propagates out of the
pool; there is no host failover.  The module-level ``compress()`` and
``decompress()`` are thin wrappers over throwaway sessions.

``decompress()`` is the universal decoder, on the card by default: parse the
frame on the host, copy each stored payload to the device once, and run
every codec's decoder there in reverse topological order — no parameters and
no selectors.  A container's chunks decode on the pool and join with one
``torch.cat`` on the device.

:class:`Compressor` is the deployable facade: a plan with its format version,
level, device and chunking, which serializes to the ``.ozp`` plan file
(``core/serialize.py``).  ``DecompressorSession.decompress_salvage`` is the
recovery decoder over ``wire.salvage_container``: every CRC-valid chunk of a
damaged container decodes on the session's device.  It catches only a
codec's ``ValueError`` (``FrameError`` is one) as damage, never a kernel's
error or a CUDA fault.
"""
from __future__ import annotations

import io
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as _futures_wait
from dataclasses import dataclass
from typing import (
    BinaryIO,
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

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
    "ExecScratch",
    "ResolvedNode",
    "ResolvedStep",
    "ResolvedPlan",
    "StreamMeta",
    "stream_meta",
    "FUSED_NAME",
    "resolve",
    "fuse_resolved",
    "execute",
    "resolve_cache_info",
    "resolve_cache_clear",
    "set_resolve_check",
    "compress",
    "decompress",
    "CompressorSession",
    "DecompressorSession",
    "SessionPool",
    "Compressor",
]


FUSED_NAME = "fused_delta_bitpack"

DeviceLike = Union[str, torch.device, None]


@dataclass
class CompressionCtx:
    """Knobs visible to selectors during expansion."""

    format_version: int = CURRENT_FORMAT_VERSION
    level: int = 5  # 1 (fastest) .. 9 (smallest); selectors may consult this


class ExecScratch:
    """Per-call scratch state threaded through codec invocations.

    It scopes the entropy coder-table cache (``repro_torch.codecs
    .coder_cache``): one call, including every chunk a session's pool fans
    out, shares one read-only table namespace, so identical Huffman and tANS
    tables are built (and copied to the card) once, not once per chunk.
    The cache is lock-guarded and its values are never written, which is
    what makes the sharing thread-safe.  ``coder_cache`` scopes an existing
    cache instead of a new one of ``table_cache_size`` entries.
    """

    def __init__(self, table_cache_size: int = 256, *, coder_cache=None):
        from ..codecs.coder_cache import CoderCache  # lazy: no core cycle

        self.coder_cache = (
            coder_cache if coder_cache is not None else CoderCache(maxsize=table_cache_size)
        )

    def activate(self):
        """Context manager making this scratch current for codec calls."""
        from ..codecs.coder_cache import scoped

        return scoped(self.coder_cache)

    def table_cache_info(self) -> dict:
        return self.coder_cache.info()


@dataclass(frozen=True)
class ResolvedNode:
    """One executed codec as recorded on the wire (headers are per-call)."""

    codec_id: int
    inputs: Tuple[int, ...]
    n_out: int
    header: bytes


# ----------------------------------------------------------- resolved plans
@dataclass(frozen=True)
class StreamMeta:
    """The shape of a stream, for resolve-cache keying (not its contents)."""

    stype: SType
    width: int
    size_bucket: int  # floor(log2(n_elts))+1 — selector choices track scale


def stream_meta(s: Stream) -> StreamMeta:
    return StreamMeta(s.stype, s.width, int(s.n_elts).bit_length())


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
    """A selector-free compression program: the cacheable resolve artifact."""

    n_inputs: int
    steps: Tuple[ResolvedStep, ...]
    format_version: int
    level: int
    name: str = ""
    fused: bool = False  # True once the delta+bitpack rewrite has run

    def codec_names(self) -> List[str]:
        return [s.name for s in self.steps]


# ------------------------------------------------------------- resolve phase
class _Resolver:
    """Expands selectors by walking the plan over concrete streams.

    Intermediate streams are materialized because nested selectors sample
    their actual inputs; the encoded data is discarded and only the step list
    survives, which is what makes the result reusable across calls.
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


def _flatten(plan: Plan, ctx: CompressionCtx) -> Tuple[ResolvedStep, ...]:
    """Selector-free plans resolve without touching any data."""
    return tuple(
        ResolvedStep(
            n.name,
            _checked_codec(n.name, ctx.format_version).codec_id,
            n.inputs,
            n.n_out,
            n.params,
        )
        for n in plan.nodes
    )


# The memo: (plan, input metas, level, format_version) -> ResolvedPlan.  LRU
# so long-running callers with many stream shapes stay bounded.  A resolved
# plan names codecs only, never a device, so one entry serves the card and
# the CPU alike, as one entry of the reference serves both its backends.
_CACHE_MAX = 512
_cache: "OrderedDict[tuple, ResolvedPlan]" = OrderedDict()
_cache_lock = threading.Lock()
_cache_stats = {"hits": 0, "misses": 0}


def resolve_cache_info() -> dict:
    with _cache_lock:
        return {
            "hits": _cache_stats["hits"],
            "misses": _cache_stats["misses"],
            "size": len(_cache),
            "maxsize": _CACHE_MAX,
        }


def resolve_cache_clear() -> None:
    with _cache_lock:
        _cache.clear()
        _cache_stats["hits"] = 0
        _cache_stats["misses"] = 0


# Opt-in debug assert: type-check every plan entering resolve() against the
# concrete input types (repro_torch.analysis), before any encoder runs and so
# before any kernel launches.  Off by default: the static check belongs at
# registration.  It reads each input's stype and width, never its data.
_RESOLVE_CHECK = os.environ.get("REPRO_RESOLVE_CHECK", "") not in ("", "0")


def set_resolve_check(enabled: bool) -> None:
    """Toggle the ``REPRO_RESOLVE_CHECK`` debug assert programmatically."""
    global _RESOLVE_CHECK
    _RESOLVE_CHECK = bool(enabled)


def _debug_check_plan(plan: Plan, metas, ctx: CompressionCtx) -> None:
    from ..analysis import PlanTypeError, check_plan  # lazy: no import cycle

    report = check_plan(
        plan,
        format_version=ctx.format_version,
        input_atoms=[(int(m.stype), int(m.width)) for m in metas],
    )
    if not report.ok:
        raise PlanTypeError(
            f"resolve check: plan {plan.name!r} is ill-typed for these"
            f" inputs: {'; '.join(str(d) for d in report.errors)}",
            report.errors,
        )


def _engine_after_fork() -> None:
    """Re-arm the module-level locks in a forked child.

    A lock captured mid-acquire by a fork would deadlock the child's first
    resolve.  The memoized entries are immutable and carry over.  (A forked
    child cannot use a CUDA context made in its parent: such a child must
    start with no CUDA state, or be spawned.)
    """
    global _cache_lock, _fresh_lock
    _cache_lock = threading.Lock()
    _fresh_lock = threading.Lock()


if hasattr(os, "register_at_fork"):  # pragma: no branch - POSIX
    os.register_at_fork(after_in_child=_engine_after_fork)


def _as_streams(inputs) -> List[Stream]:
    if isinstance(inputs, (bytes, bytearray, memoryview)):
        return [serial(inputs)]
    if isinstance(inputs, Stream):
        return [inputs]
    return list(inputs)


def _all_metas(inputs) -> bool:
    return (
        isinstance(inputs, (list, tuple))
        and len(inputs) > 0
        and all(isinstance(x, StreamMeta) for x in inputs)
    )


def resolve(
    plan: Plan,
    inputs: Union[Stream, bytes, Sequence[Stream], Sequence[StreamMeta]],
    ctx: Optional[CompressionCtx] = None,
    *,
    use_cache: bool = True,
) -> ResolvedPlan:
    """Phase 1: expand selectors once -> a cached, inspectable ResolvedPlan.

    ``inputs`` may be concrete streams or bare :class:`StreamMeta` values;
    metas suffice only for selector-free plans (a plan with selectors needs
    real data to run its trial compressions on).
    """
    resolved, _was_hit = _resolve_impl(plan, inputs, ctx, use_cache=use_cache)
    return resolved


def _resolve_impl(
    plan: Plan, inputs, ctx: Optional[CompressionCtx], *, use_cache: bool
) -> Tuple[ResolvedPlan, bool]:
    """resolve() plus whether the result came from the cache (for the retry)."""
    ctx = ctx or CompressionCtx()
    check_compress_version(ctx.format_version)
    metas_only = _all_metas(inputs)
    if metas_only:
        items: list = list(inputs)
        metas = tuple(items)
    else:
        items = [s.validate() for s in _as_streams(inputs)]
        metas = tuple(stream_meta(s) for s in items)
    if len(metas) != plan.n_inputs:
        raise ValueError(
            f"plan {plan.name!r} wants {plan.n_inputs} inputs, got {len(metas)}"
        )

    key = (plan, metas, ctx.level, ctx.format_version)
    if use_cache:
        with _cache_lock:
            hit = _cache.get(key)
            if hit is not None:
                _cache.move_to_end(key)
                _cache_stats["hits"] += 1
                return hit, True
            _cache_stats["misses"] += 1

    plan.validate()
    if _RESOLVE_CHECK:
        _debug_check_plan(plan, metas, ctx)
    if plan.is_resolved:
        steps = _flatten(plan, ctx)
    else:
        if metas_only:
            raise ValueError(
                "resolving a plan with selectors requires concrete streams,"
                " not StreamMeta"
            )
        r = _Resolver(ctx)
        in_ids = [r.new_edge(s) for s in items]
        r.run_plan(plan, in_ids)
        steps = tuple(r.steps)
    resolved = ResolvedPlan(len(metas), steps, ctx.format_version, ctx.level, plan.name)
    if use_cache:
        with _cache_lock:
            _cache[key] = resolved
            while len(_cache) > _CACHE_MAX:
                _cache.popitem(last=False)
    return resolved, False


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
    if resolved.fused or resolved.format_version < fused_spec.min_version:
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
        return ResolvedPlan(
            resolved.n_inputs, steps, resolved.format_version, resolved.level,
            resolved.name, fused=True,
        )

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
        resolved.level, resolved.name, fused=True,
    )


# ------------------------------------------------------------- execute phase
class _Executor:
    """Runs a ResolvedPlan over concrete streams and writes the frame.

    Keeps its own runtime edge numbering (``emap``: resolved edge id ->
    runtime edge id), because a fused step may lower to two wire nodes with
    an interior edge that the resolved plan never saw.

    ``trace`` (optional) collects one ``(codec_name, input_bytes)`` pair per
    executed codec, in execution order; a fused step records one
    ``(FUSED_NAME, nbytes)`` entry, and a lowered one its two codecs.
    """

    def __init__(
        self,
        resolved: ResolvedPlan,
        streams: Sequence[Stream],
        trace: Optional[List[Tuple[str, int]]] = None,
    ):
        self.resolved = resolved
        self.trace = trace
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
        ins = [self._consume(e) for e in rt_ins]
        if self.trace is not None:
            self.trace.append((name, sum(s.nbytes for s in ins)))
        outs, header = spec.run_encode(ins, params)
        return self._commit(spec.codec_id, rt_ins, outs, header)

    def _run_fused(self, step: ResolvedStep, rt_ins: List[int]) -> List[int]:
        """Run the fused codec when lossless, else lower to delta + bitpack.

        The encoder checks the lossless precondition itself and refuses with
        a ValueError, which is the lowering signal.  The input edge is
        consumed only once the fused attempt commits.
        """
        spec = _checked_codec(FUSED_NAME, self.resolved.format_version)
        params = step.param_dict()
        s = self.edges[rt_ins[0]]  # peek: do not consume before we commit
        try:
            outs, header = spec.run_encode([s], params)
        except ValueError:
            explicit = int(params.get("bits", 0))
            d_out = self._run_codec("delta", {}, rt_ins)
            return self._run_codec("bitpack", {"bits": explicit} if explicit else {}, d_out)
        self._consume(rt_ins[0])
        if self.trace is not None:
            self.trace.append((FUSED_NAME, s.nbytes))
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
    resolved: ResolvedPlan,
    inputs: Union[Stream, bytes, Sequence[Stream]],
    *,
    fuse: bool = True,
    scratch: Optional[ExecScratch] = None,
    trace: Optional[List[Tuple[str, int]]] = None,
) -> bytes:
    """Phase 2: run a resolved program over concrete streams -> wire frame.

    ``fuse`` (default True, as the reference's device backend) runs the
    fusion pass first.  ``scratch`` scopes the coder-table cache; a session
    passes one scratch to every pool worker so read-only tables are built
    once.  ``trace`` (a caller-owned list) collects ``(codec_name,
    input_bytes)`` per executed step — see :class:`_Executor`.
    """
    streams = [s.validate() for s in _as_streams(inputs)]
    if len(streams) != resolved.n_inputs:
        raise ValueError(
            f"resolved plan wants {resolved.n_inputs} inputs, got {len(streams)}"
        )
    if fuse:
        resolved = fuse_resolved(resolved)
    if scratch is None:
        return _Executor(resolved, streams, trace).run()
    with scratch.activate():
        return _Executor(resolved, streams, trace).run()


# ------------------------------------------------------------------ chunking
# chunks of the chunked path whose codecs refused the first chunk's
# resolution, so that they were resolved afresh; counted over the process,
# as the kernels' launches are (``kernels.ops``), under a lock, since the
# pool's threads count
fresh_resolves = 0
_fresh_lock = threading.Lock()


def _count_fresh_resolve() -> None:
    global fresh_resolves
    with _fresh_lock:
        fresh_resolves += 1


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


def _check_chunkable(streams: List[Stream], ctx: CompressionCtx) -> None:
    if len(streams) != 1:
        raise ValueError("chunked compression supports exactly one input")
    if ctx.format_version < CONTAINER_MIN_VERSION:
        raise ValueError(
            f"chunk_bytes requires format version >= {CONTAINER_MIN_VERSION}"
            f" (compressing at {ctx.format_version})"
        )


# ------------------------------------------------------------------ sessions
_DRAW_END = object()  # sentinel: the chunk source is exhausted


def on_caller_stream(device: torch.device, fn: Callable) -> Callable:
    """``fn`` bound to the CUDA stream current in the calling thread.

    A pool thread's current stream is the default stream, not the one a
    caller runs under (``torch.cuda.stream(s)``); every launch, copy and
    allocation of the call goes to the caller's stream instead, so a
    worker's reads are ordered after the caller's writes to its input.
    """
    if device.type != "cuda":
        return fn
    caller = torch.cuda.current_stream(device)

    def bound(*args):
        with torch.cuda.stream(caller):
            return fn(*args)

    return bound


class _SessionBase:
    """Shared pool, scratch and device plumbing for the two session classes."""

    def __init__(
        self,
        device: DeviceLike,
        n_workers: Optional[int],
        window: Optional[int],
        table_cache_size: Optional[int],
        pool_name: str,
        scratch: Optional[ExecScratch] = None,
        prefetch: bool = True,
    ):
        from ..codecs.coder_cache import active_cache  # lazy: no core cycle

        self.device = _device.resolve_device(device)
        self.n_workers = n_workers
        # a caller-provided scratch lets many sessions share one coder-table
        # cache; with neither a scratch nor a size, the session shares the
        # cache active here (the process-wide one at top level, the enclosing
        # call's in a selector trial), so that throwaway sessions do not
        # rebuild and re-copy their tables on every call
        if scratch is None:
            scratch = (
                ExecScratch(coder_cache=active_cache())
                if table_cache_size is None
                else ExecScratch(table_cache_size)
            )
        self.scratch = scratch
        self._window = window
        self._pool: Optional[ThreadPoolExecutor] = None
        self._draw_pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self._pool_name = pool_name
        self.prefetch = prefetch
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, float] = {
            "calls": 0,
            "chunks": 0,
            "bytes_in": 0,
            "bytes_out": 0,
            "max_inflight": 0,
            # double-buffer accounting: a *hit* is a source draw (split, file
            # read, host-to-card copy) that finished entirely in the shadow of
            # in-flight encodes; the _s counters are the calling thread's
            # seconds blocked on each pipeline stage
            "prefetch_hits": 0,
            "prefetch_misses": 0,
            "draw_wait_s": 0.0,
            "encode_wait_s": 0.0,
        }

    def _bump(self, **deltas: float) -> None:
        """Lock-guarded counter updates (sessions may be shared by threads)."""
        with self._stats_lock:
            for k, v in deltas.items():
                self.stats[k] += v

    def _pool_get(self) -> ThreadPoolExecutor:
        """The persistent executor, created on the first chunked call."""
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.n_workers or len(os.sched_getaffinity(0)),
                    thread_name_prefix=self._pool_name,
                )
            return self._pool

    def _draw_pool_get(self) -> ThreadPoolExecutor:
        """One dedicated thread for source draws: the double buffer's host
        stage must not queue behind encodes on the shared pool."""
        with self._pool_lock:
            if self._draw_pool is None:
                self._draw_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=self._pool_name + "-draw"
                )
            return self._draw_pool

    @property
    def window(self) -> int:
        """Max chunks in flight: bounds peak memory at ~window × chunk size."""
        if self._window:
            return max(1, self._window)
        return 2 * (self.n_workers or len(os.sched_getaffinity(0)))

    def _window_map(
        self, fn: Callable, items: Iterable, head: Optional[list] = None
    ) -> Iterator:
        """Map ``fn`` over ``items`` on the pool, yielding results *in order*
        while keeping at most ``self.window`` tasks (and their inputs and
        outputs) alive.  ``head`` prepends already-drawn items.

        Double-buffered: with :attr:`prefetch` on, the next item is drawn
        from the source on the draw thread while encodes are in flight.  At
        most one draw is in flight, preserving the source's single-consumer
        contract.  Both run on the calling thread's CUDA stream.
        """
        pool = self._pool_get()
        window = self.window
        fn = on_caller_stream(self.device, fn)
        it = iter(items)
        pending: "deque" = deque(pool.submit(fn, x) for x in (head or []))
        drawer = self._draw_pool_get() if self.prefetch else None
        draw_next = on_caller_stream(self.device, next)
        draw = drawer.submit(draw_next, it, _DRAW_END) if drawer is not None else None
        exhausted = False
        try:
            while pending or not exhausted:
                while not exhausted and len(pending) < window:
                    if draw is not None:
                        hidden = bool(pending) and draw.done()
                        t0 = time.perf_counter()
                        item = draw.result()
                        dt = time.perf_counter() - t0
                        if item is _DRAW_END:
                            exhausted = True
                            draw = None
                            break
                        pending.append(pool.submit(fn, item))
                        draw = drawer.submit(draw_next, it, _DRAW_END)
                        self._bump(
                            **{"prefetch_hits" if hidden else "prefetch_misses": 1},
                            draw_wait_s=dt,
                        )
                    else:
                        try:
                            item = next(it)
                        except StopIteration:
                            exhausted = True
                            break
                        pending.append(pool.submit(fn, item))
                if not pending:
                    break
                with self._stats_lock:
                    if len(pending) > self.stats["max_inflight"]:
                        self.stats["max_inflight"] = len(pending)
                t0 = time.perf_counter()
                # wait on the oldest task AND the in-flight draw: a source that
                # dies drawing chunk N+1 fails the call as soon as the draw
                # thread reports it, not behind a full window of slow encodes
                while True:
                    waiters = [pending[0]]
                    if draw is not None and not draw.done():
                        waiters.append(draw)
                    _futures_wait(waiters, return_when=FIRST_COMPLETED)
                    if draw is not None and draw.done() and draw.exception() is not None:
                        draw.result()  # raises the source's error promptly
                    if pending[0].done():
                        break
                result = pending.popleft().result()
                self._bump(encode_wait_s=time.perf_counter() - t0)
                yield result
        finally:
            for fut in pending:
                fut.cancel()
            if draw is not None:
                draw.cancel()

    def close(self) -> None:
        """Release the pool.  The session stays usable (a new pool is made on
        demand), so throwaway wrapper usage is cheap and idempotent."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
            draw_pool, self._draw_pool = self._draw_pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if draw_pool is not None:
            draw_pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


class CompressorSession(_SessionBase):
    """A reusable, streaming compression session (one plan, many inputs).

    Owns what a ``compress()`` call would otherwise rebuild: the resolve-cache
    handle for its plan, a coder-table :class:`ExecScratch` shared by every
    chunk it encodes, its device, and a persistent thread pool.  The chunked
    path pipelines *split → parallel encode → in-order incremental write*
    behind a bounded in-flight window, so a lazy chunk iterator
    (``repro_torch.core.stream_io``) compresses inputs of any size with peak
    memory ≈ ``window × chunk_bytes``.  ``window`` bounds chunks in flight,
    ``n_workers`` sizes the pool, ``prefetch=False`` turns the double buffer
    off.  ``table_cache_size=N`` gives the session a coder-table cache of its
    own; by default it shares the cache active where it is made (the
    reference gives every session its own 256-entry cache, which a
    throwaway session would rebuild on every call).

    The inputs are moved to ``device`` (the card unless the caller names the
    CPU; without a card the default raises).  Output is byte-identical to
    the reference's ``CompressorSession(backend="device")`` with the same
    arguments: sessions change *when* work happens, never the wire format.
    Thread-safe for concurrent calls (the caches are lock-guarded and their
    values immutable).  The reference's ``failover=`` is not ported: its
    retry on the host would hide the card's faults.
    """

    def __init__(
        self,
        plan: Plan,
        *,
        ctx: Optional[CompressionCtx] = None,
        device: DeviceLike = "cuda",
        chunk_bytes: Optional[int] = None,
        n_workers: Optional[int] = None,
        window: Optional[int] = None,
        use_resolve_cache: bool = True,
        table_cache_size: Optional[int] = None,
        scratch: Optional[ExecScratch] = None,
        prefetch: bool = True,
    ):
        super().__init__(
            device, n_workers, window, table_cache_size, "ozl-enc", scratch, prefetch
        )
        self.plan = plan.validate()
        self.ctx = ctx or CompressionCtx()
        check_compress_version(self.ctx.format_version)
        self.chunk_bytes = chunk_bytes
        self.use_resolve_cache = use_resolve_cache

    def _streams(self, inputs) -> List[Stream]:
        return [s.validate().to(self.device) for s in _as_streams(inputs)]

    # ------------------------------------------------------------ one-shot
    def compress(
        self,
        inputs: Union[Stream, bytes, Sequence[Stream]],
        *,
        chunk_bytes: Optional[int] = None,
    ) -> bytes:
        """Compress to an in-memory frame (chunked -> container record).

        ``chunk_bytes`` overrides the session default; pass 0 to force an
        unchunked frame from a chunking-enabled session.
        """
        cb = self.chunk_bytes if chunk_bytes is None else chunk_bytes
        streams = self._streams(inputs)
        self._bump(calls=1, bytes_in=sum(s.nbytes for s in streams))
        if cb:
            _check_chunkable(streams, self.ctx)
            chunks = _split_chunks(streams[0], cb)
            if len(chunks) > 1:
                buf = io.BytesIO()
                self.compress_chunks(chunks, buf, n_chunks=len(chunks))
                frame = buf.getvalue()
                self._bump(bytes_out=len(frame))
                return frame
        frame = self._compress_single(streams)
        self._bump(bytes_out=len(frame))
        return frame

    def _execute(
        self,
        resolved: ResolvedPlan,
        streams: List[Stream],
        trace: Optional[List[Tuple[str, int]]] = None,
    ) -> bytes:
        return execute(resolved, streams, scratch=self.scratch, trace=trace)

    def _compress_single(
        self, streams: List[Stream], trace: Optional[List[Tuple[str, int]]] = None
    ) -> bytes:
        resolved, was_hit = _resolve_impl(
            self.plan, streams, self.ctx, use_cache=self.use_resolve_cache
        )
        try:
            return self._execute(resolved, streams, trace)
        except ValueError:
            # A cached resolution is keyed on stream *shape*, but a selector's
            # choice can be inapplicable to new *values* of the same shape
            # (range_pack over a >57-bit range).  Re-expand for this data; a
            # failure of a fresh resolution is a genuine error, and anything
            # but a codec's refusal (a kernel's error) is never retried.
            if not was_hit or self.plan.is_resolved:
                raise
            if trace is not None:
                trace.clear()  # the failed attempt's steps are not part of it
            fresh, _ = _resolve_impl(self.plan, streams, self.ctx, use_cache=False)
            return self._execute(fresh, streams, trace)

    def compress_traced(
        self, inputs: Union[Stream, bytes, Sequence[Stream]]
    ) -> Tuple[bytes, List[Tuple[str, int]], float]:
        """One unchunked frame, instrumented -> ``(frame, trace, seconds)``.

        ``trace`` is the executed ``(codec_name, input_bytes)`` list and
        ``seconds`` the wall-clock resolve + execute time
        (``time.perf_counter``; the frame is on the host when it returns, so
        the card's work is inside it).  The frame is byte-identical to
        ``compress(..., chunk_bytes=0)``.
        """
        streams = self._streams(inputs)
        trace: List[Tuple[str, int]] = []
        t0 = time.perf_counter()
        frame = self._compress_single(streams, trace)
        dt = time.perf_counter() - t0
        self._bump(calls=1, bytes_in=sum(s.nbytes for s in streams), bytes_out=len(frame))
        return frame, trace, dt

    # ----------------------------------------------------------- streaming
    def compress_chunks(
        self, chunks: Iterable[Stream], out: BinaryIO, *, n_chunks: Optional[int] = None
    ) -> int:
        """Pipelined core: parallel encode, in-order incremental container
        write -> bytes written.  With ``n_chunks`` known the output is
        byte-identical to ``write_container`` over the same frames; without
        it, ``out`` must be seekable and readable (the count is backpatched,
        :class:`wire.ContainerWriter`).  At most :attr:`window` chunks (and
        their frames) are held at once, so ``chunks`` may be a lazy iterator.
        """
        if self.ctx.format_version < CONTAINER_MIN_VERSION:
            raise ValueError(
                f"chunked compression requires format version"
                f" >= {CONTAINER_MIN_VERSION} (at {self.ctx.format_version})"
            )
        it = (ch.validate().to(self.device) for ch in chunks)
        try:
            first = next(it)
        except StopIteration:
            raise ValueError("compress_chunks needs at least one chunk") from None
        # resolve once on the first chunk; a chunk whose codec refuses that
        # resolution gets a fresh one, as the one-shot chunked path does
        resolved = resolve(self.plan, [first], self.ctx, use_cache=self.use_resolve_cache)

        def _one(ch: Stream) -> bytes:
            try:
                return self._execute(resolved, [ch])
            except ValueError:
                _count_fresh_resolve()
                fresh = resolve(self.plan, [ch], self.ctx, use_cache=False)
                return self._execute(fresh, [ch])

        writer = wire.ContainerWriter(out, self.ctx.format_version, n_chunks)
        for frame in self._window_map(_one, it, head=[first]):
            writer.write_chunk(frame)
            self._bump(chunks=1)
        return writer.close()

    def compress_to(
        self, inputs: Union[Stream, bytes, Sequence[Stream]], out: BinaryIO
    ) -> int:
        """Compress straight into a binary sink (single frame or container).

        Mirrors :meth:`compress` — same bytes, same errors — but a
        multi-chunk input streams through :meth:`compress_chunks`.
        """
        cb = self.chunk_bytes
        streams = self._streams(inputs)
        if cb:
            _check_chunkable(streams, self.ctx)
        chunks = _split_chunks(streams[0], cb) if cb else []
        if len(chunks) > 1:
            self._bump(calls=1, bytes_in=streams[0].nbytes)
            n = self.compress_chunks(chunks, out, n_chunks=len(chunks))
            self._bump(bytes_out=n)
            return n
        frame = self.compress(streams, chunk_bytes=0)
        out.write(frame)
        return len(frame)

    # ---------------------------------------------------------- inspection
    def resolved(self, inputs) -> ResolvedPlan:
        """Phase-1 artifact for these inputs (cached like compress())."""
        if not _all_metas(inputs):
            inputs = self._streams(inputs)
        return resolve(self.plan, inputs, self.ctx, use_cache=self.use_resolve_cache)


class DecompressorSession(_SessionBase):
    """The universal decoder as a long-lived session.

    Plan-free (frames are self-describing); what persists is the decode-side
    coder-table scratch, the device the streams are decoded onto, and the
    thread pool that fans container chunks out (``table_cache_size`` as in
    :class:`CompressorSession`).  :meth:`decompress` matches the
    module-level function; :meth:`iter_frames` and
    :meth:`decompress_from` add the bounded-memory streaming path over
    ``wire.iter_container_frames``.
    """

    def __init__(
        self,
        *,
        device: DeviceLike = "cuda",
        n_workers: Optional[int] = None,
        window: Optional[int] = None,
        table_cache_size: Optional[int] = None,
        scratch: Optional[ExecScratch] = None,
        prefetch: bool = True,
    ):
        super().__init__(
            device, n_workers, window, table_cache_size, "ozl-dec", scratch, prefetch
        )

    def _one(self, frame) -> List[Stream]:
        with self.scratch.activate():
            return _decompress_single(frame, self.device)

    def decompress(self, frame: bytes) -> List[Stream]:
        """Frame or container -> regenerated input streams on the device."""
        self._bump(calls=1, bytes_in=len(frame))
        if wire.is_container(frame):
            version, sub_frames = wire.read_container(frame)
            check_decode_version(version)
            if not sub_frames:
                raise wire.FrameError("empty container")
            if len(sub_frames) > 1:
                parts = list(self._window_map(self._one, sub_frames))
            else:
                parts = [self._one(sub_frames[0])]
            if any(len(p) != 1 for p in parts):
                raise wire.FrameError("container chunks must be single-input frames")
            self._bump(chunks=len(parts))
            out = [_concat_decoded([p[0] for p in parts])]
        else:
            out = self._one(frame)
            self._bump(chunks=1)
        self._bump(bytes_out=sum(s.nbytes for s in out))
        return out

    # ----------------------------------------------------------- streaming
    def iter_frames(self, reader: BinaryIO) -> Iterator[Stream]:
        """Yield each container chunk's regenerated stream, in order, decoding
        up to :attr:`window` chunks concurrently with bounded memory.  A bare
        (non-container) frame yields its streams.

        Chunk type consistency is enforced across the container; the trailing
        container CRC is verified by the frame iterator before the final
        chunk is processed, and every chunk frame's own CRC as it is decoded
        (fail closed, no silent partial output).
        """
        head = reader.read(4)
        rest = _Prefixed(head, reader)
        if head != wire.CONTAINER_MAGIC:
            yield from self.decompress(rest.read())
            return
        # keep only (stype, width) of the first chunk, not its data
        ref_meta: Optional[Tuple[SType, int]] = None
        for part in self._window_map(self._one, wire.iter_container_frames(rest)):
            if len(part) != 1:
                raise wire.FrameError("container chunks must be single-input frames")
            (s,) = part
            if ref_meta is None:
                ref_meta = (s.stype, s.width)
            elif (s.stype, s.width) != ref_meta:
                raise wire.FrameError("container chunks disagree on stream type")
            self._bump(chunks=1)
            yield s

    def decompress_from(self, reader: BinaryIO) -> List[Stream]:
        """Streaming read + decode, then one join on the device.

        A bare (non-container) frame decodes as-is: its streams are distinct
        graph inputs, never concatenated."""
        head = reader.read(4)
        rest = _Prefixed(head, reader)
        if head != wire.CONTAINER_MAGIC:
            return self.decompress(rest.read())
        parts = list(self.iter_frames(rest))
        if not parts:
            raise wire.FrameError("empty container")
        self._bump(calls=1)
        return [_concat_decoded(parts)]

    # -------------------------------------------------------------- salvage
    def decompress_salvage(
        self, src: Union[bytes, BinaryIO]
    ) -> Tuple[List[Stream], "wire.SalvageReport"]:
        """Best-effort decode of a damaged frame or container (recovery path).

        Returns ``(streams, report)``: one regenerated stream per recovered
        container chunk, in chunk order, on the session's device, and the
        :class:`~repro_torch.core.wire.SalvageReport` naming the chunk
        indices that survived and the ranges that were lost.  A record's
        damage never raises: an unrecoverable one returns no streams and a
        report that says why.  The whole record is held in memory.

        Damage is a ``ValueError`` (a ``FrameError``, or a codec refusing a
        CRC-valid chunk's contents).  Any other exception (a kernel's
        ``KernelError``, ``NoCardError``, a CUDA fault) propagates: it says
        nothing about the data.  The reference counts every exception as
        damage.
        """
        data = bytes(src if isinstance(src, (bytes, bytearray, memoryview)) else src.read())
        self._bump(calls=1, bytes_in=len(data))
        if not wire.is_container(data):
            # a bare frame has no chunk redundancy: decode or report, per its
            # own CRC; there is nothing to resynchronize on
            report = wire.SalvageReport(n_chunks=1)
            try:
                out = self._one(data)
            except ValueError as err:
                report.damaged.append((0, 0))
                report.trailer_ok = False
                report.notes.append(f"bare frame unrecoverable: {err}")
                return [], report
            report.recovered.append(0)
            report.trailer_ok = True
            self._bump(chunks=1, bytes_out=sum(s.nbytes for s in out))
            return out, report
        frames, report = wire.salvage_container(data)

        def _try(frame: bytes) -> Optional[List[Stream]]:
            try:
                return self._one(frame)
            except ValueError:
                return None

        parts = list(self._window_map(_try, frames)) if frames else []
        # when every recovered chunk has an exact index, frames and
        # report.recovered align (both in chunk order): a CRC-valid chunk
        # that still fails to decode moves from recovered to damaged
        aligned = report.recovered_unplaced == 0 and len(parts) == len(report.recovered)
        out: List[Stream] = []
        failed_idx: List[int] = []
        failed = 0
        for j, part in enumerate(parts):
            if part is None or len(part) != 1:
                failed += 1
                if aligned:
                    failed_idx.append(report.recovered[j])
                continue
            out.append(part[0])
        if failed:
            for i in failed_idx:
                report.recovered.remove(i)
                report.damaged.append((i, i))
            report.damaged.sort(key=lambda r: r[0])
            report.notes.append(f"{failed} recovered chunk(s) failed to decode")
        self._bump(chunks=len(out), bytes_out=sum(s.nbytes for s in out))
        return out, report


class SessionPool:
    """Thread-safe checkout pool of sessions keyed by plan digest.

    One entry per registered plan: a factory plus a bounded set of lazily
    created :class:`CompressorSession` objects.  ``acquire(key)`` is a
    context manager that checks a session out for one request and returns
    it on exit; when every session of a key is in use the caller blocks
    until one frees (backpressure).  A session whose request raised is
    closed and dropped rather than returned, so a poisoned member never
    serves a later request; the next acquire builds a fresh one.
    """

    def __init__(self, max_per_key: int = 4):
        if max_per_key < 1:
            raise ValueError("max_per_key must be >= 1")
        self.max_per_key = max_per_key
        self._lock = threading.Condition()
        self._factories: Dict[str, Callable[[], CompressorSession]] = {}
        self._idle: Dict[str, List[CompressorSession]] = {}
        self._created: Dict[str, int] = {}
        self._counters: Dict[str, Dict[str, int]] = {}

    def register(self, key: str, factory: Callable[[], CompressorSession]) -> None:
        """Associate ``key`` (a plan digest or id) with a session factory."""
        with self._lock:
            self._factories[key] = factory
            self._idle.setdefault(key, [])
            self._created.setdefault(key, 0)
            self._counters.setdefault(
                key, {"acquires": 0, "creates": 0, "waits": 0, "drops": 0}
            )

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._factories)

    def acquire(self, key: str, timeout: Optional[float] = None):
        """Context manager: check a session for ``key`` out of the pool."""
        return _PoolLease(self, key, timeout)

    def _checkout(self, key: str, timeout: Optional[float]) -> CompressorSession:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if key not in self._factories:
                raise KeyError(f"no session factory registered for {key!r}")
            self._counters[key]["acquires"] += 1
            while True:
                if key not in self._factories:  # close()d while we waited
                    raise KeyError(f"session pool closed while waiting for {key!r}")
                if self._idle[key]:
                    return self._idle[key].pop()
                if self._created[key] < self.max_per_key:
                    self._created[key] += 1
                    self._counters[key]["creates"] += 1
                    factory = self._factories[key]
                    break  # create outside the lock: factories may be slow
                self._counters[key]["waits"] += 1
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"no free session for {key!r} after {timeout:.1f}s")
                self._lock.wait(remaining)
        try:
            return factory()
        except BaseException:
            with self._lock:
                if key in self._created:  # close() may have raced us
                    self._created[key] -= 1
                # one Condition spans every key: wake them all
                self._lock.notify_all()
            raise

    def _checkin(self, key: str, session: CompressorSession, ok: bool) -> None:
        with self._lock:
            alive = key in self._factories  # close() may have dropped the key
            if ok and alive:
                self._idle[key].append(session)
                drop = None
            else:
                if alive:
                    self._created[key] = max(0, self._created[key] - 1)
                    self._counters[key]["drops"] += 1
                drop = session
            self._lock.notify_all()
        if drop is not None:
            drop.close()

    def stats(self) -> Dict[str, dict]:
        """Per-key counters: created/idle/in_use plus acquire telemetry."""
        with self._lock:
            return {
                key: {
                    "created": self._created[key],
                    "idle": len(self._idle[key]),
                    "in_use": self._created[key] - len(self._idle[key]),
                    **self._counters[key],
                }
                for key in self._factories
            }

    def total_in_use(self) -> int:
        """Checked-out sessions across every key (0 == nothing leaked)."""
        with self._lock:
            return sum(self._created[k] - len(self._idle[k]) for k in self._factories)

    def close(self) -> None:
        """Shut down every idle session and forget all factories.  Sessions
        checked out now are closed by their lease on return."""
        with self._lock:
            idle, self._idle = self._idle, {}
            self._factories.clear()
            self._created.clear()
            self._lock.notify_all()
        for sessions in idle.values():
            for s in sessions:
                s.close()

    def __enter__(self) -> "SessionPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


class _PoolLease:
    """The checkout token ``SessionPool.acquire`` hands to a ``with`` block."""

    def __init__(self, pool: SessionPool, key: str, timeout: Optional[float]):
        self._pool = pool
        self._key = key
        self._timeout = timeout
        self._session: Optional[CompressorSession] = None

    def __enter__(self) -> CompressorSession:
        self._session = self._pool._checkout(self._key, self._timeout)
        return self._session

    def __exit__(self, exc_type, exc, tb) -> None:
        session, self._session = self._session, None
        if session is not None:
            self._pool._checkin(self._key, session, ok=exc_type is None)


class _Prefixed:
    """A tiny reader that replays already-consumed prefix bytes."""

    def __init__(self, prefix: bytes, reader: BinaryIO):
        self._prefix = prefix
        self._reader = reader

    def read(self, n: int = -1) -> bytes:
        if not self._prefix:
            return self._reader.read(n)
        if n is None or n < 0:
            out, self._prefix = self._prefix + self._reader.read(), b""
            return out
        take, self._prefix = self._prefix[:n], self._prefix[n:]
        if len(take) < n:
            take += self._reader.read(n - len(take))
        return take


# ------------------------------------------------------------------ frontend
def compress(
    plan: Plan,
    inputs: Union[Stream, bytes, Sequence[Stream]],
    ctx: Optional[CompressionCtx] = None,
    device: DeviceLike = "cuda",
    *,
    chunk_bytes: Optional[int] = None,
    n_workers: Optional[int] = None,
    use_resolve_cache: bool = True,
) -> bytes:
    """Compress ``inputs`` with ``plan`` into a self-describing frame.

    A thin wrapper over a throwaway :class:`CompressorSession`.  The streams
    are moved to ``device`` (the card unless the caller names the CPU) and
    every codec runs there.  Without a card, the default raises.

    ``chunk_bytes=N`` splits the (single) input into chunks of about N bytes,
    compressed independently on ``n_workers`` threads into a multi-chunk
    container frame (format v4+); a split into one chunk writes a plain
    frame.  ``chunk_bytes=0`` or ``None`` disables chunking.
    ``use_resolve_cache=False`` forces a fresh selector expansion.
    """
    with CompressorSession(
        plan,
        ctx=ctx,
        device=device,
        chunk_bytes=chunk_bytes,
        n_workers=n_workers,
        use_resolve_cache=use_resolve_cache,
    ) as session:
        return session.compress(inputs)


def decompress(
    frame: bytes, device: DeviceLike = "cuda", *, n_workers: Optional[int] = None
) -> List[Stream]:
    """The universal decoder: frame or container -> regenerated inputs on
    ``device``.

    The card unless the caller names the CPU; without a card, the default
    raises.  A container's chunks decode concurrently onto the device and
    join there into one stream.  A thin wrapper over a throwaway
    :class:`DecompressorSession`.
    """
    with DecompressorSession(device=device, n_workers=n_workers) as session:
        return session.decompress(frame)


def _decompress_single(frame, dev: torch.device) -> List[Stream]:
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


class Compressor:
    """A deployable compressor: a plan, its format version and level, the
    device it runs on and its chunking (the public facade).

    ``serialize()`` writes the ``.ozp`` plan file, byte for byte the
    reference's; ``Compressor.deserialize(blob)`` reads one back with its
    ``format_version`` and ``level``.  ``device`` (the card unless the caller
    names the CPU) takes the place of the reference's ``backend``.
    """

    def __init__(
        self,
        plan: Plan,
        *,
        format_version: int = CURRENT_FORMAT_VERSION,
        level: int = 5,
        name: str = "",
        device: DeviceLike = "cuda",
        chunk_bytes: Optional[int] = None,
    ):
        self.plan = plan.validate()
        self.format_version = check_compress_version(format_version)
        self.level = level
        self.name = name or plan.name
        self.device = device
        self.chunk_bytes = chunk_bytes

    def _ctx(self) -> CompressionCtx:
        return CompressionCtx(self.format_version, self.level)

    def compress(
        self,
        inputs,
        *,
        device: DeviceLike = None,
        chunk_bytes: Optional[int] = None,
    ) -> bytes:
        """``device`` and ``chunk_bytes`` override the instance's; pass
        ``chunk_bytes=0`` to force an unchunked frame from a chunking
        compressor."""
        return compress(
            self.plan,
            inputs,
            self._ctx(),
            self.device if device is None else device,
            chunk_bytes=self.chunk_bytes if chunk_bytes is None else chunk_bytes,
        )

    def resolve(self, inputs) -> ResolvedPlan:
        """Phase 1 for inspection or warm-up (cached like ``compress``); the
        inputs are moved to the compressor's device first."""
        if not _all_metas(inputs):
            device = _device.resolve_device(self.device)
            inputs = [s.validate().to(device) for s in _as_streams(inputs)]
        return resolve(self.plan, inputs, self._ctx())

    def session(self, **overrides) -> CompressorSession:
        """A long-lived session with this compressor's settings; keyword
        overrides (``device=``, ``chunk_bytes=``, ``n_workers=``,
        ``window=``, ...) pass through to :class:`CompressorSession`."""
        kw = dict(ctx=self._ctx(), device=self.device, chunk_bytes=self.chunk_bytes)
        kw.update(overrides)
        return CompressorSession(self.plan, **kw)

    @staticmethod
    def decompress(frame: bytes, device: DeviceLike = "cuda") -> List[Stream]:
        return decompress(frame, device)

    def roundtrip_check(self, inputs) -> bool:
        """Encode and decode on the compressor's device; True when every
        stream comes back with its type, width, bytes and string lengths."""
        inputs = _as_streams(inputs)
        outs = decompress(self.compress(inputs), self.device)
        if len(outs) != len(inputs):
            return False
        for a, b in zip(inputs, outs):
            if a.stype != b.stype or a.width != b.width:
                return False
            if a.content_bytes() != b.content_bytes():
                return False
            if a.stype == SType.STRING and not np.array_equal(a.lengths, b.lengths):
                return False
        return True

    def serialize(self) -> bytes:
        from .serialize import serialize_plan

        return serialize_plan(
            self.plan, name=self.name, format_version=self.format_version, level=self.level
        )

    @staticmethod
    def deserialize(blob: bytes, *, device: DeviceLike = "cuda") -> "Compressor":
        from .serialize import deserialize_plan

        plan, meta = deserialize_plan(blob)
        return Compressor(
            plan,
            name=meta.get("name", ""),
            format_version=meta.get("format_version", CURRENT_FORMAT_VERSION),
            level=meta.get("level", 5),
            device=device,
        )
