"""Standard selectors — the port's copy of ``repro.codecs.selectors``.

The trial selector compresses a bounded sample of the stream with each
candidate graph of its menu and commits to the smallest.  The menus and
levels are the reference's, so both packages pick the same graph and write
the same frame.  Trials run on the sample's device, through the same
kernels as the real compression, and resolve each candidate through the
resolve cache, as the reference's trials do.

Only a codec's own refusal (a ``ValueError``) marks a candidate as
inapplicable; any other error — a CUDA fault, a failed kernel build, a
kernel wrapper's precondition (``ops.KernelError``) — propagates.  Trials
run under ``core.codec.trial``, where a codec refuses what the reference's
raises on.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core.engine import CompressionCtx, compress
from ..core.graph import GraphBuilder, Plan, pipeline
from ..core.message import Stream, SType
from ..core.codec import ANY_STYPES, FIXED_STYPES, InPort, trial
from ..core.selector import SelectorSig, SelectorSpec, register_selector

SAMPLE_BYTES = 1 << 16  # trial compressions run on a bounded prefix


def _sample(s: Stream) -> Stream:
    if s.stype == SType.STRING:
        if s.data.numel() <= SAMPLE_BYTES:
            return s
        # whole strings up to the first that reaches SAMPLE_BYTES (host lengths)
        keep = int(np.searchsorted(np.cumsum(s.lengths), SAMPLE_BYTES)) + 1
        keep = min(keep, int(s.lengths.size))
        nb = int(s.lengths[:keep].sum())
        return Stream(s.data[:nb], SType.STRING, 1, s.lengths[:keep])
    n_elts = min(s.n_elts, max(SAMPLE_BYTES // max(s.width, 1), 1))
    if s.stype == SType.NUMERIC:
        return Stream(s.data[:n_elts], s.stype, s.width)
    return Stream(s.data[: n_elts * (s.width if s.stype == SType.STRUCT else 1)], s.stype, s.width)


def _trial_size(plan: Plan, s: Stream, ctx: CompressionCtx) -> int:
    try:
        trial_ctx = CompressionCtx(ctx.format_version, ctx.level)
        with trial():
            return len(compress(plan, [s], ctx=trial_ctx, device=s.device))
    except ValueError:
        return 1 << 62  # candidate inapplicable to this data


def choose_best(candidates: Sequence[Tuple[str, Plan]], streams, ctx) -> Plan:
    sample = _sample(streams[0])
    best_plan, best_sz = None, 1 << 63
    for _name, plan in candidates:
        sz = _trial_size(plan, sample, ctx)
        if sz < best_sz:
            best_plan, best_sz = plan, sz
    if best_plan is None:
        return pipeline("store")
    return best_plan


# ---------------------------------------------------------------- candidates
def entropy_candidates(level: int) -> List[Tuple[str, Plan]]:
    cands = [("store", pipeline("store")), ("huffman", pipeline("huffman"))]
    if level >= 3:
        cands.append(("fse", pipeline("fse")))
    if level >= 5:
        cands.append(("zlib", pipeline(("zlib_backend", {"level": min(level, 9)}))))
    if level >= 7:
        cands.append(("lzma", pipeline(("lzma_backend", {"preset": 6}))))
    return cands


def numeric_candidates(level: int) -> List[Tuple[str, Plan]]:
    cands: List[Tuple[str, Plan]] = [
        ("store", pipeline("store")),
        ("range_pack", pipeline("range_pack")),
        ("delta+range_pack", pipeline("delta", "range_pack")),
        ("transpose+huffman", pipeline("transpose", "huffman")),
        ("delta+transpose+huffman", pipeline("delta", "transpose", "huffman")),
    ]
    if level >= 3:
        g = GraphBuilder(1)
        alpha, idx = g.add("tokenize", g.input(0))
        g.add("transpose", alpha)
        g.add("range_pack", idx)
        cands.append(("tokenize", g.build("tokenize_backend")))
        cands.append(("delta+zigzag+range_pack", pipeline("delta", "zigzag", "range_pack")))
    if level >= 5:
        zl = ("zlib_backend", {"level": min(level, 9)})
        cands.append(("transpose+zlib", pipeline("transpose", zl)))
        cands.append(("delta+transpose+zlib", pipeline("delta", "transpose", zl)))
    return cands


def bytes_candidates(level: int) -> List[Tuple[str, Plan]]:
    cands = entropy_candidates(level)
    if level >= 4:
        g = GraphBuilder(1)
        lit, runs, mls, offs = g.add("lz77", g.input(0))
        g.add("huffman", lit)
        g.add("range_pack", runs)
        g.add("range_pack", mls)
        g.add("range_pack", offs)
        cands.append(("lz77+entropy", g.build("lz_backend")))
    return cands


# ------------------------------------------------------------ the selectors
def _entropy_auto(streams, params, ctx):
    return choose_best(entropy_candidates(ctx.level), streams, ctx)


def _numeric_auto(streams, params, ctx):
    return choose_best(numeric_candidates(ctx.level), streams, ctx)


def _bytes_auto(streams, params, ctx):
    return choose_best(bytes_candidates(ctx.level), streams, ctx)


def _generic_auto(streams, params, ctx):
    """Dispatch on stream type — the "just compress it" entry point."""
    s = streams[0]
    if s.stype == SType.NUMERIC:
        return _numeric_auto(streams, params, ctx)
    if s.stype == SType.STRING:
        g = GraphBuilder(1)
        content, lens = g.add("string_split", g.input(0))
        g.select("bytes_auto", content)
        g.select("numeric_auto", lens)
        return g.build("string_backend")
    if s.stype == SType.STRUCT and s.width > 1:
        if s.width in (2, 4, 8):
            # numeric reinterpretation usually dominates; let the numeric
            # menu (which includes transpose chains) pick the backend
            g = GraphBuilder(1)
            num = g.add("interpret_numeric", g.input(0), width=s.width)
            g.select("numeric_auto", num)
            return g.build("struct_numeric")
        return choose_best(
            [
                ("transpose+huffman", pipeline("transpose", "huffman")),
                ("transpose+fse", pipeline("transpose", "fse")),
                ("huffman", pipeline("transpose", "huffman")),
            ],
            streams,
            ctx,
        )
    return _bytes_auto(streams, params, ctx)


# declared input types (a mismatch is a lint warning: every trial menu
# degrades to store)
_ANY_SIG = SelectorSig(inputs=(InPort(ANY_STYPES),))
_BYTES_SIG = SelectorSig(inputs=(InPort(FIXED_STYPES),))
_NUM_SIG = SelectorSig(inputs=(InPort(frozenset((int(SType.NUMERIC),))),))

register_selector(SelectorSpec(
    "entropy_auto", _entropy_auto, doc="store/huffman/fse/zlib by trial", sig=_BYTES_SIG))
register_selector(SelectorSpec(
    "numeric_auto", _numeric_auto, doc="numeric backend by trial", sig=_NUM_SIG))
register_selector(SelectorSpec(
    "bytes_auto", _bytes_auto, doc="entropy menu + lz77 graph by trial", sig=_BYTES_SIG))
register_selector(SelectorSpec(
    "generic_auto", _generic_auto, doc="type-dispatching default backend", sig=_ANY_SIG))
