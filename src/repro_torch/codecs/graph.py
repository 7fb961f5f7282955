"""Graph-structured data codecs — the ``graph:`` profile family's node set.

The port's copy of ``repro.codecs.graph``: the same codec ids, params,
headers and output streams, and the same selector.

``edge_list``      — text edge lists (SNAP style: ``u<sep>v`` lines, ``#``
                     comments) -> (src, dst, bitmap, exception-lines).  Any
                     line that is not two canonical decimal i64s stays a
                     byte-exact exception string, so every input round-trips.
``edge_list_bin``  — interleaved fixed-width (u, v) pairs -> (src, dst).
``adj_gap``        — (src, dst) edge columns -> (nodes, degrees, refs,
                     copy-bits, gaps): per-node adjacency lists, gap-coded
                     (first neighbour against the source node, then
                     neighbour to neighbour, zigzagged), and optionally coded
                     as a diff against a similar earlier list (Zuckerli's
                     reference/copy trick) where a byte-cost model says so.
``adjacency_auto`` — the selector that picks reference coding, plain gap
                     coding or raw columns by trial compression of a sample.

Every codec is a tensor program on the device its streams lie on, with no
Python loop whose trip count grows with lines, edges or runs.  Loops run
over the ``auto`` separator candidates, the reference window's offsets and
the decoder's dependency levels.

Node ids are u64 bit patterns in int64 tensors, and ``torch`` has no usable
uint64, so three traps are handled where they occur: an unsigned compare or
sort flips the sign bit first (``_SIGN``), a logical right shift masks after
the arithmetic one, and subtraction and prefix sums wrap on int64 exactly
as they do on uint64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.codec import CodecSig, CodecSpec, InPort, ParamSpec, register_codec, trial
from ..core.engine import CompressionCtx, compress
from ..core.graph import GraphBuilder, Plan
from ..core.message import CARRIER, Stream, SType, narrow_unsigned, widen_unsigned
from ..core.selector import SelectorSig, SelectorSpec, register_selector
from ._util import HeaderReader, HeaderWriter, expect_stream, numeric_stream
from .convert import _aligned
from .parse import (
    _NL,
    _WIDTH,
    _canonical_ints,
    _format_ints,
    _gather,
    _lengths_of,
    _lengths_to,
    _pack_bits,
    _separators,
    _unpack_bits,
)

EDGE_SEPS = (b"\t", b" ", b",", b";")  # auto-sniff candidates, most-SNAP first

_SIGN = -(1 << 63)  # x ^ _SIGN orders u64 bit patterns as signed int64 compares them
_LOW63 = (1 << 63) - 1
# the unsigned thresholds 2^7, 2^14, ..., 2^63 with the sign bit flipped: a
# value's varint length is one more than the number of them it reaches
_VARINT_STEPS = tuple(((1 << (7 * k)) ^ (1 << 63)) - (1 << 64 if k < 9 else 0)
                      for k in range(1, 10))


# ------------------------------------------------------------------ helpers
def _zigzag_u64(d: torch.Tensor) -> torch.Tensor:
    """Zigzag the wrapped u64 difference: ``>> 63`` is arithmetic on int64,
    which is the all-ones mask the reference builds from the signed view."""
    return (d << 1) ^ (d >> 63)


def _unzigzag_u64(zz: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_zigzag_u64`.  ``>>`` on int64 is arithmetic, so the
    logical shift of the u64 masks the copied sign bit off."""
    return ((zz >> 1) & _LOW63) ^ -(zz & 1)


def _varint_lens(zz: torch.Tensor) -> torch.Tensor:
    """Byte cost of each u64 under 7-bit varint coding (the cost model), in
    one pass: 1 + the number of thresholds 2^(7k) the value reaches."""
    steps = torch.tensor(_VARINT_STEPS, dtype=torch.int64, device=zz.device)
    return 1 + torch.bucketize(zz ^ _SIGN, steps, right=True)


def _u64_gt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a > b`` in unsigned order, on u64 bit patterns."""
    return (a ^ _SIGN) > (b ^ _SIGN)


def _segments(lens: torch.Tensor, total: int):
    """For ``total == lens.sum()`` elements laid out segment after segment:
    each element's segment and its index inside it."""
    dev = lens.device
    seg = torch.repeat_interleave(torch.arange(lens.numel(), device=dev), lens,
                                  output_size=total)
    first = torch.cumsum(lens, 0) - lens
    return seg, torch.arange(total, device=dev) - first[seg]


def _seg_sum(vals: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The sum of ``vals[s : s + n]`` for each segment, from one prefix sum."""
    c = torch.cat([vals.new_zeros(1), torch.cumsum(vals, 0)])
    return c[starts + lens] - c[starts]


# ----------------------------------------------------------------- edge_list
def _parse_edges(body, starts, ends, nl, sep_b: bytes):
    """Which lines are edges under ``sep_b`` (``line.split(sep)`` gives
    exactly two parts, both canonical int64s), and their two values.  Lines
    are split on ``\\n`` alone, so a ``\\r`` stays in its line's last part."""
    n_lines = starts.numel()
    seps = _separators(body, sep_b)  # Python's left-to-right matches
    line = torch.searchsorted(nl, seps)
    per_line = torch.bincount(line, minlength=n_lines)
    at = torch.zeros(n_lines, dtype=torch.int64, device=body.device)
    at = at.scatter_reduce(0, line, seps, reduce="amin", include_self=False)
    one = per_line == 1
    at = torch.where(one, at, starts)  # any in-line position for the rest
    ok_u, u = _canonical_ints(body, starts, at - starts)
    v_start = torch.minimum(at + len(sep_b), ends)
    ok_v, v = _canonical_ints(body, v_start, ends - v_start)
    return one & ok_u & ok_v, u, v


def _edge_list_enc(streams, params):
    s = streams[0]
    if s.stype != SType.SERIAL:
        raise ValueError("edge_list wants serial bytes")
    sep = params.get("sep", "auto")
    data = s.data
    trailing_nl = bool(data.numel()) and int(data[-1]) == _NL  # one scalar sync
    body = data[:-1] if trailing_nl else data
    dev = body.device
    if sep == "auto":
        cands = EDGE_SEPS
    else:
        sep_b = sep.encode() if isinstance(sep, str) else bytes(sep)
        if not sep_b:
            raise ValueError("edge_list: separator must be non-empty")
        if b"\n" in sep_b:
            raise ValueError("edge_list: separator cannot contain newlines")
        cands = (sep_b,)
    if body.numel():  # body.split(b"\n") if body else []
        nl = torch.nonzero(body == _NL).reshape(-1)
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), nl + 1])
        ends = torch.cat([nl, torch.full((1,), body.numel(), dtype=torch.int64, device=dev)])
    else:
        nl = starts = ends = torch.zeros(0, dtype=torch.int64, device=dev)
    sep_b, parsed, best = cands[0], None, -1
    for cand in cands:  # the first separator that parses the most edges
        got = _parse_edges(body, starts, ends, nl, cand)
        n_edges = int(got[0].sum())  # one scalar sync a candidate
        if n_edges > best:
            sep_b, parsed, best = cand, got, n_edges
    is_edge, u, v = parsed
    exc = ~is_edge
    exc_start = starts[exc]
    exc_lens = ends[exc] - exc_start
    exc_lens_h = _lengths_of(exc_lens)  # one card-to-host copy
    exceptions = _gather(body, exc_start, exc_lens, int(exc_lens_h.sum(dtype=np.int64)))
    h = (
        HeaderWriter()
        .varint(starts.numel())
        .u8(1 if trailing_nl else 0)
        .bytes_(sep_b)
        .done()
    )
    return [
        numeric_stream(u[is_edge]),
        numeric_stream(v[is_edge]),
        Stream(_pack_bits(is_edge), SType.SERIAL, 1),
        Stream(exceptions, SType.STRING, 1, exc_lens_h),
    ], h


def _edge_list_dec(outs, header):
    src_s, dst_s, bitmap_s, exc_s = outs
    r = HeaderReader(header)
    n_lines = r.varint()
    trailing_nl = r.u8()
    sep_b = r.bytes_()
    r.expect_end()
    expect_stream(src_s, SType.NUMERIC, 8, "edge_list", "source")
    expect_stream(dst_s, SType.NUMERIC, 8, "edge_list", "destination")
    expect_stream(bitmap_s, SType.SERIAL, 1, "edge_list", "bitmap")
    expect_stream(exc_s, SType.STRING, 1, "edge_list", "exception")
    bitmap = bitmap_s.raw()
    if bitmap.numel() * 8 < n_lines:
        raise ValueError("edge_list: corrupt bitmap/columns")
    dev = bitmap.device
    is_edge = _unpack_bits(bitmap, n_lines)
    src, dst = src_s.data, dst_s.data  # u64 ids in their int64 carriers
    n_edges = int(is_edge.sum())  # one scalar sync
    if n_edges != src.numel() or src.numel() != dst.numel():
        raise ValueError("edge_list: corrupt bitmap/columns")
    if n_lines - n_edges != exc_s.lengths.size:
        raise ValueError("edge_list: the bitmap does not match the exception lines")
    tail = torch.tensor(list(sep_b + b"\n"), dtype=torch.uint8, device=dev)
    if n_lines == 0:  # b"\n".join([]), then the trailing newline
        return [Stream(tail[len(sep_b):][: 1 if trailing_nl else 0].clone(), SType.SERIAL, 1)]
    text_u, len_u = _format_ints(src)
    text_v, len_v = _format_ints(dst)
    exc_lens = _lengths_to(exc_s.lengths, dev)  # one host-to-card copy
    exc_off = torch.cumsum(exc_lens, 0) - exc_lens
    v_base, exc_base = n_edges * _WIDTH, 2 * n_edges * _WIDTH
    sep_at = exc_base + exc_s.data.numel()
    # each line as four pieces of one source: u or the exception line, the
    # separator, v, the newline; the zero beside each lookup keeps it in
    # range past the last of its kind
    flags = is_edge.to(torch.int64)
    edge_k = torch.cumsum(flags, 0) - flags
    exc_k = torch.arange(n_lines, dtype=torch.int64, device=dev) - edge_k
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    lu, lv = torch.cat([len_u, zero])[edge_k], torch.cat([len_v, zero])[edge_k]
    p_len = torch.empty((n_lines, 4), dtype=torch.int64, device=dev)
    p_src = torch.empty_like(p_len)
    p_len[:, 0] = torch.where(is_edge, lu, torch.cat([exc_lens, zero])[exc_k])
    p_src[:, 0] = torch.where(is_edge, edge_k * _WIDTH + _WIDTH - lu,
                              exc_base + torch.cat([exc_off, zero])[exc_k])
    p_len[:, 1], p_src[:, 1] = flags * len(sep_b), sep_at
    p_len[:, 2], p_src[:, 2] = torch.where(is_edge, lv, 0), v_base + edge_k * _WIDTH + _WIDTH - lv
    p_len[:, 3], p_src[:, 3] = 1, sep_at + len(sep_b)
    if not trailing_nl:
        p_len[n_lines - 1, 3] = 0
    total = int(p_len.sum())  # one scalar sync
    src_bytes = torch.cat([text_u.reshape(-1), text_v.reshape(-1), exc_s.data.to(dev), tail])
    raw = _gather(src_bytes, p_src.reshape(-1), p_len.reshape(-1), total)
    return [Stream(raw, SType.SERIAL, 1)]


register_codec(
    CodecSpec(
        "edge_list",
        codec_id=27,
        encode=_edge_list_enc,
        decode=_edge_list_dec,
        n_outputs=4,
        min_version=4,
        doc="text edge list -> (src, dst, bitmap, exceptions); lossless always",
        sig=CodecSig(
            inputs=(InPort(frozenset((int(SType.SERIAL),))),),
            transfer=lambda atoms, params, n_out: [
                (int(SType.NUMERIC), 8),
                (int(SType.NUMERIC), 8),
                (int(SType.SERIAL), 1),
                (int(SType.STRING), 1),
            ],
            params=(ParamSpec("sep", "str",
                              doc="edge separator; 'auto' probes tab/space/,/;"),),
            expansion=3.0,  # short decimal ids widen to u64 columns
        ),
    )
)


# ------------------------------------------------------------- edge_list_bin
def _edge_list_bin_enc(streams, params):
    s = streams[0]
    if s.stype != SType.SERIAL:
        raise ValueError("edge_list_bin wants serial bytes")
    w = int(params.get("width", 4))
    if w not in (2, 4, 8):
        raise ValueError("edge_list_bin: width must be 2/4/8")
    if s.data.numel() % (2 * w):
        raise ValueError(
            f"edge_list_bin: {s.data.numel()} bytes is not (u, v) pairs of width {w}"
        )
    pairs = _aligned(s.data, w).view(CARRIER[w]).view(-1, 2)
    return [numeric_stream(pairs[:, 0]), numeric_stream(pairs[:, 1])], b""


def _edge_list_bin_dec(outs, header):
    src_s, dst_s = outs
    if src_s.width not in (2, 4, 8):
        raise ValueError("edge_list_bin: corrupt columns")
    expect_stream(src_s, SType.NUMERIC, src_s.width, "edge_list_bin", "source")
    expect_stream(dst_s, SType.NUMERIC, src_s.width, "edge_list_bin", "destination")
    if src_s.n_elts != dst_s.n_elts:
        raise ValueError("edge_list_bin: corrupt columns")
    pairs = torch.stack([src_s.data, dst_s.data], 1)  # the interleaved (u, v) pairs
    return [Stream(pairs.view(torch.uint8).reshape(-1), SType.SERIAL, 1)]


register_codec(
    CodecSpec(
        "edge_list_bin",
        codec_id=29,
        encode=_edge_list_bin_enc,
        decode=_edge_list_bin_dec,
        n_outputs=2,
        min_version=4,
        doc="interleaved fixed-width (u, v) pairs -> (src, dst) columns",
        sig=CodecSig(
            inputs=(InPort(frozenset((int(SType.SERIAL),))),),
            transfer=lambda atoms, params, n_out: (
                None
                if int(params.get("width", 4)) not in (2, 4, 8)
                else [(int(SType.NUMERIC), int(params.get("width", 4)))] * 2
            ),
            params=(ParamSpec("width", "int", choices=(2, 4, 8),
                              doc="bytes per node id (default 4)"),),
        ),
    )
)


# -------------------------------------------------------------------- adj_gap
def _copy_match(S, S_edge, R: int, rank, run_starts, degrees, i, j):
    """Zuckerli's copy list for each pair of runs (i, j), all pairs at once:
    which elements of ``L_j`` lie in ``L_i`` (the copy bits, in pair order,
    then ``L_j``'s order) and the edges of the ``L_i`` they match.

    Both lists are strictly increasing, so each edge of a strictly
    increasing run is the key ``run * R + rank`` (``rank`` its value's rank
    among all distinct values, in unsigned order), and all such keys in edge
    order form one sorted array ``S``.  ``L_j``'s elements, keyed with run
    ``i``, are found in it with one ``searchsorted``."""
    d_j = degrees[j]
    total = int(d_j.sum())  # one scalar sync
    pair, t = _segments(d_j, total)
    q = i[pair] * R + rank[run_starts[j][pair] + t]
    pos = torch.searchsorted(S, q).clamp_max(S.numel() - 1)  # no pairs without S
    found = S[pos] == q
    return found, S_edge[pos[found]]


def _adj_gap_transfer(atoms, params, n_out):
    # both columns must share one concrete width; unknowns stay compatible
    widths = {w for _, w in atoms if w is not None}
    if len(widths) > 1 or int(params.get("window", 0) or 0) < 0:
        return None
    N = int(SType.NUMERIC)
    return [(N, 8), (N, 8), (N, 8), (int(SType.SERIAL), 1), (N, 8)]


def _adj_gap_enc(streams, params):
    s_src, s_dst = streams
    for s in (s_src, s_dst):
        if s.stype != SType.NUMERIC:
            raise ValueError("adj_gap wants numeric (src, dst) streams")
    if s_src.width != s_dst.width or s_src.n_elts != s_dst.n_elts:
        raise ValueError("adj_gap: src/dst width or length mismatch")
    window = int(params.get("window", 0))
    if window < 0:
        raise ValueError("adj_gap: window must be >= 0")
    w = s_src.width
    src, dst = widen_unsigned(s_src.data), widen_unsigned(s_dst.data)
    n, dev = src.numel(), src.device
    new_run = torch.ones(n, dtype=torch.bool, device=dev)
    new_run[1:] = src[1:] != src[:-1]
    run_starts = torch.nonzero(new_run).reshape(-1)
    n_runs = run_starts.numel()
    degrees = torch.diff(run_starts, append=torch.full((1,), n, device=dev))
    nodes = src[run_starts]
    run_of = torch.cumsum(new_run, 0) - 1  # each edge's run

    # plain per-edge gaps: against the previous dst, or the node at a run start
    prev = torch.where(new_run, src, torch.roll(dst, 1))
    plain_zz = _zigzag_u64(dst - prev)

    refs = torch.zeros(n_runs, dtype=torch.int64, device=dev)
    if window == 0 or n_runs == 0:
        gaps, copybits = plain_zz, torch.zeros(0, dtype=torch.uint8, device=dev)
    else:
        # reference coding is only reversible over strictly increasing lists
        inc = new_run.clone()
        inc[1:] |= _u64_gt(dst[1:], dst[:-1])
        run_inc = _seg_sum((~inc).to(torch.int64), run_starts, degrees) == 0
        plain_cost = _seg_sum(_varint_lens(plain_zz), run_starts, degrees)
        eligible = run_inc & (degrees >= 3) & (plain_cost > 4)
        _uniq, rank = torch.unique(dst ^ _SIGN, sorted=True, return_inverse=True)
        R = _uniq.numel()
        S_edge = torch.nonzero(run_inc[run_of]).reshape(-1)
        S = run_of[S_edge] * R + rank[S_edge]
        run_idx = torch.arange(n_runs, device=dev)

        def residual(i, j):
            """Copy bits of each pair (i, j), and the residuals: the edges
            of the runs ``i`` that ``L_j`` does not hold, in edge order,
            with their runs and gap codes."""
            found, matched = _copy_match(S, S_edge, R, rank, run_starts, degrees, i, j)
            in_i = torch.zeros(n_runs, dtype=torch.bool, device=dev)
            in_i[i] = True
            kept = in_i[run_of]
            kept[matched] = False
            res = torch.nonzero(kept).reshape(-1)
            run = run_of[res]
            # gap against the run's previous residual, or its node
            before = torch.cat([res.new_full((1,), -1), res[:-1]])
            has_prev = before >= run_starts[run]
            base = torch.where(has_prev, dst[before.clamp_min(0)], nodes[run])
            return found, res, run, _zigzag_u64(dst[res] - base)

        best_cost, best_r = plain_cost, refs
        for r in range(1, window + 1):  # one vectorised pass per window offset
            j = run_idx - r
            jc = j.clamp_min(0)
            active = (eligible & (j >= 0) & run_inc[jc] & (degrees[jc] <= 4 * degrees))
            i = torch.nonzero(active).reshape(-1)
            _found, _res, run, zz = residual(i, i - r)
            resid = torch.zeros_like(degrees).index_add_(0, run, _varint_lens(zz))
            cost = 1 + (degrees[jc] + 7) // 8 + resid
            # the smallest r of least cost below plain: a later r must beat
            # it strictly.  The reference prunes a candidate whose lower
            # bound 1 + ceil(d_j / 8) + n_res is not below the best cost;
            # cost >= that bound, so the prune never changes the choice.
            better = active & (cost < best_cost)
            best_cost = torch.where(better, cost, best_cost)
            best_r = torch.where(better, r, best_r)
        refs = best_r
        i = torch.nonzero(refs).reshape(-1)
        found, res, _run, zz = residual(i, i - refs[i])
        keep = (refs == 0)[run_of]  # plain runs keep their plain gaps
        keep[res] = True
        gaps = plain_zz.clone()
        gaps[res] = zz
        gaps = gaps[keep]
        copybits = _pack_bits(found)
    h = HeaderWriter().u8(w).done()
    return [
        numeric_stream(nodes),
        numeric_stream(degrees),
        numeric_stream(refs),
        Stream(copybits, SType.SERIAL, 1),
        numeric_stream(gaps),
    ], h


_ADJ_ERRORS = ("adj_gap: reference before first run", "adj_gap: copy-bit stream exhausted",
               "adj_gap: corrupt reference run", "adj_gap: gap stream exhausted")


def _adj_gap_dec(outs, header):
    nodes_s, degs_s, refs_s, bits_s, gaps_s = outs
    r = HeaderReader(header)
    w = r.u8()
    r.expect_end()
    if w not in CARRIER:
        raise ValueError("adj_gap: bad width")
    for s, what in ((nodes_s, "node"), (degs_s, "degree"), (refs_s, "reference"), (gaps_s, "gap")):
        expect_stream(s, SType.NUMERIC, 8, "adj_gap", what)
    expect_stream(bits_s, SType.SERIAL, 1, "adj_gap", "copy-bit")
    # the u64 streams in their int64 carriers
    nodes, degrees, refs, gaps = nodes_s.data, degs_s.data, refs_s.data, gaps_s.data
    bits_raw = bits_s.raw()
    if not (nodes.numel() == degrees.numel() == refs.numel()):
        raise ValueError("adj_gap: corrupt run streams")
    dev = nodes.device
    n_runs, G, NB = nodes.numel(), gaps.numel(), bits_raw.numel() * 8
    bits = _unpack_bits(bits_raw, NB)

    # Every check of the reference's run loop, from prefix sums, before any
    # allocation whose size comes from the run streams.  Runs past the first
    # failing one may hold garbage; only the first failure is read.  u64
    # counts at or above 2^63 are negative here, and fail as too large.
    idx = torch.arange(n_runs, device=dev)
    is_ref = refs != 0
    bad_ref = is_ref & ((refs < 0) | (refs > idx))
    par = torch.where(is_ref & ~bad_ref, idx - refs, idx)
    d_par = torch.where(is_ref & ~bad_ref, degrees[par], 0)
    bpos = torch.cumsum(d_par, 0) - d_par
    no_bits = is_ref & ~bad_ref & ((d_par < 0) | (d_par > NB - bpos))
    c_bits = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.cumsum(bits.to(torch.int64), 0)])
    pop = c_bits[(bpos + d_par).clamp(0, NB)] - c_bits[bpos.clamp(0, NB)]
    n_res = degrees - pop
    g = torch.where(is_ref, n_res, degrees)  # gap values each run takes
    gpos = torch.cumsum(g, 0) - g
    bad_res = is_ref & ~bad_ref & ~no_bits & ((degrees < 0) | (n_res < 0) | (n_res > G - gpos))
    no_gaps = ~is_ref & ((degrees < 0) | (degrees > G - gpos))
    code = torch.where(bad_ref, 1, torch.where(no_bits, 2, torch.where(bad_res, 3,
                       torch.where(no_gaps, 4, 0))))
    code = torch.cat([code, code.new_zeros(1)])  # argmax of none failing: 0
    first = torch.argmax((code > 0).to(torch.int32))  # the first failing run
    summary = torch.stack([code[first], g.sum(), degrees.sum(), d_par.sum(),
                           torch.where(is_ref, degrees, 0).sum()])
    fail, used, total, n_bits, n_ref = summary.tolist()  # one card-to-host copy
    if fail:
        raise ValueError(_ADJ_ERRORS[fail - 1])
    if used != G:
        raise ValueError("adj_gap: trailing gap values")

    # Residual and plain runs: one global unzigzag and prefix sum; a run's
    # values are P[a:b] - P[a-1] + node.  They go after the run's copied
    # slots (none in a plain run).
    prefix = torch.cat([gaps.new_zeros(1), torch.cumsum(_unzigzag_u64(gaps), 0)])
    out_off = torch.cumsum(degrees, 0) - degrees
    dst = torch.empty(total, dtype=torch.int64, device=dev)
    run, k = _segments(g, G)
    dst[out_off[run] + pop[run] + k] = prefix[gpos[run] + k + 1] - prefix[gpos[run]] + nodes[run]

    _decode_references(dst, is_ref, par, degrees, out_off, bits, c_bits, bpos, d_par,
                       n_bits, n_ref)
    src = torch.repeat_interleave(nodes, degrees, output_size=total)
    return [numeric_stream(narrow_unsigned(src, w)), numeric_stream(narrow_unsigned(dst, w))]


def _depths(is_ref: torch.Tensor, par: torch.Tensor) -> torch.Tensor:
    """Each run's dependency level: 0 for a plain run, else one more than
    its parent's.  Pointer jumping: after each round ``depth`` is the
    distance to ``nxt``, and ``nxt`` has jumped twice as far; the loop ends
    when every ``nxt`` is a plain run, after log2(chain depth) rounds."""
    depth, nxt = is_ref.to(torch.int64), par
    while bool(is_ref[nxt].any()):  # one scalar sync a round
        depth, nxt = depth + depth[nxt], nxt[nxt]
    return depth


def reference_levels(refs: torch.Tensor) -> int:
    """The number of dependency levels of an ``adj_gap`` refs stream (int64,
    well formed): the trip count of the decoder's level loop."""
    idx = torch.arange(refs.numel(), device=refs.device)
    is_ref = refs != 0
    depth = _depths(is_ref, torch.where(is_ref, idx - refs, idx))
    return int(depth.max()) if depth.numel() else 0


def _decode_references(dst, is_ref, par, degrees, out_off, bits, c_bits, bpos, d_par,
                       n_bits: int, n_ref: int) -> None:
    """Decode the reference runs into ``dst`` in place, one dependency level
    a step: a run's parent is decoded a level before it.  Each run's copied
    elements (its parent's list under its copy bits) go into its first
    slots, before its residuals, and its list is sorted in unsigned order:
    the copied and residual values of a well-formed run are disjoint
    increasing subsequences of a strictly increasing list."""
    depth = _depths(is_ref, par)
    ref_runs = torch.nonzero(is_ref).reshape(-1)
    order = ref_runs[torch.sort(depth[ref_runs], stable=True).indices]  # by level
    # the parents' elements under the copy bits, level by level
    seg, t = _segments(d_par[order], n_bits)
    e_run = order[seg]
    bit = bits[bpos[e_run] + t]
    e_run, t = e_run[bit], t[bit]
    copy_src = out_off[par[e_run]] + t
    copy_dst = out_off[e_run] + c_bits[bpos[e_run] + t] - c_bits[bpos[e_run]]
    # every slot of every reference run, level by level
    seg, t = _segments(degrees[order], n_ref)
    slot_run = order[seg]
    slot = out_off[slot_run] + t
    n_levels = int(depth.max()) if depth.numel() else 0
    counts = torch.stack([torch.bincount(depth[e_run], minlength=n_levels + 1),
                          torch.bincount(depth[slot_run], minlength=n_levels + 1)])
    n_copy, n_slot = (np.cumsum(c) for c in counts.cpu().numpy())  # one copy
    for level in range(1, n_levels + 1):  # one step a level, all its runs at once
        a, b = n_copy[level - 1], n_copy[level]
        dst[copy_dst[a:b]] = dst[copy_src[a:b]]
        a, b = n_slot[level - 1], n_slot[level]
        pos, vals = slot[a:b], dst[slot[a:b]]
        # a segmented sort: by value in unsigned order, then stably by run
        by_val = torch.sort(vals ^ _SIGN, stable=True).indices
        by_run = torch.sort(slot_run[a:b][by_val], stable=True).indices
        dst[pos] = vals[by_val][by_run]


register_codec(
    CodecSpec(
        "adj_gap",
        codec_id=28,
        encode=_adj_gap_enc,
        decode=_adj_gap_dec,
        n_inputs=2,
        n_outputs=5,
        min_version=4,
        doc="edge columns -> degree + delta-gap + reference coding (Zuckerli)",
        sig=CodecSig(
            inputs=(
                InPort(frozenset((int(SType.NUMERIC),))),
                InPort(frozenset((int(SType.NUMERIC),))),
            ),
            transfer=_adj_gap_transfer,
            params=(ParamSpec("window", "int",
                              doc="reference-list search window (0 = plain gaps)"),),
            expansion=3.0,  # narrow ids widen to u64 planes + copy bitmap
        ),
    )
)


# ------------------------------------------------------------ adjacency_auto
ADJ_SAMPLE_EDGES = 1 << 13  # trial compressions run on a bounded edge prefix


def adj_backend(window: int) -> Plan:
    """The adjacency backend graph: adj_gap + per-stream auto selectors."""
    g = GraphBuilder(2)
    nodes, degs, refs, bits, gaps = g.add(
        "adj_gap", g.input(0), g.input(1), window=window
    )
    g.select("numeric_auto", nodes)
    g.select("numeric_auto", degs)
    g.select("numeric_auto", refs)
    g.select("entropy_auto", bits)
    g.select("numeric_auto", gaps)
    return g.build(f"adj_gap_w{window}")


def _columns_backend() -> Plan:
    g = GraphBuilder(2)
    g.select("numeric_auto", g.input(0))
    g.select("numeric_auto", g.input(1))
    return g.build("edge_columns")


def _adjacency_auto(streams, params, ctx):
    """Pick plain gap coding, reference coding, or raw columns by trial.

    A bounded aligned sample of the (src, dst) columns is compressed under
    each candidate, on the sample's device and through the resolve cache
    (as the reference's trials are), and the smallest wins.  Only a codec's
    own refusal (a ``ValueError``) skips a candidate.
    """
    window = int(params.get("window", 8))
    s_src, s_dst = streams
    k = min(s_src.n_elts, ADJ_SAMPLE_EDGES)
    samples = [Stream(s.data[:k], SType.NUMERIC, s.width) for s in (s_src, s_dst)]
    candidates = [("columns", _columns_backend()), ("plain", adj_backend(0))]
    if window > 0:
        candidates.append(("refs", adj_backend(window)))
    best_plan, best_sz = None, 1 << 63
    for _name, plan in candidates:
        try:
            trial_ctx = CompressionCtx(ctx.format_version, ctx.level)
            with trial():
                sz = len(compress(plan, samples, ctx=trial_ctx, device=s_src.device))
        except ValueError:
            continue
        if sz < best_sz:
            best_plan, best_sz = plan, sz
    return best_plan if best_plan is not None else _columns_backend()


register_selector(
    SelectorSpec(
        "adjacency_auto",
        _adjacency_auto,
        doc="adjacency backend by trial: reference vs plain gaps vs columns",
        sig=SelectorSig(inputs=(
            InPort(frozenset((int(SType.NUMERIC),))),
            InPort(frozenset((int(SType.NUMERIC),))),
        )),
    )
)
