"""LZ-family codecs: ``lz77`` and the ``lzma_backend``, ``bz2_backend`` and
``zlib_backend`` leaves.

The port's copy of ``repro.codecs.lz``.  All four run on the host and had no
TPU kernel in the reference, so there is no kernel to port: each encoder
copies its input to the host, and returns its outputs on the input's device
like every other codec; each decoder copies its streams to the host, and
returns the regenerated stream on its inputs' device.  They are the codecs
whose work leaves the device.

``lz77`` — a greedy LZ parser over 4-gram hash chains of depth 1, walked as
segment-parallel lockstep numpy vector ops and spliced into the true parse
(see ``_find_tokens``).  The numpy code, its dtypes and its chain and
segment constants are the reference's, so the parse, and with it every
frame, is byte-identical.  Output follows the Zstd factoring: literals,
literal-run lengths, match lengths and offsets, each its own stream.  Only
the reference's ``_stage`` timing scopes are left out.

``lzma_backend``, ``bz2_backend`` and ``zlib_backend`` — stdlib LZMA, BWT
and DEFLATE as leaf codecs, each with the header ``u8 stype, varint width``.
"""
from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np
import torch

from ..core.codec import FIXED_STYPES, CodecSig, CodecSpec, InPort, ParamSpec, register_codec
from ..core.message import Stream, SType, from_numpy, from_wire
from ._util import HeaderReader, HeaderWriter, expect_stream

MIN_MATCH = 4
MAX_MATCH = 1 << 16

_HASH_MUL = np.uint32(2654435761)  # Knuth multiplicative hash -> 16 bits
_EXT_CHUNK_MAX = 4096  # doubling cap for batched extension gathers

# Cache blocking: the chain build, candidate validation and lockstep walk all
# process the input in fixed-size windows so their index/metadata working set
# (a handful of 4-8-byte-per-position arrays plus the window's bytes) stays
# cache-resident instead of strided over the whole input.  Sizes were swept
# empirically (2x gains on the chain build at 16 MiB); above ~16 MiB the
# unblocked versions went DRAM/TLB-bound and lost >2x throughput.
_PREV_BLOCK = 1 << 19  # positions per blocked chain-sort window
_WALK_WINDOW = 1 << 21  # input bytes per lockstep walk window
_SEG = 1024  # bytes per speculative lane segment inside a window


def _grams(data: np.ndarray) -> np.ndarray:
    """Little-endian uint32 4-grams at every position i <= n-4.

    Four phase-shifted unaligned ``uint32`` views replace the historical
    shift-and-or assembly (x86/TPU hosts are little-endian; numpy handles
    the unaligned access).
    """
    n = data.size
    ng = n - 3
    pad = np.zeros(n + 8, dtype=np.uint8)
    pad[:n] = data
    g = np.empty(ng, dtype=np.uint32)
    for k in range(4):
        cnt = g[k::4].size
        g[k::4] = pad[k : k + 4 * cnt].view("<u4")[:cnt]
    return g


def _chain_half(h: np.ndarray, prev: np.ndarray, lo: int, hi: int):
    """Stable-sort positions [lo, hi) by hash and link each to its most
    recent same-hash predecessor *within the half* (disjoint ``prev`` writes,
    so two halves can run on a thread pool).  Returns the sorted-order and
    sorted-hash arrays for cross-half stitching."""
    o = np.argsort(h[lo:hi], kind="stable").astype(np.int32)  # radix, 16-bit
    if lo:
        o += np.int32(lo)
    sh = h[o]
    same = np.empty(hi - lo, dtype=bool)
    same[0] = False
    same[1:] = sh[1:] == sh[:-1]
    shifted = np.empty(hi - lo, dtype=np.int32)
    shifted[0] = 0
    shifted[1:] = o[:-1]
    prev[o] = np.where(same, shifted, -1)
    return o, sh, same


def _build_prev(h: np.ndarray, n: int, ng: int) -> np.ndarray:
    """prev[i] = most recent j < i with h[j] == h[i] (else -1), int32.

    Large inputs are chained in ``_PREV_BLOCK``-position windows (the blocked
    generalization of the historical two-half split): each window is stably
    sorted on its own — small enough that the sort indices and hash gathers
    stay cache-resident — and a 2^16-entry last-occurrence table, updated
    window by window, re-links each window's bucket-first positions to the
    most recent same-hash position in any earlier window.  Semantics are
    identical to one global stable sort; the next window's sort overlaps the
    previous window's stitch on a 2-deep thread pipeline (argsort and the
    gathers release the GIL).
    """
    prev = np.empty(n, dtype=np.int32)
    prev[ng:] = -1
    if ng <= _PREV_BLOCK:
        _chain_half(h, prev, 0, ng)
        return prev
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    last = np.full(1 << 16, -1, dtype=np.int32)

    def _stitch(lo: int, fut) -> None:
        o, sh, same = fut.result()
        if lo:
            fpos = o[~same]  # window positions with no in-window predecessor
            prev[fpos] = last[h[fpos]]
        end = np.empty(sh.size, dtype=bool)
        end[-1] = True
        end[:-1] = sh[1:] != sh[:-1]
        last[sh[end]] = o[end]  # unique hashes: guaranteed scatter

    with ThreadPoolExecutor(1) as pool:
        pending = deque()
        for lo in range(0, ng, _PREV_BLOCK):
            hi = min(lo + _PREV_BLOCK, ng)
            pending.append((lo, pool.submit(_chain_half, h, prev, lo, hi)))
            if len(pending) > 1:
                _stitch(*pending.popleft())
        while pending:
            _stitch(*pending.popleft())
    return prev


def _prev_occurrence(data: np.ndarray) -> np.ndarray:
    """For each position i, the most recent j<i with the same 4-gram hash."""
    n = data.size
    if n < MIN_MATCH:
        return np.full(n, -1, dtype=np.int32)
    g = _grams(data)
    h = ((g * _HASH_MUL) >> np.uint32(16)).astype(np.uint16)
    return _build_prev(h, n, n - 3)


def _first_diff_byte(x: np.ndarray) -> np.ndarray:
    """Index of the lowest differing byte in each nonzero LE uint64 word."""
    low = x & (np.uint64(0) - x)
    return np.log2(low.astype(np.float64)).astype(np.int64) >> 3


_U64_ONE = np.uint64(1)
_U64_63 = np.uint64(63)


def _gather_u64(U: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Unaligned LE uint64 loads at byte offsets ``off`` from ``U`` (the
    aligned u64 view of the padded data): two contiguous-array gathers plus
    branchless shift stitching — far faster than per-byte window gathers."""
    q = off >> 3
    r = ((off & 7) << 3).astype(np.uint64)
    # (hi << 1) << (63 - r) == hi << (64 - r), well-defined at r == 0
    return (U[q] >> r) | ((U[q + 1] << _U64_ONE) << (_U64_63 - r))


def _batch_extend(
    pad: np.ndarray,
    U: np.ndarray,
    iv: np.ndarray,
    jv: np.ndarray,
    limit: np.ndarray,
) -> np.ndarray:
    """Vectorized longest-common-extension: first mismatch of pad[iv+t] vs
    pad[jv+t], per element, capped at ``limit``.

    Chunks of doubling size are gathered as 64-bit words; mismatch offsets
    come from the lowest differing byte of the first differing word.  Reads
    may run into the zero pad past the real data — spurious pad-vs-pad
    matches are cut off by the ``limit`` cap, so results stay exact.  The
    first round (one 8-byte word, which resolves the vast majority of
    matches) uses stitched unaligned u64 loads from the aligned view ``U``.
    """
    na = iv.size
    L = np.zeros(na, dtype=np.int64)
    if not na:
        return L
    x = _gather_u64(U, jv) ^ _gather_u64(U, iv)
    miss = x != 0
    L[:] = 8
    if miss.any():
        L[miss] = _first_diff_byte(x[miss])
    np.minimum(L, limit, out=L)
    act = np.nonzero(~miss & (limit > 8))[0]
    if act.size:  # second round specialized: two stitched words, no views
        bj = jv[act] + 8
        bi = iv[act] + 8
        x1 = _gather_u64(U, bj) ^ _gather_u64(U, bi)
        x2 = _gather_u64(U, bj + 8) ^ _gather_u64(U, bi + 8)
        m1 = x1 != 0
        m2 = x2 != 0
        done = m1 | m2
        off = np.where(
            m1,
            _first_diff_byte(np.where(m1, x1, 1)),
            np.int64(8) + _first_diff_byte(np.where(m2, x2, 1)),
        )
        new_l = np.minimum(np.where(done, 8 + off, 24), limit[act])
        L[act] = new_l
        act = act[~done & (new_l < limit[act])]
    chunk = 32
    while act.size:
        sw = np.lib.stride_tricks.sliding_window_view(pad, chunk)
        A = sw[jv[act] + L[act]].view(np.uint64)
        B = sw[iv[act] + L[act]].view(np.uint64)
        x = A ^ B
        neq = x != 0
        done = neq.any(axis=1)
        if done.any():
            d_rows = np.nonzero(done)[0]
            wi = np.argmax(neq[d_rows], axis=1)
            xw = x[d_rows, wi]
            fin = act[d_rows]
            L[fin] = np.minimum(
                L[fin] + (wi.astype(np.int64) << 3) + _first_diff_byte(xw),
                limit[fin],
            )
            act = act[~done]
        L[act] += chunk
        over = L[act] >= limit[act]
        if over.any():
            capped = act[over]
            L[capped] = limit[capped]
            act = act[~over]
        chunk = min(chunk * 2, _EXT_CHUNK_MAX)
    return L


def _extend_scalar(buf: bytes, j: int, i: int, n: int) -> int:
    """Exact scalar extension (bytes memcmp with doubling + bisect)."""
    limit = min(n - i, MAX_MATCH)
    L = 0
    step = 32
    while L < limit:
        c = min(step, limit - L)
        if buf[j + L : j + L + c] == buf[i + L : i + L + c]:
            L += c
            step = min(step * 2, 1 << 14)
        else:
            while c > 1:
                half = c >> 1
                if buf[j + L : j + L + half] == buf[i + L : i + L + half]:
                    L += half
                    c -= half
                else:
                    c = half
            return L
    return L


def _find_tokens(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The greedy parse: (match_starts, match_lens, offsets), int64, in order.

    Exactly reproduces the scalar walk ``i += L on match else i += 1`` with
    chain-depth-1 candidates — see the module docstring for the lockstep
    segment scheme.
    """
    n = data.size
    ng = n - 3
    empty = (np.zeros(0, np.int64),) * 3
    if ng <= 0:
        return empty
    g = _grams(data)
    h = ((g * _HASH_MUL) >> np.uint32(16)).astype(np.uint16)
    prev = _build_prev(h, n, ng)
    # candidate positions: the chained position repeats this 4-gram exactly
    BIG = np.int32(np.iinfo(np.int32).max)
    cand = np.empty(ng, dtype=np.int32)

    def _cand_slice(lo: int, hi: int) -> None:
        pv = prev[lo:hi]
        ok = (pv >= 0) & (g[pv] == g[lo:hi])  # negative pv wraps: masked out
        cand[lo:hi] = np.where(ok, np.arange(lo, hi, dtype=np.int32), BIG)

    for lo in range(0, ng, _PREV_BLOCK):  # blocked: slice stays LLC-resident
        _cand_slice(lo, min(lo + _PREV_BLOCK, ng))
    nxt = np.empty(n + 1, dtype=np.int32)
    nxt[ng:] = BIG
    nxt[:ng] = np.minimum.accumulate(cand[::-1])[::-1]
    if int(nxt[0]) == int(BIG):
        return empty  # no matches anywhere: all-literal stream

    # --- lockstep speculative walks, one per segment ---------------------
    # Full-width and mask-free: a lane whose walk passes its segment end
    # parks itself at p = n (where nxt is the sentinel), after which every
    # per-step op degenerates to a no-op for it (extension limit 0, state
    # writes gated by `has`).  No per-step lane compression.
    #
    # Cache-blocked: lanes run one _WALK_WINDOW of input at a time, so every
    # per-step gather (nxt, prev, chain scatter, most extension reads) lands
    # in that window's slice of the metadata arrays instead of striding the
    # whole input.  Each window's chains are kept with a global base index;
    # the splice below walks windows in parse order.  Inputs <= one window
    # behave exactly like the historical unblocked walk.
    S = -(-min(n, _WALK_WINDOW) // _SEG)  # lanes per window
    pad = np.zeros((n + _EXT_CHUNK_MAX + 23) & ~7, dtype=np.uint8)
    pad[:n] = data
    U = pad.view(np.uint64)
    n_i = np.int64(n)
    m2idx = np.full(ng, -1, dtype=np.int32)
    windows = []  # (chain_m, chain_l, steps, tail) per walk window
    bases = []  # global chain-index base per window
    base = 0
    for wlo in range(0, n, _WALK_WINDOW):
        steps = np.zeros(S, dtype=np.int64)
        cap = max(64, _SEG // 5)
        chain_m = np.zeros((cap, S), dtype=np.int32)
        chain_l = np.zeros((cap, S), dtype=np.int32)
        # lane starts past n (last window) clamp to n — they begin parked
        p = np.minimum(wlo + np.arange(S, dtype=np.int64) * _SEG, n)
        lend = np.minimum(p + _SEG, n)
        t = 0
        while True:
            ma = nxt[p].astype(np.int64)
            has = ma < ng
            if not has.any():
                break
            if t == cap:
                grow = np.zeros((cap, S), dtype=np.int32)
                chain_m = np.concatenate([chain_m, grow])
                chain_l = np.concatenate([chain_l, grow])
                cap *= 2
            np.minimum(ma, ng - 1, out=ma)  # clip parked/tail lanes
            ja = prev[ma].astype(np.int64)
            limit = np.where(has, np.minimum(n_i - ma, MAX_MATCH) - MIN_MATCH, 0)
            L = MIN_MATCH + _batch_extend(
                pad, U, ma + MIN_MATCH, ja + MIN_MATCH, limit
            )
            chain_m[t] = ma
            chain_l[t] = L
            steps = np.where(has, t + 1, steps)
            np.copyto(p, ma + L, where=has)
            np.copyto(p, n_i, where=p >= lend)  # park finished lanes
            t += 1
        # a lane still short of its segment end ran out of matches entirely
        tail = p < lend
        if t == 0:  # no lane recorded a token: nothing to splice or index
            continue
        tt, ss = np.nonzero(np.arange(t)[:, None] < steps[None, :])
        # later windows may revisit a match start an earlier window's lane
        # overshot into; greedy parses are memoryless, so both record the
        # same (start, length) token and either chain is a valid entry.
        m2idx[chain_m[tt, ss]] = (base + tt * S + ss).astype(np.int32)
        windows.append((chain_m, chain_l, steps, tail))
        bases.append(base)
        base += t * S

    # --- splice chains into the true parse -------------------------------
    # Indexed by *match start*, not walk position: every position in a
    # literal gap funnels to the same next match (nxt is a step function),
    # so entering any chain token by its match start resyncs immediately.
    from bisect import bisect_right

    buf = data.tobytes()
    parts_m: List[np.ndarray] = []
    parts_l: List[np.ndarray] = []
    pos = 0
    while True:
        m = int(nxt[pos])
        if m >= ng:
            break
        k = int(m2idx[m])
        if k >= 0:
            w = bisect_right(bases, k) - 1
            chain_m, chain_l, steps, tail = windows[w]
            t0, s = divmod(k - bases[w], S)
            t1 = int(steps[s])
            parts_m.append(chain_m[t0:t1, s])
            parts_l.append(chain_l[t0:t1, s])
            if tail[s]:
                break
            pos = int(chain_m[t1 - 1, s]) + int(chain_l[t1 - 1, s])
            continue
        # match start no speculative chain visited: exact scalar token (rare)
        j = int(prev[m])
        L = MIN_MATCH + _extend_scalar(buf, j + MIN_MATCH, m + MIN_MATCH, n)
        L = min(L, MAX_MATCH)
        parts_m.append(np.array([m], dtype=np.int32))
        parts_l.append(np.array([L], dtype=np.int32))
        pos = m + L
    if not parts_m:
        return empty
    M = np.concatenate(parts_m).astype(np.int64)
    L = np.concatenate(parts_l).astype(np.int64)
    D = M - prev[M].astype(np.int64)
    return M, L, D


def _lz77_enc(streams, params):
    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("lz77: fixed-width streams only (string_split first)")
    data = np.frombuffer(s.content_bytes(), dtype=np.uint8)
    n = data.size
    M, L, offsets = _find_tokens(data)

    if M.size:
        ends = M + L
        lit_runs = np.empty(M.size + 1, dtype=np.int64)
        lit_runs[0] = M[0]
        lit_runs[1:-1] = M[1:] - ends[:-1]
        lit_runs[-1] = n - ends[-1]
        # gather literal bytes by ragged ranges: O(total literals), not O(n)
        gap_starts = np.concatenate([[0], ends])
        total_lit = int(lit_runs.sum())
        intra = np.arange(total_lit, dtype=np.int64) - np.repeat(
            np.cumsum(lit_runs) - lit_runs, lit_runs
        )
        literals = data[np.repeat(gap_starts, lit_runs) + intra]
    else:
        offsets = np.zeros(0, np.int64)
        lit_runs = np.array([n], dtype=np.int64)
        literals = data

    h = HeaderWriter().u8(int(s.stype)).varint(s.width).varint(n).done()
    outs = [
        from_numpy(literals, SType.SERIAL, 1),
        from_numpy(lit_runs.astype(np.uint32), SType.NUMERIC, 4),
        from_numpy(L.astype(np.uint32), SType.NUMERIC, 4),
        from_numpy(offsets.astype(np.uint32), SType.NUMERIC, 4),
    ]
    return [o.to(s.device) for o in outs], h


def _lz77_dec(outs, header):
    literals, lit_runs, match_lens, offsets = outs
    r = HeaderReader(header)
    stype = SType(r.u8())
    width = r.varint()
    n = r.varint()
    r.expect_end()
    expect_stream(literals, SType.SERIAL, 1, "lz77", "literal")
    for s, what in ((lit_runs, "literal run"), (match_lens, "match length"), (offsets, "offset")):
        expect_stream(s, SType.NUMERIC, 4, "lz77", what)
    lit = literals.numpy()
    runs = lit_runs.numpy().astype(np.int64)
    mls = match_lens.numpy().astype(np.int64)
    offs = offsets.numpy().astype(np.int64)
    K = min(runs.size, mls.size)  # matches follow all but the final run
    cum_runs = np.zeros(runs.size + 1, dtype=np.int64)
    np.cumsum(runs, out=cum_runs[1:])
    cum_mls = np.zeros(K + 1, dtype=np.int64)
    np.cumsum(mls[:K], out=cum_mls[1:])
    if cum_runs[-1] + cum_mls[-1] != n or cum_runs[-1] != lit.size:
        raise ValueError("lz77: corrupt token streams")
    # literal destinations: run k starts after k runs and min(k, K) matches,
    # scattered by ragged ranges (disjoint: cumsums of non-negative lengths)
    lstart = cum_runs[:-1] + cum_mls[np.minimum(np.arange(runs.size), K)]
    out = np.empty(n, dtype=np.uint8)
    if lit.size:
        intra = np.arange(lit.size, dtype=np.int64) - np.repeat(
            cum_runs[:-1], runs
        )
        out[np.repeat(lstart, runs) + intra] = lit
    # match destinations, replayed in order at memcpy speed
    mstart = (cum_runs[1 : K + 1] + cum_mls[:-1]).tolist()
    if K and (offs[:K] <= 0).any():
        raise ValueError("lz77: corrupt token streams")
    ba = bytearray(out)
    for mp, length, d in zip(mstart, mls[:K].tolist(), offs[:K].tolist()):
        src = mp - d
        if src < 0:
            raise ValueError("lz77: corrupt token streams")
        if d >= length:
            ba[mp : mp + length] = ba[src : src + length]
        else:  # overlapping copy: replicate the period
            pattern = ba[src:mp]
            reps = -(-length // d)
            ba[mp : mp + length] = (pattern * reps)[:length]
    return [from_wire(stype, width, bytes(ba), None, literals.device)]


register_codec(
    CodecSpec(
        "lz77",
        codec_id=16,
        encode=_lz77_enc,
        decode=_lz77_dec,
        n_outputs=4,
        min_version=2,
        doc="greedy LZ77 -> (literals, lit-runs, match-lens, offsets) streams (host numpy)",
        sig=CodecSig(
            inputs=(InPort(FIXED_STYPES),),
            transfer=lambda atoms, params, n_out: [
                (int(SType.SERIAL), 1),
                (int(SType.NUMERIC), 4),
                (int(SType.NUMERIC), 4),
                (int(SType.NUMERIC), 4),
            ],
            expansion=2.0,
        ),
    )
)


# -------------------------------------------------------------- lzma backend
def _lzma_enc(streams, params):
    import lzma

    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("lzma_backend: fixed-width streams only")
    preset = int(params.get("preset", 6))
    return _leaf_out(s, lzma.compress(s.content_bytes(), preset=preset))


def _lzma_dec(outs, header):
    import lzma

    return _leaf_in(outs, header, lzma.decompress)


register_codec(
    CodecSpec(
        "lzma_backend",
        codec_id=24,
        encode=_lzma_enc,
        decode=_lzma_dec,
        min_version=3,
        doc="stdlib LZMA leaf",
        sig=CodecSig(
            inputs=(InPort(FIXED_STYPES),),
            transfer=lambda atoms, params, n_out: [(int(SType.SERIAL), 1)],
            params=(ParamSpec("preset", "int", doc="stdlib compression level"),),
            expansion=1.1,
            packed_outputs=(0,),
        ),
    )
)


# --------------------------------------------------------------- bz2 backend
def _bz2_enc(streams, params):
    import bz2

    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("bz2_backend: fixed-width streams only")
    level = int(params.get("level", 9))
    return _leaf_out(s, bz2.compress(s.content_bytes(), level))


def _bz2_dec(outs, header):
    import bz2

    return _leaf_in(outs, header, bz2.decompress)


register_codec(
    CodecSpec(
        "bz2_backend",
        codec_id=25,
        encode=_bz2_enc,
        decode=_bz2_dec,
        min_version=3,
        doc="stdlib BWT leaf",
        sig=CodecSig(
            inputs=(InPort(FIXED_STYPES),),
            transfer=lambda atoms, params, n_out: [(int(SType.SERIAL), 1)],
            params=(ParamSpec("level", "int", doc="stdlib compression level"),),
            expansion=1.1,
            packed_outputs=(0,),
        ),
    )
)


# -------------------------------------------------------------- zlib backend
def _zlib_enc(streams, params):
    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("zlib_backend: fixed-width streams only (string_split first)")
    level = int(params.get("level", 6))
    return _leaf_out(s, zlib.compress(s.content_bytes(), level))


def _zlib_dec(outs, header):
    return _leaf_in(outs, header, zlib.decompress)


def _leaf_out(s: Stream, payload: bytes):
    """A host leaf's payload as one SERIAL stream on the input's device, and
    the header ``u8 stype, varint width`` that rebuilds the input."""
    out = torch.from_numpy(np.frombuffer(bytearray(payload), dtype=np.uint8))
    h = HeaderWriter().u8(int(s.stype)).varint(s.width).done()
    return [Stream(out.to(s.device), SType.SERIAL, 1)], h


def _leaf_in(outs, header, decompress):
    """The stream a host leaf's payload decompresses to, on the payload's device."""
    r = HeaderReader(header)
    stype = SType(r.u8())
    width = r.varint()
    r.expect_end()
    expect_stream(outs[0], SType.SERIAL, 1, "host leaf", "payload")
    return [from_wire(stype, width, decompress(outs[0].content_bytes()), None, outs[0].device)]


register_codec(
    CodecSpec(
        "zlib_backend",
        codec_id=17,
        encode=_zlib_enc,
        decode=_zlib_dec,
        min_version=3,
        doc="stdlib DEFLATE leaf",
        sig=CodecSig(
            inputs=(InPort(FIXED_STYPES),),
            transfer=lambda atoms, params, n_out: [(int(SType.SERIAL), 1)],
            params=(ParamSpec("level", "int", doc="stdlib compression level"),),
            expansion=1.1,
            packed_outputs=(0,),
        ),
    )
)
