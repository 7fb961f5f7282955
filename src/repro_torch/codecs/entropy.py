"""Entropy coders: canonical Huffman and tANS (FSE), block-parallel.

The port's copy of ``repro.codecs.entropy`` (coder tables and decoders) and
of the encode flow of ``repro.codecs.entropy_device``.  The table builders
are copied verbatim so the header descriptors match the reference byte for
byte.  Encoding runs where the stream lives: the exact 256-bin histogram on
the device, the O(256) tables on the host, then the kernels — the Huffman
symbol map (K14), or the byte shuffle (K3) that lays out the tANS lanes and
the tANS lane walk (K9) — and the bit packer, all on the device.  Decoders
are the reference's numpy lane decoders.

Wire layout per codec (identical to the reference):
  huffman: outputs = [bitstream SERIAL, block_bit_offsets NUMERIC u64]
           header  = n_symbols, block_size_log, stype, 256 nibble-packed code lengths
  fse:     outputs = [bitstream SERIAL, block_meta NUMERIC u32 (bit length, state)]
           header  = n_symbols, block_size_log, table_log, stype, normalized counts
"""
from __future__ import annotations

import heapq
import threading
from collections import OrderedDict
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..core.codec import CodecSpec, register_codec
from ..core.message import Stream, SType, narrow_unsigned
from ..kernels import ops, ref
from ._util import HeaderReader, HeaderWriter, host_stream, numeric_stream

BLOCK_LOG = 12  # 4096 symbols per Huffman lane-block
MAX_CODE_LEN = 15
FSE_BLOCK_LOG = 10  # 1024 symbols per tANS lane (fixed by the wire)
_DEC_GROUP_BYTES = 1 << 22  # decoded bytes per lane-decoder group

_U64_1 = np.uint64(1)
_U64_7 = np.uint64(7)
_U64_3 = np.uint64(3)


# --------------------------------------------------------------- table cache
# Tables are pure functions of wire-visible descriptors; keep recent ones.
_TABLES: "OrderedDict[tuple, object]" = OrderedDict()
_TABLES_LOCK = threading.Lock()
_TABLES_MAX = 256


def _cached(key: tuple, build: Callable[[], object]):
    with _TABLES_LOCK:
        hit = _TABLES.get(key)
        if hit is not None:
            _TABLES.move_to_end(key)
            return hit
    value = build()
    with _TABLES_LOCK:
        _TABLES[key] = value
        while len(_TABLES) > _TABLES_MAX:
            _TABLES.popitem(last=False)
    return value


def _freeze(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Mark cached tables read-only: they are shared between callers."""
    for a in arrays:
        a.setflags(write=False)
    return arrays


def _as_u8(s: Stream, op: str) -> torch.Tensor:
    if s.stype == SType.SERIAL or (s.stype == SType.NUMERIC and s.width == 1):
        return s.raw()
    if s.stype == SType.STRUCT and s.width == 1:
        return s.data
    raise ValueError(f"{op}: byte streams only (serial / numeric(1)); transpose first")


def _host_counts(x: torch.Tensor) -> np.ndarray:
    """Exact 256-bin histogram on the device, brought to the host (int64)."""
    return ref.histogram_exact(x).cpu().numpy().astype(np.int64)


def _on(dev: torch.device, arr: np.ndarray) -> torch.Tensor:
    """A host table as an int32 tensor on ``dev``."""
    return torch.from_numpy(np.array(arr, dtype=np.int32)).to(dev)


# =====================================================================
# Canonical Huffman
# =====================================================================
def _huffman_code_lengths(counts: np.ndarray) -> np.ndarray:
    """Package-merge-free Huffman with length cap via count flattening."""
    sym = np.nonzero(counts)[0]
    if sym.size == 0:
        return np.zeros(256, dtype=np.uint8)
    if sym.size == 1:
        lens = np.zeros(256, dtype=np.uint8)
        lens[sym[0]] = 1
        return lens
    c = counts.astype(np.float64)
    for _ in range(16):  # flatten until the cap holds
        heap: List[Tuple[float, int]] = [(c[s], int(s)) for s in sym]
        heapq.heapify(heap)
        parent = {}
        next_id = 256
        while len(heap) > 1:
            a = heapq.heappop(heap)
            b = heapq.heappop(heap)
            parent[a[1]] = next_id
            parent[b[1]] = next_id
            heapq.heappush(heap, (a[0] + b[0], next_id))
            next_id += 1
        lens = np.zeros(256, dtype=np.uint8)
        for s in sym:
            d = 0
            node = int(s)
            while node in parent:
                node = parent[node]
                d += 1
            lens[s] = d
        if lens.max() <= MAX_CODE_LEN:
            return lens
        c = np.maximum(c, c[sym].sum() / (1 << MAX_CODE_LEN))  # flatten tail
    raise AssertionError("huffman length cap failed to converge")


def _canonical_order(lens: np.ndarray) -> np.ndarray:
    """Present symbols sorted by (code length, symbol) — canonical order."""
    order = np.lexsort((np.arange(256), lens))
    return order[np.count_nonzero(lens == 0) :]


def _canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Assign canonical codes; returned bit-reversed for LSB-first packing."""
    codes = np.zeros(256, dtype=np.uint32)
    order = _canonical_order(lens)
    if order.size == 0:
        return codes
    ol = lens[order].astype(np.int64)
    # canonical recurrence code(k) = (code(k-1) + 1) << (L_k - L_{k-1}) in
    # closed form via MSB start positions: start_k = sum over earlier symbols
    # of 2^(15 - L_j), code_k = start_k >> (15 - L_k) — exact because
    # canonical codes tile [0, 2^15) contiguously in canonical order
    widths = (np.int64(1) << (MAX_CODE_LEN - ol)).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    code = (starts >> (MAX_CODE_LEN - ol)).astype(np.int64)
    # bit-reverse each code over its own length: reverse over 15 bits, then
    # shift out the (15 - L) low zeros
    rev = np.zeros_like(code)
    c = code.copy()
    for _ in range(MAX_CODE_LEN):
        rev = (rev << 1) | (c & 1)
        c >>= 1
    codes[order] = (rev >> (MAX_CODE_LEN - ol)).astype(np.uint32)
    return codes


def _rev15_table() -> np.ndarray:
    """idx -> its 15-bit reversal."""
    x = np.arange(1 << MAX_CODE_LEN, dtype=np.int32)
    r = np.zeros_like(x)
    for _ in range(MAX_CODE_LEN):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def _huffman_codes_cached(lens: np.ndarray) -> np.ndarray:
    return _cached(("huff_enc", lens.tobytes()), lambda: _freeze(_canonical_codes(lens))[0])


def _huffman_decode_lut(lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(lut_sym u8, lut_len u64): LSB-first 15-bit decode LUT, vectorized."""
    order = _canonical_order(lens)
    lut_sym = np.zeros(1 << MAX_CODE_LEN, dtype=np.uint8)
    lut_len = np.zeros(1 << MAX_CODE_LEN, dtype=np.uint64)
    if order.size:
        widths = (np.int64(1) << (MAX_CODE_LEN - lens[order].astype(np.int64)))
        total = int(widths.sum())
        msb_sym = np.zeros(1 << MAX_CODE_LEN, dtype=np.uint8)
        msb_len = np.zeros(1 << MAX_CODE_LEN, dtype=np.uint8)
        msb_sym[:total] = np.repeat(order.astype(np.uint8), widths)
        msb_len[:total] = np.repeat(lens[order], widths)
        rev = _cached(("rev15",), lambda: _freeze(_rev15_table())[0])
        lut_sym = msb_sym[rev]
        lut_len = msb_len[rev].astype(np.uint64)
    return _freeze(lut_sym, lut_len)


def _huffman_enc(streams, params):
    x = _as_u8(streams[0], "huffman")
    n = x.numel()
    dev = x.device
    lens = _huffman_code_lengths(_host_counts(x))
    codes = _huffman_codes_cached(lens)
    code, nbits = ops.huffman_map(x, _on(dev, codes), _on(dev, lens))
    offs = ref.exclusive_offsets(nbits)
    total_bytes = (int(offs[-1]) + 7) >> 3
    packed = ref.pack_bits(code, offs[:-1], total_bytes)
    block_offs = offs[:-1:1 << BLOCK_LOG].contiguous()
    h = HeaderWriter().varint(n).u8(BLOCK_LOG).u8(int(streams[0].stype))
    nib = (lens[0::2] | (lens[1::2] << 4)).astype(np.uint8)  # nibble-pack lengths
    h.bytes_(nib.tobytes())
    return [Stream(packed, SType.SERIAL, 1), numeric_stream(block_offs)], h.done()


def _huffman_dec(outs, header):
    bitstream, block_offs_s = outs
    r = HeaderReader(header)
    n = r.varint()
    block_log = r.u8()
    stype_tag = r.u8()
    nib_raw = bytes(r.bytes_())
    r.expect_end()
    nib = np.frombuffer(nib_raw, dtype=np.uint8)
    lens = np.zeros(256, dtype=np.uint8)
    lens[0::2] = nib & 0xF
    lens[1::2] = nib >> 4
    lut_sym, lut_len = _cached(("huff_dec", nib_raw), lambda: _huffman_decode_lut(lens))
    data = bitstream.numpy()

    block = 1 << block_log
    n_blocks = (n + block - 1) // block
    pos_all = block_offs_s.numpy().astype(np.uint64).copy()
    if pos_all.size != n_blocks:
        raise ValueError("huffman: block offset count mismatch")
    rem = np.minimum(n - np.arange(n_blocks, dtype=np.int64) * block, block)
    max_rem = int(rem.max()) if n_blocks else 0
    # mask-free loop: exhausted lanes keep decoding zero bits from the pad
    # region (never OOB; the pad absorbs <= 15 bits/symbol of overrun) and
    # their surplus columns are trimmed at concatenation.
    pad = 16 + ((MAX_CODE_LEN * max_rem + 7) >> 3)
    buf = np.zeros(data.size + pad, dtype=np.uint8)
    buf[: data.size] = data
    sliding = np.lib.stride_tricks.sliding_window_view(buf, 8)
    out = np.empty((block, n_blocks), dtype=np.uint8)  # row-major hot stores
    low_mask = np.uint64((1 << MAX_CODE_LEN) - 1)
    G = max(1, _DEC_GROUP_BYTES // block)
    for g0 in range(0, n_blocks, G):
        g1 = min(g0 + G, n_blocks)
        pos = pos_all[g0:g1].copy()
        max_rem_g = int(rem[g0:g1].max())
        i = 0
        while i < max_rem_g:
            # one gather refills >= 57 valid bits -> up to 3 symbols/refill
            w = sliding[(pos >> _U64_3)].view(np.uint64)[:, 0]
            w >>= pos & _U64_7
            low = w & low_mask
            ln = lut_len[low]
            out[i, g0:g1] = lut_sym[low]
            if i + 1 < max_rem_g:
                w >>= ln
                low = w & low_mask
                l2 = lut_len[low]
                out[i + 1, g0:g1] = lut_sym[low]
                ln += l2
                if i + 2 < max_rem_g:
                    w >>= l2
                    low = w & low_mask
                    out[i + 2, g0:g1] = lut_sym[low]
                    ln += lut_len[low]
                    pos += ln
                    i += 3
                    continue
                pos += ln
                i += 2
                continue
            pos += ln
            i += 1
    if n_blocks:
        lanes = out.T  # (n_blocks, block); full lanes except possibly the last
        result = np.concatenate(
            [np.ascontiguousarray(lanes[:-1]).reshape(-1), lanes[-1, : rem[-1]]]
        )
    else:
        result = np.zeros(0, np.uint8)
    return [host_stream(SType(stype_tag), 1, result.tobytes())]


register_codec(
    CodecSpec(
        "huffman",
        codec_id=14,
        encode=_huffman_enc,
        decode=_huffman_dec,
        n_outputs=2,
        min_version=2,
        doc="canonical Huffman, lane-blocked for parallel decode (kernel K14)",
    )
)


# =====================================================================
# FSE / tANS
# =====================================================================
def _normalize_counts(counts: np.ndarray, table_log: int) -> np.ndarray:
    """Largest-remainder normalization of symbol counts to sum 2^table_log."""
    total = 1 << table_log
    n = counts.sum()
    if n == 0:
        raise ValueError("fse: empty input")
    scaled = counts.astype(np.float64) * total / n
    norm = np.floor(scaled).astype(np.int64)
    norm[(counts > 0) & (norm == 0)] = 1  # every present symbol needs a slot
    diff = total - norm.sum()
    if diff > 0:
        order = np.argsort(-(scaled - norm))
        for i in range(int(diff)):
            norm[order[i % order.size]] += 1
    elif diff < 0:
        # remove from the largest (keeping >=1 for present symbols)
        for _ in range(int(-diff)):
            cand = np.argmax(norm - (counts > 0))
            if norm[cand] <= 1:
                cand = int(np.argmax(norm))
            norm[cand] -= 1
    assert norm.sum() == total and (norm[counts > 0] >= 1).all()
    return norm


def _bit_length(x: np.ndarray) -> np.ndarray:
    """Vectorized int bit_length for small non-negative ints (exact)."""
    return np.ceil(np.log2(x.astype(np.float64) + 1.0)).astype(np.int64)


def _spread_symbols(norm: np.ndarray, table_log: int) -> np.ndarray:
    """tANS symbol spread — vectorized: occurrence k lands at (k*step) & mask."""
    total = 1 << table_log
    step = (total >> 1) + (total >> 3) + 3
    positions = (np.arange(total, dtype=np.int64) * step) & (total - 1)
    spread = np.zeros(total, dtype=np.int64)
    spread[positions] = np.repeat(np.arange(norm.size, dtype=np.int64), norm)
    return spread


def _build_tables(norm: np.ndarray, table_log: int):
    """Build tANS encode/decode tables from normalized counts (vectorized).

    Slot-order occurrence ranks come from a stable argsort of the spread:
    slots grouped by symbol, slot order preserved inside each group — which
    is exactly the x' = norm[s]+k numbering of the serial construction.
    """
    total = 1 << table_log
    spread = _spread_symbols(norm, table_log)
    order = np.argsort(spread, kind="stable")
    sym_sorted = spread[order]
    group_start = np.concatenate([[0], np.cumsum(norm)[:-1]])
    rank = np.arange(total, dtype=np.int64) - group_start[sym_sorted]
    x = norm[sym_sorted] + rank  # x' in [norm[s], 2*norm[s])
    nb_sorted = table_log - (_bit_length(x) - 1)
    dec_sym = spread.astype(np.uint8)
    dec_nb = np.zeros(total, dtype=np.int32)
    dec_base = np.zeros(total, dtype=np.int32)
    dec_nb[order] = nb_sorted
    dec_base[order] = (x << nb_sorted) - total
    width = int(norm.max()) if norm.max() else 1
    enc_table = np.zeros((norm.size, width), dtype=np.int32)
    enc_table[sym_sorted, rank] = order
    return dec_sym, dec_nb, dec_base, enc_table


def _fse_tables_cached(norm: np.ndarray, table_log: int):
    """All FSE tables for (norm, table_log): (dec_sym, dec_nb, dec_base,
    enc_table, nb0, thr, st0).  nb0/thr give the emitted bit count as
    ``nb0 - (X < thr)``; st0 is the lane-start state."""

    def build():
        dec_sym, dec_nb, dec_base, enc_table = _build_tables(norm, table_log)
        bl = _bit_length(norm)
        nb0 = (table_log + 1) - bl
        thr = norm << np.maximum(nb0, 0)
        st0 = enc_table[:, 0].copy()
        return _freeze(dec_sym, dec_nb, dec_base, enc_table, nb0, thr, st0)

    return _cached(("fse", norm.tobytes(), table_log), build)


def _fse_header(n: int, table_log: int, stype_tag: int, norm_desc: bytes) -> bytes:
    h = HeaderWriter().varint(n).u8(FSE_BLOCK_LOG).u8(table_log).u8(stype_tag)
    return h.bytes_(norm_desc).done()


def _fse_enc(streams, params):
    x = _as_u8(streams[0], "fse")
    n = x.numel()
    dev = x.device
    table_log = int(params.get("table_log", 11))
    stype_tag = int(streams[0].stype)
    if n == 0:
        empty = Stream(torch.zeros(0, dtype=torch.uint8, device=dev), SType.SERIAL, 1)
        meta = numeric_stream(torch.zeros(0, dtype=torch.int32, device=dev))
        return [empty, meta], _fse_header(0, table_log, stype_tag, b"")
    norm = _normalize_counts(_host_counts(x), table_log)
    _ds, _dn, _db, enc_table, nb0t, thrt, st0t = _fse_tables_cached(norm, table_log)
    total = 1 << table_log
    width = enc_table.shape[1]

    block = 1 << FSE_BLOCK_LOG
    n_blocks = (n + block - 1) // block
    padded = torch.zeros(n_blocks * block, dtype=torch.uint8, device=dev)
    padded[:n] = x
    # transposed lanes: each step of the lane walk reads one contiguous row
    lanesT = ops.byteshuffle(padded.view(n_blocks, block))
    starts = torch.arange(n_blocks, dtype=torch.int64, device=dev) * block
    rem = (n - starts).clamp(max=block).to(torch.int32)
    sym_start, enc_compact = ref.compact_encode_table(
        torch.from_numpy(np.array(norm)), torch.from_numpy(np.array(enc_table.reshape(-1))), width
    )
    vals, nbs, state = ops.fse_encode(
        lanesT, rem, _on(dev, nb0t), _on(dev, thrt), _on(dev, st0t), _on(dev, norm),
        sym_start.to(dev), enc_compact.to(dev), width, total,
    )
    goffs, bitpos, byte_off = ref.fse_lane_offsets(nbs)
    stream_out = ref.pack_bits(vals, goffs, int(byte_off[-1]))
    # block meta: (bit length, final state) as u32 pairs
    meta = torch.stack([bitpos, state.to(torch.int64)], dim=1).reshape(-1)

    nz = np.nonzero(norm)[0]
    hw = HeaderWriter()
    hw.varint(nz.size)
    for s in nz:
        hw.varint(int(s))
        hw.varint(int(norm[s]))
    header = _fse_header(n, table_log, stype_tag, hw.done())
    return [Stream(stream_out, SType.SERIAL, 1), numeric_stream(narrow_unsigned(meta, 4))], header


def _fse_dec(outs, header):
    bitstream, meta_s = outs
    r = HeaderReader(header)
    n = r.varint()
    block_log = r.u8()
    table_log = r.u8()
    stype_tag = r.u8()
    tbl = HeaderReader(r.bytes_())
    r.expect_end()
    if n == 0:
        return [host_stream(SType(stype_tag), 1, b"")]
    norm = np.zeros(256, dtype=np.int64)
    for _ in range(tbl.varint()):
        s = tbl.varint()
        norm[s] = tbl.varint()
    dec_sym, dec_nb, dec_base, _enc, _nb0, _thr, _st0 = _fse_tables_cached(norm, table_log)

    block = 1 << block_log
    n_blocks = (n + block - 1) // block
    meta = meta_s.numpy().astype(np.int64)
    bitlen = meta[0::2]
    state_all = meta[1::2]
    nbytes = (bitlen + 7) // 8
    offsets = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(nbytes, out=offsets[1:])
    # per-lane padded buffers for vectorized backward reads, filled with one
    # ragged scatter
    cap = int(nbytes.max()) + 16 if n_blocks else 16
    bitbuf = np.zeros((n_blocks, cap), dtype=np.uint8)
    flat = bitbuf.reshape(-1)
    lane_base = np.arange(n_blocks, dtype=np.int64) * cap
    total_bytes = int(offsets[-1])
    intra = np.arange(total_bytes, dtype=np.int64) - np.repeat(offsets[:-1], nbytes)
    flat[np.repeat(lane_base, nbytes) + intra] = bitstream.numpy()
    sliding = np.lib.stride_tricks.sliding_window_view(flat, 8)
    rem = np.minimum(n - np.arange(n_blocks, dtype=np.int64) * block, block)
    out = np.empty((block, n_blocks), dtype=np.uint8)
    # mask-free: exhausted lanes walk garbage states over the zero pad —
    # always in-table (base+bits stays in [0, total)), trimmed at the end.
    G = max(1, _DEC_GROUP_BYTES // block)
    for g0 in range(0, n_blocks, G):
        g1 = min(g0 + G, n_blocks)
        state = state_all[g0:g1].copy()
        cursor = bitlen[g0:g1].copy()  # read backward from the end
        lb = lane_base[g0:g1]
        for i in range(int(rem[g0:g1].max())):
            out[i, g0:g1] = dec_sym[state]
            nb = dec_nb[state]
            base = dec_base[state]
            cursor -= nb
            byte0 = np.maximum(cursor >> 3, 0)
            w = sliding[lb + byte0].view(np.uint64)[:, 0]
            bits = (w >> (cursor & 7).astype(np.uint64)) & (
                (_U64_1 << nb.astype(np.uint64)) - _U64_1
            )
            state = base + bits.astype(np.int64)
    lanes = out.T
    result = np.concatenate(
        [np.ascontiguousarray(lanes[:-1]).reshape(-1), lanes[-1, : rem[-1]]]
    )
    return [host_stream(SType(stype_tag), 1, result.tobytes())]


register_codec(
    CodecSpec(
        "fse",
        codec_id=15,
        encode=_fse_enc,
        decode=_fse_dec,
        n_outputs=2,
        min_version=2,
        doc="tANS (FSE), lane-blocked (kernels K3 + K9)",
    )
)
