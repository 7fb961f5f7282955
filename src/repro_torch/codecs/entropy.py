"""Entropy coders: canonical Huffman and tANS (FSE), block-parallel.

The port's copy of ``repro.codecs.entropy`` (coder tables and decoders) and
of the encode flow of ``repro.codecs.entropy_device``.  The table builders
are copied verbatim so the header descriptors match the reference byte for
byte.  Encoding runs where the stream lives: the exact 256-bin histogram on
the device (K13), the O(256) tables on the host, then the kernels — the Huffman
symbol map (K14), or the byte shuffle (K3) that lays out the tANS lanes and
the tANS lane walk (K9) — and the bit packer, all on the device.  Decoding
runs there too: the decode tables are built on the host and copied once,
then the lane decoders (Huffman K15, tANS K10) and the byte unshuffle (K4)
that puts their lanes back into symbol order.

Wire layout per codec (identical to the reference):
  huffman: outputs = [bitstream SERIAL, block_bit_offsets NUMERIC u64]
           header  = n_symbols, block_size_log, stype, 256 nibble-packed code lengths
  fse:     outputs = [bitstream SERIAL, block_meta NUMERIC u32 (bit length, state)]
           header  = n_symbols, block_size_log, table_log, stype, normalized counts
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Tuple

import numpy as np
import torch

from ..core.codec import CodecSig, CodecSpec, InPort, in_trial, register_codec
from ..core.message import Stream, SType, narrow_unsigned, widen_unsigned
from ..kernels import ops, ref
from .coder_cache import active_cache
from ._util import HeaderReader, HeaderWriter, expect_stream, numeric_stream, rebuild_like

_BYTE_PORT = InPort(
    frozenset((int(SType.SERIAL), int(SType.NUMERIC), int(SType.STRUCT))),
    frozenset((1,)),
)

BLOCK_LOG = 12  # 4096 symbols per Huffman lane-block
MAX_CODE_LEN = 15
FSE_BLOCK_LOG = 10  # 1024 symbols per tANS lane (fixed by the wire)


# --------------------------------------------------------------- table cache
# Tables are pure functions of wire-visible descriptors: they are memoized in
# the active coder-table cache (``coder_cache``), which the engine scopes to
# one call and shares with its pool threads.
def _cached(key: tuple, build: Callable[[], object]):
    return active_cache().get_or_build(key, build)


def _on_device(key: tuple, build: Callable[[], object], device: torch.device):
    """A cached host table (or tuple of tables), and its copy on ``device``,
    cached under a key that names the device."""
    host = _cached(key, build)
    if device.type == "cpu":
        return host

    def copy():
        value = tuple(t.to(device) for t in host) if isinstance(host, tuple) else host.to(device)
        if device.type == "cuda":
            # the copy is queued on this thread's stream; a call on another
            # stream may take the cached value, so it must have landed
            torch.cuda.current_stream(device).synchronize()
        return value

    return _cached(key + (str(device),), copy)


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
    """Exact 256-bin histogram on the device (K13), brought to the host (int64)."""
    return ops.histogram(x).cpu().numpy().astype(np.int64)


def _as_i32(arr: np.ndarray) -> torch.Tensor:
    """A host table as a fresh int32 CPU tensor."""
    return torch.from_numpy(np.array(arr, dtype=np.int32))


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
    if in_trial():
        # the reference raises AssertionError here, which its trials take
        # as "inapplicable"; the port's trials take only a codec's
        # ValueError as a refusal, so the same counts refuse with one
        raise ValueError("huffman: the 15-bit length cap failed to converge")
    # outside a trial the reference's encode fails; the port writes the
    # optimal lengths under the cap, which both packages' decoders read
    return _package_merge_lengths(counts, sym)


def _package_merge_lengths(counts: np.ndarray, sym: np.ndarray) -> np.ndarray:
    """Optimal code lengths of at most ``MAX_CODE_LEN`` bits for the present
    symbols ``sym`` (>= 2 of them): package-merge (Larmore and Hirschberg).
    Each item carries how often each symbol lies under it; the 2n - 2
    lightest items of the last merge give each symbol its length."""
    n = sym.size
    w = counts[sym].astype(np.int64)
    eye = np.eye(n, dtype=np.int64)
    leaves = [(int(w[i]), eye[i]) for i in np.argsort(w, kind="stable")]
    items = leaves
    for _ in range(MAX_CODE_LEN - 1):
        packages = [
            (items[k][0] + items[k + 1][0], items[k][1] + items[k + 1][1])
            for k in range(0, len(items) - 1, 2)
        ]
        items = sorted(leaves + packages, key=lambda item: item[0])
    lens = np.zeros(256, dtype=np.uint8)
    lens[sym] = sum(item[1] for item in items[: 2 * n - 2])
    return lens


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
    codes_t, lens_t = _on_device(
        ("huff_enc_t", lens.tobytes()),
        lambda: (_as_i32(_huffman_codes_cached(lens)), _as_i32(lens)),
        dev,
    )
    code, nbits = ops.huffman_map(x, codes_t, lens_t)
    offs = ref.exclusive_offsets(nbits)
    total_bytes = (int(offs[-1]) + 7) >> 3
    packed = ref.pack_bits(code, offs[:-1], total_bytes)
    block_offs = offs[:-1:1 << BLOCK_LOG].contiguous()
    h = HeaderWriter().varint(n).u8(BLOCK_LOG).u8(int(streams[0].stype))
    nib = (lens[0::2] | (lens[1::2] << 4)).astype(np.uint8)  # nibble-pack lengths
    h.bytes_(nib.tobytes())
    return [Stream(packed, SType.SERIAL, 1), numeric_stream(block_offs)], h.done()


def _lane_symbols(planes: torch.Tensor, n: int, stype: SType) -> Stream:
    """(max_rem, n_lanes) decoded lanes -> the stream of their first n symbols.

    K4 lays the lanes back to back; every lane but the last is full, so the
    symbols are the first n bytes.
    """
    records = ops.byteunshuffle(planes)
    return rebuild_like(stype, 1, records.reshape(-1)[:n])


def huffman_lanes(outs, header):
    """A huffman node's K15 inputs on its streams' device.

    Returns (buf, pos, lut, max_rem, n, stype): the bitstream padded with
    16 + (15 * max_rem + 7) // 8 zero bytes, the lanes' int64 first bits, the
    packed decode LUT, the longest lane, the symbol count and the stream type.
    """
    bitstream, block_offs_s = outs
    r = HeaderReader(header)
    n = r.varint()
    block_log = r.u8()
    stype_tag = r.u8()
    nib_raw = bytes(r.bytes_())
    r.expect_end()
    if len(nib_raw) != 128:
        raise ValueError("huffman: the header holds 256 nibble-packed code lengths")
    expect_stream(bitstream, SType.SERIAL, 1, "huffman", "bit")
    expect_stream(block_offs_s, SType.NUMERIC, 8, "huffman", "block offset")

    def build():
        nib = np.frombuffer(nib_raw, dtype=np.uint8)
        lens = np.zeros(256, dtype=np.uint8)
        lens[0::2] = nib & 0xF
        lens[1::2] = nib >> 4
        lut_sym, lut_len = _huffman_decode_lut(lens)
        return ref.pack_huffman_lut(torch.from_numpy(lut_sym.copy()), torch.from_numpy(lut_len.copy()))

    data = bitstream.raw()
    dev = data.device
    lut = _on_device(("huff_dec", nib_raw), build, dev)
    block = 1 << block_log
    n_blocks = (n + block - 1) // block
    pos = block_offs_s.data
    if pos.numel() != n_blocks:
        raise ValueError("huffman: block offset count mismatch")
    # fail closed on a lane that starts outside its bitstream (one scalar sync)
    if n_blocks and not bool(((pos >= 0) & (pos <= 8 * data.numel())).all()):
        raise ValueError("huffman: a block offset lies past the bitstream")
    max_rem = min(n, block)
    # exhausted lanes decode the pad's zero bits (<= 15 bits per symbol of
    # overrun, never out of bounds); their surplus rows are trimmed
    pad = 16 + ((MAX_CODE_LEN * max_rem + 7) >> 3)
    buf = torch.zeros(data.numel() + pad, dtype=torch.uint8, device=dev)
    buf[: data.numel()] = data
    return buf, pos, lut, max_rem, n, SType(stype_tag)


def _huffman_dec(outs, header):
    buf, pos, lut, max_rem, n, stype = huffman_lanes(outs, header)
    return [_lane_symbols(ops.huffman_decode(buf, pos, lut, max_rem), n, stype)]


register_codec(
    CodecSpec(
        "huffman",
        codec_id=14,
        encode=_huffman_enc,
        decode=_huffman_dec,
        n_outputs=2,
        min_version=2,
        doc="canonical Huffman, lane-blocked for parallel decode (kernels K14, K15, K4)",
        sig=CodecSig(
            inputs=(_BYTE_PORT,),
            transfer=lambda atoms, params, n_out: [
                (int(SType.SERIAL), 1),
                (int(SType.NUMERIC), 8),
            ],
            expansion=2.0,  # <= 15 bits/byte worst case + lane offsets
            packed_outputs=(0,),
        ),
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
    if not 1 <= table_log <= ref.FSE_MAX_TABLE_LOG:
        raise ValueError(f"fse: table_log {table_log} is outside 1..{ref.FSE_MAX_TABLE_LOG}")
    stype_tag = int(streams[0].stype)
    if n == 0:
        empty = Stream(torch.zeros(0, dtype=torch.uint8, device=dev), SType.SERIAL, 1)
        meta = numeric_stream(torch.zeros(0, dtype=torch.int32, device=dev))
        return [empty, meta], _fse_header(0, table_log, stype_tag, b"")
    norm = _normalize_counts(_host_counts(x), table_log)
    total = 1 << table_log

    _ds, _dn, _db, enc_table, nb0t, thrt, st0t = _fse_tables_cached(norm, table_log)
    width = enc_table.shape[1]

    def build():  # the kernel's tables, compacted once per table
        sym_start, enc_compact = ref.compact_encode_table(
            torch.from_numpy(np.array(norm)), torch.from_numpy(np.array(enc_table.reshape(-1))), width
        )
        return _as_i32(nb0t), _as_i32(thrt), _as_i32(st0t), _as_i32(norm), sym_start, enc_compact

    nb0, thr, st0, norm_t, sym_start, enc_compact = _on_device(
        ("fse_enc", norm.tobytes(), table_log), build, dev
    )

    block = 1 << FSE_BLOCK_LOG
    n_blocks = (n + block - 1) // block
    padded = torch.zeros(n_blocks * block, dtype=torch.uint8, device=dev)
    padded[:n] = x
    # transposed lanes: each step of the lane walk reads one contiguous row
    lanesT = ops.byteshuffle(padded.view(n_blocks, block))
    starts = torch.arange(n_blocks, dtype=torch.int64, device=dev) * block
    rem = (n - starts).clamp(max=block).to(torch.int32)
    vals, nbs, state = ops.fse_encode(
        lanesT, rem, nb0, thr, st0, norm_t, sym_start, enc_compact, width, total,
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


def fse_lanes(outs, header):
    """An fse node's K10 inputs on its streams' device.

    Returns (args, n, stype): ``args`` are :func:`ops.fse_decode`'s arguments
    (buf, lane_base, bitlen, state0, sym, nbb, max_rem) — the concatenated
    lane bitstreams padded by 8 zero bytes, each lane's int64 byte offset
    (the exclusive sum of (bitlen + 7) // 8) and bit length, its int32 final
    encoder state, the decode tables and the longest lane — or None for an
    empty stream; then the symbol count and the stream type.
    """
    bitstream, meta_s = outs
    r = HeaderReader(header)
    n = r.varint()
    block_log = r.u8()
    table_log = r.u8()
    stype = SType(r.u8())
    tbl = HeaderReader(r.bytes_())
    r.expect_end()
    if n == 0:
        return None, 0, stype
    norm = np.zeros(256, dtype=np.int64)
    for _ in range(tbl.varint()):
        s = tbl.varint()
        norm[s] = tbl.varint()
    expect_stream(bitstream, SType.SERIAL, 1, "fse", "bit")
    expect_stream(meta_s, SType.NUMERIC, 4, "fse", "block meta")
    if not 1 <= table_log <= ref.FSE_MAX_TABLE_LOG:
        raise ValueError(f"fse: table_log {table_log} is outside 1..{ref.FSE_MAX_TABLE_LOG}")
    if int(norm.sum()) != 1 << table_log:
        raise ValueError(f"fse: normalized counts do not sum to 2^{table_log}")

    def build():
        dec_sym, dec_nb, dec_base, *_ = _fse_tables_cached(norm, table_log)
        return ref.pack_fse_table(*(torch.from_numpy(a.copy()) for a in (dec_sym, dec_nb, dec_base)))

    data = bitstream.raw()
    dev = data.device
    sym, nbb = _on_device(("fse_dec", norm.tobytes(), table_log), build, dev)
    block = 1 << block_log
    n_blocks = (n + block - 1) // block
    if meta_s.data.numel() != 2 * n_blocks:
        raise ValueError("fse: block meta count mismatch")
    meta = widen_unsigned(meta_s.data).view(n_blocks, 2)
    bitlen = meta[:, 0].contiguous()
    lane_base = ref.exclusive_offsets((bitlen + 7) >> 3)
    # fail closed unless the lanes tile the bitstream and every state lies
    # in the table (one scalar sync)
    ok = (lane_base[-1] == data.numel()) & (meta[:, 1] < nbb.numel()).all()
    if not bool(ok):
        raise ValueError("fse: block meta does not match the bitstream or the table")
    buf = torch.zeros(data.numel() + 8, dtype=torch.uint8, device=dev)
    buf[: data.numel()] = data
    state0 = meta[:, 1].to(torch.int32)
    return (buf, lane_base[:-1], bitlen, state0, sym, nbb, min(n, block)), n, stype


def _fse_dec(outs, header):
    args, n, stype = fse_lanes(outs, header)
    if args is None:
        return [rebuild_like(stype, 1, outs[0].raw()[:0])]
    return [_lane_symbols(ops.fse_decode(*args), n, stype)]


register_codec(
    CodecSpec(
        "fse",
        codec_id=15,
        encode=_fse_enc,
        decode=_fse_dec,
        n_outputs=2,
        min_version=2,
        doc="tANS (FSE), lane-blocked (kernels K3 + K9, K10 + K4)",
        sig=CodecSig(
            inputs=(_BYTE_PORT,),
            transfer=lambda atoms, params, n_out: [
                (int(SType.SERIAL), 1),
                (int(SType.NUMERIC), 4),
            ],
            expansion=2.0,
            packed_outputs=(0,),
        ),
    )
)
