"""Numeric transforms: delta, zigzag, transpose, transpose_split, range_pack,
bitpack, fused_delta_bitpack, rle, tokenize.

The port's copy of the slice's codecs from ``repro.codecs.numeric``: same
codec ids, same headers, same output streams.  Encoders are PyTorch on the
device the stream lives on — ``delta``, ``transpose``, ``transpose_split``,
``bitpack`` and ``fused_delta_bitpack`` through their kernels
(``kernels/ops.py``), the others as plain tensor ops, since the reference ran
them on the host and they had no TPU kernel.  Decoders run the same way on
the device their input lies on: ``delta`` through K2, ``transpose`` and
``transpose_split`` through K4, ``bitpack`` through K6 and
``fused_delta_bitpack`` through K12, ``zigzag``, ``range_pack``, ``rle`` and
``tokenize`` as tensor ops (the unsigned helpers, a byte gather with shifts,
``repeat_interleave``, a row gather).  ``bitpack`` at bits that do not
divide 32, or on a 64-bit column, takes the codecs' bit writer and reader,
as ``range_pack`` does.  ``tokenize`` on a STRING stream builds its
dictionary on the host (``_tokenize_strings``), as the reference does, and
gathers the strings back on the device.

Unsigned semantics on signed carriers: values are widened to int64 (widths
1, 2, 4) or handled as 64-bit patterns in 32-bit halves (width 8), so no
result relies on signed overflow.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.codec import (
    ANY_STYPES,
    FIXED_STYPES,
    CodecSig,
    CodecSpec,
    InPort,
    ParamSpec,
    register_codec,
)
from ..core.message import (
    Stream,
    SType,
    join_u32,
    narrow_unsigned,
    strings,
    sub_u64,
    widen_unsigned,
)
from ..kernels import ops, ref
from ._util import (
    expect_stream,
    HeaderReader,
    HeaderWriter,
    fixed_records,
    numeric_stream,
    rebuild_like,
)

_SERIAL = int(SType.SERIAL)
_NUMERIC = int(SType.NUMERIC)
_NUM_PORT = InPort(frozenset((_NUMERIC,)))
_BYTEPLANE_PORT = InPort(frozenset((int(SType.STRUCT), _NUMERIC)))

_SIGN = -(1 << 63)  # int64 sign bit: x ^ _SIGN orders bit patterns as unsigned
_M32 = 0xFFFFFFFF


def _require_numeric(s: Stream, op: str) -> torch.Tensor:
    if s.stype != SType.NUMERIC:
        raise ValueError(f"{op}: numeric streams only, got {s.stype.name}")
    return s.data


def _unsigned_min(u: torch.Tensor) -> int:
    """Unsigned minimum of int64 bit patterns, as the int64 pattern."""
    return int((u ^ _SIGN).min()) ^ _SIGN


def _unsigned_max(t: torch.Tensor) -> int:
    """Unsigned maximum of a carrier's values (any width), as a Python int
    >= 0; 0 for no values.  One reduction on the tensor's device."""
    if not t.numel():
        return 0
    w = t.element_size()
    if t.dtype == torch.uint8:
        return int(t.max())
    sign = -(1 << (8 * w - 1))  # flipping the sign bit orders patterns as unsigned
    return (int((t ^ sign).max()) ^ sign) & ((1 << 8 * w) - 1)


# --------------------------------------------------------------------- delta
def _delta_enc(streams, params):
    x = _require_numeric(streams[0], "delta")
    return [numeric_stream(ops.delta_encode(x))], b""


def _delta_dec(outs, header):
    d = _require_numeric(outs[0], "delta")
    return [numeric_stream(ops.delta_decode(d))]


register_codec(
    CodecSpec(
        "delta",
        codec_id=3,
        encode=_delta_enc,
        decode=_delta_dec,
        doc="wrapping first-difference on the unsigned view (kernels K1, K2)",
        sig=CodecSig(
            inputs=(_NUM_PORT,),
            transfer=lambda atoms, params, n_out: [atoms[0]],
        ),
    )
)


# -------------------------------------------------------------------- zigzag
def _zigzag_enc(streams, params):
    s = streams[0]
    t = _require_numeric(s, "zigzag")
    if s.width == 8:
        # (u << 1) mod 2^64 from 32-bit halves, xor the sign mask (0 or ~0)
        lo, hi = t & _M32, (t >> 32) & _M32
        shl = join_u32((lo << 1) & _M32, ((hi << 1) | (lo >> 31)) & _M32)
        return [numeric_stream(shl ^ (t >> 63))], b""
    sv = (t.view(torch.int8) if s.width == 1 else t).to(torch.int64)
    zz = (sv * 2) ^ (sv >> 63)
    return [numeric_stream(narrow_unsigned(zz, s.width))], b""


def _zigzag_dec(outs, header):
    s = outs[0]
    t = _require_numeric(s, "zigzag")
    if s.width == 8:
        # logical shift of the 64-bit pattern, xor the sign mask (0 or ~0)
        return [numeric_stream(((t >> 1) & ~_SIGN) ^ -(t & 1))]
    u = widen_unsigned(t)
    return [numeric_stream(narrow_unsigned((u >> 1) ^ -(u & 1), s.width))]


register_codec(
    CodecSpec(
        "zigzag",
        codec_id=4,
        encode=_zigzag_enc,
        decode=_zigzag_dec,
        doc="signed -> small-unsigned mapping ((x<<1) ^ (x>>w-1))",
        sig=CodecSig(
            inputs=(_NUM_PORT,),
            transfer=lambda atoms, params, n_out: [atoms[0]],
        ),
    )
)


# ----------------------------------------------------------------- transpose
def _transpose_enc(streams, params):
    s = streams[0]
    if s.stype not in (SType.STRUCT, SType.NUMERIC):
        raise ValueError("transpose wants struct/numeric input")
    mat, w = fixed_records(s)
    planes = ops.byteshuffle(mat)
    h = HeaderWriter().u8(int(s.stype)).varint(w).done()
    return [Stream(planes.reshape(-1), SType.SERIAL, 1)], h


def _transpose_dec(outs, header):
    r = HeaderReader(header)
    stype = SType(r.u8())
    w = r.varint()
    r.expect_end()
    expect_stream(outs[0], SType.SERIAL, 1, "transpose", "plane")
    planes = outs[0].raw()
    if w < 1 or planes.numel() % w:
        raise ValueError(f"transpose: {planes.numel()} plane bytes for width {w}")
    records = ops.byteunshuffle(planes.view(w, planes.numel() // w))
    return [rebuild_like(stype, w, records)]


register_codec(
    CodecSpec(
        "transpose",
        codec_id=5,
        encode=_transpose_enc,
        decode=_transpose_dec,
        doc="byte-plane shuffle (Blosc-style) (kernels K3, K4)",
        sig=CodecSig(
            inputs=(_BYTEPLANE_PORT,),
            transfer=lambda atoms, params, n_out: [(_SERIAL, 1)],
        ),
    )
)


# ----------------------------------------------------------- transpose_split
def _transpose_split_enc(streams, params):
    s = streams[0]
    if s.stype not in (SType.STRUCT, SType.NUMERIC):
        raise ValueError("transpose_split wants struct/numeric input")
    mat, w = fixed_records(s)
    planes = ops.byteshuffle(mat)  # (w, n): each row is one output, no copy
    h = HeaderWriter().u8(int(s.stype)).varint(w).done()
    return [Stream(planes[j], SType.SERIAL, 1) for j in range(w)], h


def _transpose_split_dec(outs, header):
    r = HeaderReader(header)
    stype = SType(r.u8())
    w = r.varint()
    r.expect_end()
    if w < 1 or len(outs) != w:
        raise ValueError(f"transpose_split: {len(outs)} planes for width {w}")
    for o in outs:
        expect_stream(o, SType.SERIAL, 1, "transpose_split", "plane")
    n = outs[0].data.numel()
    if any(o.data.numel() != n for o in outs):
        raise ValueError("transpose_split: planes of different lengths")
    # the planes arrive as separate tensors: one stack, then K4
    records = ops.byteunshuffle(torch.stack([o.raw() for o in outs]))
    return [rebuild_like(stype, w, records)]


register_codec(
    CodecSpec(
        "transpose_split",
        codec_id=22,
        encode=_transpose_split_enc,
        decode=_transpose_split_dec,
        n_outputs=-1,
        doc="byte planes as separate outputs, each to its own backend (kernels K3, K4)",
        sig=CodecSig(
            inputs=(_BYTEPLANE_PORT,),
            transfer=lambda atoms, params, n_out: (
                None
                if atoms[0][1] is not None and atoms[0][1] != n_out
                else [(_SERIAL, 1)] * n_out
            ),
        ),
    )
)


# ---------------------------------------------------------------- range_pack
def _pack_bits(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int64 values (< 2^bits) LSB-first into bytes.  bits <= 57 so a
    single unaligned 8-byte window always covers a value (see _unpack_bits).

    Each value touches at most ceil(bits/8)+1 bytes; each pass scatter-adds
    one of those byte contributions.  Every bit has one writer, so the adds
    never carry and equal the reference's bitwise OR.
    """
    if bits > 57:
        raise ValueError("bitpack supports <= 57 bits per value; store instead")
    n = vals.numel()
    nbytes = (n * bits + 7) // 8
    out = torch.zeros(nbytes + 8, dtype=torch.int64, device=vals.device)
    offs = torch.arange(n, dtype=torch.int64, device=vals.device) * bits
    base, r = offs >> 3, offs & 7
    for b in range((bits + 7) // 8 + 1):
        if b == 0:
            contrib = (vals & 0xFF) << r
        else:
            contrib = vals >> (8 * b - r).clamp(max=63)  # values < 2^57
        out.index_add_(0, base + b, contrib & 0xFF)
    return out[:nbytes].to(torch.uint8)


def _unpack_bits(buf: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Unpack n LSB-first values of ``bits`` <= 57 bits -> int64, on buf's device.

    A value starts at bit r < 8 of byte ``offs >> 3`` and ends below bit 64,
    so the eight bytes from there hold it.  They are gathered as two 32-bit
    halves; the high half contributes only the value's bits above 32 - r, so
    no intermediate leaves int64.
    """
    if bits > 57:
        raise ValueError(f"bit reader: {bits} bits per value (at most 57)")
    if buf.numel() < (n * bits + 7) // 8:
        raise ValueError("bit reader: packed payload shorter than its values")
    padded = torch.zeros(buf.numel() + 8, dtype=torch.uint8, device=buf.device)
    padded[: buf.numel()] = buf
    offs = torch.arange(n, dtype=torch.int64, device=buf.device) * bits
    byte0, r = offs >> 3, offs & 7
    half = [
        sum(padded[byte0 + 4 * h + k].to(torch.int64) << (8 * k) for k in range(4))
        for h in (0, 1)
    ]
    hi_bits = (bits - 32 + r).clamp(min=0)
    hi = (half[1] & ((1 << hi_bits) - 1)) << (32 - r)
    return ((half[0] >> r) | hi) & ((1 << bits) - 1)


def _range_pack_enc(streams, params):
    s = streams[0]
    u = widen_unsigned(_require_numeric(s, "range_pack"))
    n = u.numel()
    lo = _unsigned_min(u) if n else 0
    shifted = sub_u64(u, torch.full_like(u, lo))
    maxv = _unsigned_max(shifted)
    bits = max(maxv.bit_length(), 1)
    packed = _pack_bits(shifted, bits)
    h = HeaderWriter().u8(bits).u8(s.width).varint(n).varint(lo & ((1 << 64) - 1)).done()
    return [Stream(packed, SType.SERIAL, 1)], h


def _range_pack_dec(outs, header):
    r = HeaderReader(header)
    bits = r.u8()
    width = r.u8()
    n = r.varint()
    lo = r.varint()
    r.expect_end()
    if width not in (1, 2, 4, 8):
        raise ValueError(f"range_pack: numeric width {width}")
    expect_stream(outs[0], SType.SERIAL, 1, "range_pack", "packed")
    vals = _unpack_bits(outs[0].raw(), bits, n)
    if width == 8:  # (vals + lo) mod 2^64 in 32-bit halves
        low = (vals & _M32) + (lo & _M32)
        high = (vals >> 32) + ((lo >> 32) & _M32) + (low >> 32)
        return [numeric_stream(join_u32(low & _M32, high & _M32))]
    return [numeric_stream(narrow_unsigned(vals + (lo & ((1 << 8 * width) - 1)), width))]


register_codec(
    CodecSpec(
        "range_pack",
        codec_id=13,
        encode=_range_pack_enc,
        decode=_range_pack_dec,
        doc="bounded ints: subtract min then bitpack",
        sig=CodecSig(
            inputs=(_NUM_PORT,),
            transfer=lambda atoms, params, n_out: [(_SERIAL, 1)],
            packed_outputs=(0,),
        ),
    )
)


# ------------------------------------------------------------------- bitpack
# The fused codec takes its explicit ``bits`` from the widths K5, K6, K11 and
# K12 pack (``core.message.PACK_BITS``), the bits that divide 32.
FUSED_BITS_CHOICES = ref.PACK_BITS
# dynamic bit selection stops here: packing >16 bits per delta loses to
# running delta+bitpack separately (which adapts to the stream width)
_FUSED_DYNAMIC_MAX_BITS = 16


def _on_word_kernels(width: int, bits: int) -> bool:
    """The reference's device gate: a 1/2/4-byte stream at bits dividing 32."""
    return width in (1, 2, 4) and bits in FUSED_BITS_CHOICES


def _packed_bytes(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Packed words' little-endian bytes, cut to the bit writer's
    ceil(n * bits / 8): the same bytes, since no value straddles a word."""
    return words.view(torch.uint8)[: (n * bits + 7) // 8]


def _payload_words(buf: torch.Tensor, n: int, bits: int, op: str) -> torch.Tensor:
    """A packed payload as the int32 words K6 and K12 read, zero-padded to
    whole words; raises before any kernel reads a payload too short."""
    if buf.numel() < (n * bits + 7) // 8:
        raise ValueError(f"{op}: packed payload shorter than its values")
    m = -(-n // (32 // bits))
    if buf.numel() >= 4 * m and buf.storage_offset() % 4 == 0:
        return buf[: 4 * m].view(torch.int32)
    words = torch.zeros(m, dtype=torch.int32, device=buf.device)
    words.view(torch.uint8)[: buf.numel()] = buf[: 4 * m]
    return words


def _bitpack_enc(streams, params):
    s = streams[0]
    t = _require_numeric(s, "bitpack")
    n = t.numel()
    maxv = _unsigned_max(t)
    bits = int(params.get("bits", 0)) or max(maxv.bit_length(), 1)
    if maxv >= 1 << bits:
        raise ValueError(f"bitpack: values need more than {bits} bits")
    if _on_word_kernels(s.width, bits):
        packed = _packed_bytes(ops.bitpack(t, bits), n, bits)
    else:
        # bits that straddle words, or a 64-bit column: the codecs' bit writer
        # (shared with range_pack), a function K5 does not compute
        packed = _pack_bits(widen_unsigned(t), bits)
    h = HeaderWriter().u8(bits).u8(s.width).varint(n).done()
    return [Stream(packed, SType.SERIAL, 1)], h


def _bitpack_dec(outs, header):
    r = HeaderReader(header)
    bits = r.u8()
    width = r.u8()
    n = r.varint()
    r.expect_end()
    if width not in (1, 2, 4, 8):
        raise ValueError(f"bitpack: numeric width {width}")
    expect_stream(outs[0], SType.SERIAL, 1, "bitpack", "packed")
    buf = outs[0].raw()
    if _on_word_kernels(width, bits):
        words = _payload_words(buf, n, bits, "bitpack")
        return [numeric_stream(ops.bitunpack(words, bits, n, width))]
    # the bit reader for the widths K6 does not unpack
    return [numeric_stream(narrow_unsigned(_unpack_bits(buf, bits, n), width))]


register_codec(
    CodecSpec(
        "bitpack",
        codec_id=6,
        encode=_bitpack_enc,
        decode=_bitpack_dec,
        doc="pack values into ceil(log2(max+1)) bits, LSB-first (kernels K5, K6)",
        sig=CodecSig(
            inputs=(_NUM_PORT,),
            transfer=lambda atoms, params, n_out: [(_SERIAL, 1)],
            params=(ParamSpec("bits", "int", doc="explicit bits/value (0 = fit to max)"),),
            packed_outputs=(0,),
        ),
    )
)


# ------------------------------------------------------ fused delta+bitpack
# One pass instead of delta then bitpack.  Deltas are taken in the u32 domain
# of the column zero-extended to 32 bits: d[0] = x[0], d[i] = (x[i] - x[i-1])
# mod 2^32, packed at bits dividing 32, so the packed words' little-endian
# bytes equal the bit writer's stream.  The lowered ``delta`` codec wraps
# mod 2^(8w) instead: a decreasing u8 column refuses fusion (its u32 deltas
# wrap to ~2^32), while its lowered deltas still fit 8 bits.
def _bits_for_need(need: int, explicit_bits: int):
    """Packing width for a max-delta bit length, or None to refuse.

    Dynamic selection fuses only when the width is *exact* (need is itself a
    32-divisor <= 16): rounding 3 bits up to 4 would inflate the packed
    stream against separate delta+bitpack.  Explicit widths are the caller's
    ratio decision and are honoured as long as the kernel can express them.
    """
    if explicit_bits:
        if explicit_bits not in FUSED_BITS_CHOICES or need > explicit_bits:
            return None
        return explicit_bits
    if need in FUSED_BITS_CHOICES and need <= _FUSED_DYNAMIC_MAX_BITS:
        return need
    return None


def _as_u32(t: torch.Tensor) -> torch.Tensor:
    """A 1/2/4-byte carrier zero-extended to the int32 carrier of its u32 view."""
    if t.dtype == torch.int32:
        return t
    return (t.to(torch.int32) & 0xFFFF) if t.dtype == torch.int16 else t.to(torch.int32)


def _fused_bits(s: Stream, explicit_bits: int):
    """The fused codec's width for a numeric(1/2/4) stream, or None: the max
    u32 delta (K1 on the widened column, then an unsigned max) on the
    stream's device."""
    maxd = _unsigned_max(ops.delta_encode(_as_u32(s.data))) if s.data.numel() else 0
    return _bits_for_need(max(maxd.bit_length(), 1), explicit_bits)


def fused_bits_for(s: Stream, explicit_bits: int = 0):
    """Packing width if the fused kernel's lossless precondition holds.

    Returns None when the node must run as separate delta+bitpack: a
    non-numeric or u64 input, a wrapped u32 delta that does not fit, an
    explicit width the 32-bit-word kernel cannot express, or (dynamic case)
    a width where fusion stops paying for itself.
    """
    if s.stype != SType.NUMERIC or s.width not in (1, 2, 4):
        return None
    return _fused_bits(s, explicit_bits)


def _fused_enc(streams, params):
    s = streams[0]
    if s.stype != SType.NUMERIC or s.width not in (1, 2, 4):
        raise ValueError("fused_delta_bitpack: numeric(1/2/4) streams only")
    bits = _fused_bits(s, int(params.get("bits", 0)))
    if bits is None:
        raise ValueError(
            "fused_delta_bitpack: lossless precondition failed (delta too wide)"
        )
    n = s.data.numel()
    packed = _packed_bytes(ops.fused_delta_bitpack(s.data, bits), n, bits)
    h = HeaderWriter().u8(bits).u8(s.width).varint(n).done()
    return [Stream(packed, SType.SERIAL, 1)], h


def _fused_dec(outs, header):
    r = HeaderReader(header)
    bits = r.u8()
    width = r.u8()
    n = r.varint()
    r.expect_end()
    if width not in (1, 2, 4):
        raise ValueError("fused_delta_bitpack: numeric(1/2/4) streams only")
    expect_stream(outs[0], SType.SERIAL, 1, "fused_delta_bitpack", "packed")
    buf = outs[0].raw()
    if bits in FUSED_BITS_CHOICES:
        words = _payload_words(buf, n, bits, "fused_delta_bitpack")
        return [numeric_stream(ops.fused_delta_bitpack_decode(words, bits, n, width))]
    # the reference's decoder takes any bits: the bit reader, then K2 in u32
    d = narrow_unsigned(_unpack_bits(buf, bits, n), 4)
    return [numeric_stream(narrow_unsigned(widen_unsigned(ops.delta_decode(d)), width))]


register_codec(
    CodecSpec(
        "fused_delta_bitpack",
        codec_id=26,
        encode=_fused_enc,
        decode=_fused_dec,
        min_version=4,
        doc="single-pass delta+bitpack; u32-domain deltas (kernels K11, K12)",
        sig=CodecSig(
            inputs=(InPort(frozenset((_NUMERIC,)), frozenset((1, 2, 4))),),
            transfer=lambda atoms, params, n_out: [(_SERIAL, 1)],
            params=(ParamSpec("bits", "int", choices=FUSED_BITS_CHOICES,
                              doc="explicit packing width (0 = dynamic exact fit)"),),
            packed_outputs=(0,),
        ),
    )
)


# ----------------------------------------------------------------------- rle
def _rle_enc(streams, params):
    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("rle: fixed-width streams only")
    # runs of equal (n, w) byte records, whatever the stream type
    mat, _w = fixed_records(s)
    n = mat.shape[0]
    dev = mat.device
    if n == 0:
        starts = torch.zeros(0, dtype=torch.int64, device=dev)
    else:
        change = (mat[1:] != mat[:-1]).any(1)
        starts = torch.cat([
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.nonzero(change).reshape(-1) + 1,
        ])
    runs = torch.diff(starts, append=torch.full((1,), n, dtype=torch.int64, device=dev))
    values = rebuild_like(s.stype, s.width, mat[starts].reshape(-1))
    h = HeaderWriter().u8(int(s.stype)).varint(s.width).done()
    return [values, numeric_stream(narrow_unsigned(runs, 4))], h


def _rle_dec(outs, header):
    values, runs = outs
    r = HeaderReader(header)
    stype = SType(r.u8())
    width = r.varint()
    r.expect_end()
    w = width if stype != SType.SERIAL else 1
    expect_stream(values, stype, width, "rle", "value")
    expect_stream(runs, SType.NUMERIC, 4, "rle", "run")
    raw = values.raw()
    if w < 1 or raw.numel() % w:
        raise ValueError(f"rle: {raw.numel()} value bytes for width {w}")
    mat = raw.view(-1, w)
    reps = widen_unsigned(runs.data)
    if reps.numel() != mat.shape[0]:
        raise ValueError(f"rle: {reps.numel()} runs for {mat.shape[0]} values")
    total = int(reps.sum()) if reps.numel() else 0  # one scalar sync
    rep = torch.repeat_interleave(mat, reps, dim=0, output_size=total)
    return [rebuild_like(stype, width, rep)]


register_codec(
    CodecSpec(
        "rle",
        codec_id=7,
        encode=_rle_enc,
        decode=_rle_dec,
        n_outputs=2,
        doc="run-length: (values, u32 run lengths)",
        sig=CodecSig(
            inputs=(InPort(FIXED_STYPES),),
            transfer=lambda atoms, params, n_out: [atoms[0], (_NUMERIC, 4)],
            expansion=5.0,  # worst case: no runs -> values + 4B/element
        ),
    )
)


# ------------------------------------------------------------------ tokenize
def _tokenize_strings(s: Stream):
    """The host dictionary of a STRING stream: its distinct strings in
    first-occurrence order (equality on the whole byte string) and each
    string's u32 index, both back on the stream's device."""
    items = s.to_strings()  # one card-to-host copy of the content
    seen: dict = {}
    # a new string gets the dictionary's size before it joins: its rank
    idx = np.fromiter((seen.setdefault(it, len(seen)) for it in items), np.int64, len(items))
    alphabet = strings(seen).to(s.device)
    # indices are ALWAYS u32 (see the fixed-width path)
    indices = numeric_stream(torch.from_numpy(idx.astype(np.uint32).view(np.int32)).to(s.device))
    return alphabet, indices


def _tokenize_enc(streams, params):
    s = streams[0]
    if s.stype == SType.STRING:
        alphabet, indices = _tokenize_strings(s)
        return [alphabet, indices], HeaderWriter().u8(1).u8(4).done()
    mat, w = fixed_records(s)
    n = mat.shape[0]
    dev = mat.device
    if n == 0:
        alphabet = rebuild_like(s.stype, s.width, mat.reshape(-1))
        indices = numeric_stream(torch.zeros(0, dtype=torch.int32, device=dev))
    else:
        if w <= 8:  # one int64 key per record: a 1-D unique
            key = torch.zeros((n, 8), dtype=torch.uint8, device=dev)
            key[:, :w] = mat
            _, inv = torch.unique(key.view(torch.int64).reshape(-1), return_inverse=True)
        else:
            _, inv = torch.unique(mat, dim=0, return_inverse=True)
        k = int(inv.max()) + 1
        pos = torch.arange(n, dtype=torch.int64, device=dev)
        first = torch.full((k,), n, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, inv, pos, reduce="amin")
        # first-occurrence ordering keeps the alphabet stable for delta-friendly ids
        order = torch.argsort(first)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(k, dtype=torch.int64, device=dev)
        alphabet = rebuild_like(s.stype, s.width, mat[first[order]].reshape(-1))
        # indices are ALWAYS u32: predictable output types keep the graph
        # type system static (downstream range_pack reclaims the bits)
        indices = numeric_stream(narrow_unsigned(rank[inv], 4))
    h = HeaderWriter().u8(0).u8(4).done()
    return [alphabet, indices], h


def _tokenize_dec(outs, header):
    alphabet, indices = outs
    r = HeaderReader(header)
    is_string = r.u8()
    _iw = r.u8()
    r.expect_end()
    expect_stream(indices, SType.NUMERIC, 4, "tokenize", "index")
    idx = widen_unsigned(indices.data)
    if is_string:
        return [_untokenize_strings(alphabet, idx)]
    mat, _w = fixed_records(alphabet)
    if idx.numel() and int(idx.max()) >= mat.shape[0]:  # one scalar sync, fail closed
        raise ValueError("tokenize: an index lies past the alphabet")
    return [rebuild_like(alphabet.stype, alphabet.width, mat[idx])]


def _untokenize_strings(alphabet: Stream, idx: torch.Tensor) -> Stream:
    """Gather each index's string from a STRING alphabet on its device; the
    lengths come from ``alphabet.lengths[idx]`` on the host."""
    if alphabet.stype != SType.STRING:
        raise ValueError("tokenize: a string header over a fixed-width alphabet")
    a_lens = alphabet.lengths
    idx_host = idx.cpu().numpy()  # one card-to-host copy of the indices
    if idx_host.size and int(idx_host.max()) >= a_lens.size:  # fail closed
        raise ValueError("tokenize: an index lies past the alphabet")
    lengths = a_lens[idx_host].astype(np.uint32)
    dev = alphabet.data.device
    a_off = torch.from_numpy(np.cumsum(a_lens, dtype=np.int64) - a_lens).to(dev)
    out_lens = torch.from_numpy(lengths.astype(np.int64)).to(dev)
    total = int(lengths.sum(dtype=np.int64))
    # byte p of output string i comes from a_off[idx[i]] + (p - out_off[i])
    shift = a_off[idx] - (torch.cumsum(out_lens, 0) - out_lens)
    pos = torch.arange(total, dtype=torch.int64, device=dev) + torch.repeat_interleave(
        shift, out_lens, output_size=total)
    return Stream(alphabet.data[pos], SType.STRING, 1, lengths)


register_codec(
    CodecSpec(
        "tokenize",
        codec_id=9,
        encode=_tokenize_enc,
        decode=_tokenize_dec,
        n_outputs=2,
        min_version=2,
        doc="(alphabet, indices) split",
        sig=CodecSig(
            inputs=(InPort(ANY_STYPES),),
            transfer=lambda atoms, params, n_out: [atoms[0], (_NUMERIC, 4)],
            expansion=5.0,  # worst case: all-unique u8 -> alphabet + 4B indices
        ),
    )
)
