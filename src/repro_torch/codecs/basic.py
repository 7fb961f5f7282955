"""Structural codecs: store, dup, constant, split_n, concat, field_split,
string_split.

The port's copy of ``repro.codecs.basic``: the same codec ids, headers and
output streams.  They carry no compression of their own; they route data
through the graph (paper §III-C, §IV "grouping").  Every one is a tensor op
on the device its input lies on: views where the reference slices, one
``torch.cat`` where it concatenates, one contiguous copy per record field.
A STRING stream's lengths stay a host array, as ``core.message`` keeps them.
"""
from __future__ import annotations

from typing import List

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
from ..core.message import Stream, SType
from ._util import HeaderReader, HeaderWriter, expect_stream, fixed_records, rebuild_like

_NO_LENGTHS = np.zeros(0, np.uint32)
_SERIAL = int(SType.SERIAL)
_STRUCT = int(SType.STRUCT)
_NUMERIC = int(SType.NUMERIC)
_STRING = int(SType.STRING)


# --------------------------------------------------------------------- store
def _store_enc(streams, params):
    return [streams[0]], b""


def _store_dec(outs, header):
    return [outs[0]]


register_codec(
    CodecSpec(
        "store",
        codec_id=1,
        encode=_store_enc,
        decode=_store_dec,
        doc="identity; terminal passthrough",
        sig=CodecSig(
            inputs=(InPort(ANY_STYPES),),
            transfer=lambda atoms, params, n_out: [atoms[0]],
        ),
    )
)


# ----------------------------------------------------------------------- dup
def _dup_enc(streams, params):
    s = streams[0]
    return [s, Stream(s.data.clone(), s.stype, s.width, s.lengths)], b""


def _dup_dec(outs, header):
    expect_stream(outs[1], outs[0].stype, outs[0].width, "dup", "copy")
    return [outs[0]]


register_codec(
    CodecSpec(
        "dup",
        codec_id=2,
        encode=_dup_enc,
        decode=_dup_dec,
        n_outputs=2,
        doc="explicit fan-out: one input, two identical outputs",
        sig=CodecSig(
            inputs=(InPort(ANY_STYPES),),
            transfer=lambda atoms, params, n_out: [atoms[0], atoms[0]],
            expansion=2.0,
        ),
    )
)


# ------------------------------------------------------------------ constant
def _constant_enc(streams, params):
    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("constant codec: fixed-width streams only")
    rec, _w = fixed_records(s)
    n = s.n_elts
    if n == 0:
        value = b""
    else:
        if not bool((rec == rec[0]).all()):  # one scalar sync
            raise ValueError("constant codec: stream is not constant")
        value = rec[0].cpu().numpy().tobytes()
    h = (
        HeaderWriter()
        .u8(int(s.stype))
        .varint(s.width)
        .varint(n)
        .bytes_(value)
        .done()
    )
    return [], h


def _constant_dec(outs, header, device):
    r = HeaderReader(header)
    stype = SType(r.u8())
    w = r.varint()
    n = r.varint()
    value = r.bytes_()
    r.expect_end()
    if stype == SType.STRING:
        raise ValueError("constant codec: fixed-width streams only")
    # the value expanded on the decode device: no n-record host payload
    v = torch.tensor(list(value), dtype=torch.uint8, device=device)
    return [rebuild_like(stype, w, v.repeat(n))]


register_codec(
    CodecSpec(
        "constant",
        codec_id=8,
        encode=_constant_enc,
        decode=_constant_dec,
        n_outputs=0,
        wants_device=True,
        doc="all-equal stream -> header only (value + count); zero outputs",
        sig=CodecSig(
            inputs=(InPort(FIXED_STYPES),),
            transfer=lambda atoms, params, n_out: [],
        ),
    )
)


# ------------------------------------------------------------------- split_n
def _datum_per_elt(s: Stream) -> int:
    """Elements of ``data`` per logical element (STRUCT records are bytes)."""
    return s.width if s.stype == SType.STRUCT else 1


def _split_n_enc(streams, params):
    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("split_n: fixed-width streams only")
    sizes = list(params["sizes"])  # element counts per chunk; -1 => rest (last)
    n = s.n_elts
    if sizes and sizes[-1] == -1:
        sizes[-1] = n - sum(sizes[:-1])
    if sum(sizes) != n or any(sz < 0 for sz in sizes):
        raise ValueError(f"split_n sizes {sizes} != {n} elements")
    per = _datum_per_elt(s)
    outs: List[Stream] = []
    off = 0
    for sz in sizes:  # views of the input's tensor
        outs.append(Stream(s.data[off * per : (off + sz) * per], s.stype, s.width))
        off += sz
    return outs, HeaderWriter().varint(len(sizes)).done()


def _split_n_dec(outs, header):
    r = HeaderReader(header)
    k = r.varint()
    r.expect_end()
    if len(outs) != k or k == 0:
        raise ValueError("split_n: wrong output count")
    s0 = outs[0]
    for o in outs[1:]:
        expect_stream(o, s0.stype, s0.width, "split_n", "chunk")
    return [Stream(torch.cat([o.data for o in outs]), s0.stype, s0.width)]


register_codec(
    CodecSpec(
        "split_n",
        codec_id=11,
        encode=_split_n_enc,
        decode=_split_n_dec,
        n_outputs=-1,
        doc="split a stream into contiguous chunks (params: sizes=[...])",
        sig=CodecSig(
            inputs=(InPort(FIXED_STYPES),),
            transfer=lambda atoms, params, n_out: (
                None
                if "sizes" in params and len(params["sizes"]) != n_out
                else [atoms[0]] * n_out
            ),
            params=(ParamSpec("sizes", "int_list", required=True,
                              doc="element counts per chunk; -1 => rest (last)"),),
        ),
    )
)


# -------------------------------------------------------------------- concat
def _concat_enc(streams, params):
    if not streams:
        raise ValueError("concat: needs >=1 input")
    s0 = streams[0]
    for s in streams:
        if s.stype != s0.stype or s.width != s0.width:
            raise ValueError("concat: mixed stream types")
    h = HeaderWriter().varint(len(streams))
    content = torch.cat([s.data for s in streams])
    if s0.stype == SType.STRING:
        lens = [s.lengths if s.lengths is not None else _NO_LENGTHS for s in streams]
        for ln in lens:
            h.varint(int(ln.size))
        out = Stream(content, SType.STRING, 1, np.concatenate(lens).astype(np.uint32))
    else:
        # NUMERIC carriers are bit patterns of one width: no promotion arises
        for s in streams:
            h.varint(int(s.data.numel()))
        out = Stream(content, s0.stype, s0.width)
    return [out], h.done()


def _concat_dec(outs, header):
    s = outs[0]
    r = HeaderReader(header)
    k = r.varint()
    sizes = [r.varint() for _ in range(k)]
    r.expect_end()
    res: List[Stream] = []
    off = 0
    if s.stype == SType.STRING:
        off_s = 0
        for sz in sizes:
            lens = s.lengths[off_s : off_s + sz]
            nb = int(lens.sum())
            res.append(Stream(s.data[off : off + nb], SType.STRING, 1, lens))
            off_s += sz
            off += nb
    else:
        for sz in sizes:
            res.append(Stream(s.data[off : off + sz], s.stype, s.width))
            off += sz
    return res


def _concat_transfer(atoms, params, n_out):
    # every input must share one (stype, width); unknowns stay compatible
    stypes = {st for st, _ in atoms if st is not None}
    widths = {w for _, w in atoms if w is not None}
    if len(stypes) > 1 or len(widths) > 1:
        return None
    st = next(iter(stypes)) if stypes else None
    w = next(iter(widths)) if widths else None
    return [(st, w)]


register_codec(
    CodecSpec(
        "concat",
        codec_id=12,
        encode=_concat_enc,
        decode=_concat_dec,
        n_inputs=-1,
        n_outputs=1,
        doc="merge same-typed streams (the paper's cluster 'grouping' step)",
        sig=CodecSig(
            inputs=(InPort(ANY_STYPES),),
            transfer=_concat_transfer,
        ),
    )
)


# --------------------------------------------------------------- field_split
def _field_split_transfer(atoms, params, n_out):
    st, w = atoms[0]
    widths = params.get("widths")
    if widths is None:
        # params unknown (e.g. inferring from a wire frame): columns are
        # struct-or-serial of unknown width
        return [(None, None)] * n_out
    widths = list(widths)
    if len(widths) != n_out or any(x < 1 for x in widths):
        return None
    if st == _STRUCT and w is not None and sum(widths) != w:
        return None  # field widths must tile the record exactly
    return [(_STRUCT, x) if x > 1 else (_SERIAL, 1) for x in widths]


def _field_split_enc(streams, params):
    s = streams[0]
    widths = list(params["widths"])
    if s.stype not in (SType.STRUCT, SType.SERIAL):
        raise ValueError("field_split wants struct/serial input")
    rec_w = s.width if s.stype == SType.STRUCT else int(sum(widths))
    if sum(widths) != rec_w:
        raise ValueError(f"field widths {widths} != record width {rec_w}")
    if rec_w < 1 or any(w < 0 for w in widths):
        raise ValueError(f"field widths {widths}: empty record")
    raw = s.data
    if raw.numel() % rec_w:
        raise ValueError("input not a whole number of records")
    mat = raw.view(-1, rec_w)
    outs: List[Stream] = []
    off = 0
    for w in widths:
        # a fresh contiguous copy, whatever the offset of the input's view
        col = torch.empty((mat.shape[0], w), dtype=torch.uint8, device=raw.device)
        col.copy_(mat[:, off : off + w])
        outs.append(Stream(col.reshape(-1), SType.STRUCT if w > 1 else SType.SERIAL, max(w, 1)))
        off += w
    h = HeaderWriter().u8(int(s.stype)).varint(rec_w).varint(len(widths))
    for w in widths:
        h.varint(w)
    return outs, h.done()


def _field_split_dec(outs, header):
    r = HeaderReader(header)
    stype = SType(r.u8())
    rec_w = r.varint()
    k = r.varint()
    widths = [r.varint() for _ in range(k)]
    r.expect_end()
    if len(outs) != k or k == 0 or widths[0] < 1 or sum(widths) != rec_w:
        raise ValueError("field_split: header does not match its columns")
    n = outs[0].data.numel() // widths[0]
    cols = []
    for w, o in zip(widths, outs):
        expect_stream(o, SType.STRUCT if w > 1 else SType.SERIAL, max(w, 1), "field_split", "column")
        if o.data.numel() != n * w:
            raise ValueError(f"field_split: a column of {o.data.numel()} bytes for {n} x {w}")
        cols.append(o.data.view(n, w))
    mat = torch.cat(cols, dim=1)  # one (n, rec_w) tensor on the device
    return [Stream(mat.reshape(-1), stype, rec_w if stype == SType.STRUCT else 1)]


register_codec(
    CodecSpec(
        "field_split",
        codec_id=10,
        encode=_field_split_enc,
        decode=_field_split_dec,
        n_outputs=-1,
        doc="record frontend: struct(k) -> per-field columns (params: widths=[...])",
        sig=CodecSig(
            inputs=(InPort(frozenset((_STRUCT, _SERIAL))),),
            transfer=_field_split_transfer,
            params=(ParamSpec("widths", "int_list", required=True,
                              doc="byte widths per field; must sum to the record width"),),
        ),
    )
)


# -------------------------------------------------------------- string_split
def _string_split_enc(streams, params):
    s = streams[0]
    if s.stype != SType.STRING:
        raise ValueError("string_split wants a string stream")
    content = Stream(s.data, SType.SERIAL, 1)
    lens = s.lengths.astype(np.uint32).view(np.int32)
    # the lengths as a NUMERIC u32 stream beside the content: one host-to-card copy
    lens_t = torch.from_numpy(lens).to(s.data.device)
    return [content, Stream(lens_t, SType.NUMERIC, 4)], b""


def _string_split_dec(outs, header):
    content, lens = outs
    expect_stream(content, SType.SERIAL, 1, "string_split", "content")
    expect_stream(lens, SType.NUMERIC, 4, "string_split", "length")
    # one card-to-host copy of the lengths
    lengths = lens.numpy().astype(np.uint32)
    return [Stream(content.data, SType.STRING, 1, lengths)]


register_codec(
    CodecSpec(
        "string_split",
        codec_id=21,
        encode=_string_split_enc,
        decode=_string_split_dec,
        n_outputs=2,
        doc="string -> (content bytes, u32 lengths) so each can be compressed",
        sig=CodecSig(
            inputs=(InPort(frozenset((_STRING,))),),
            transfer=lambda atoms, params, n_out: [(_SERIAL, 1), (_NUMERIC, 4)],
            expansion=2.0,  # 4 length bytes per (possibly empty) string
        ),
    )
)
