"""Type conversions between message kinds — the port's copy of
``repro.codecs.convert``: ``interpret_numeric`` (codec 23), which reads a
fixed-width stream's bytes as host-endian numeric(w).

On the device it is a view: the bytes stay where they lie.  A chunk view
that starts at a byte offset the new element size does not divide cannot be
viewed as that dtype, so it is first cloned on its device (never copied to
the host).
"""
from __future__ import annotations

import torch

from ..core.codec import FIXED_STYPES, CodecSig, CodecSpec, InPort, ParamSpec, register_codec
from ..core.message import CARRIER, Stream, SType
from ._util import HeaderReader, HeaderWriter, rebuild_like


def _aligned(raw: torch.Tensor, width: int) -> torch.Tensor:
    """``raw`` (uint8) itself where ``view`` can reinterpret it at ``width``
    bytes, else its clone on the same device."""
    return raw.clone() if raw.storage_offset() % width else raw


def _interpret_numeric_transfer(atoms, params, n_out):
    st, w = atoms[0]
    want = params.get("width")
    if want is None:
        # default: reinterpret at the stream's own width (1 for serial)
        if st == int(SType.SERIAL):
            want = 1
        elif w is not None:
            want = w
        else:
            return [(int(SType.NUMERIC), None)]
    if int(want) not in CARRIER:
        return None
    return [(int(SType.NUMERIC), int(want))]


def _interpret_numeric_enc(streams, params):
    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("interpret_numeric: fixed-width streams only")
    w = int(params.get("width", s.width if s.stype != SType.SERIAL else 1))
    if w not in CARRIER:
        raise ValueError(f"interpret_numeric: width {w} not in 1/2/4/8")
    raw = s.raw()
    if raw.numel() % w:
        raise ValueError("interpret_numeric: size not divisible by width")
    out = Stream(_aligned(raw, w).view(CARRIER[w]), SType.NUMERIC, w)
    h = HeaderWriter().u8(int(s.stype)).varint(s.width).done()
    return [out], h


def _interpret_numeric_dec(outs, header):
    r = HeaderReader(header)
    stype = SType(r.u8())
    width = r.varint()
    r.expect_end()
    if outs[0].stype != SType.NUMERIC:
        raise ValueError("interpret_numeric: the value stream is not numeric")
    raw = outs[0].raw()
    if stype == SType.NUMERIC and width in CARRIER:
        raw = _aligned(raw, width)
    return [rebuild_like(stype, width, raw)]


register_codec(
    CodecSpec(
        "interpret_numeric",
        codec_id=23,
        encode=_interpret_numeric_enc,
        decode=_interpret_numeric_dec,
        doc="reinterpret struct/serial bytes as host-endian numeric(w)",
        sig=CodecSig(
            inputs=(InPort(FIXED_STYPES),),
            transfer=_interpret_numeric_transfer,
            params=(ParamSpec("width", "int", choices=(1, 2, 4, 8),
                              doc="target numeric width (default: stream width)"),),
        ),
    )
)
