"""``zlib_backend``, the DEFLATE leaf of the level-5 trial menus.

The port's copy of ``repro.codecs.lz``'s zlib backend.  zlib is a host
library, so this codec copies its input to the host, and returns the
compressed bytes on the input's device like every other codec; its decoder
likewise inflates on the host and returns the stream on its input's device.
It is the one decoder that leaves the device.  The LZ77
coder and the lzma/bz2 leaves are not in this slice.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from ..core.codec import CodecSpec, register_codec
from ..core.message import Stream, SType, from_wire
from ._util import HeaderReader, HeaderWriter


def _zlib_enc(streams, params):
    s = streams[0]
    if s.stype == SType.STRING:
        raise ValueError("zlib_backend: fixed-width streams only (string_split first)")
    level = int(params.get("level", 6))
    payload = zlib.compress(s.content_bytes(), level)
    out = torch.from_numpy(np.frombuffer(bytearray(payload), dtype=np.uint8))
    h = HeaderWriter().u8(int(s.stype)).varint(s.width).done()
    return [Stream(out.to(s.device), SType.SERIAL, 1)], h


def _zlib_dec(outs, header):
    r = HeaderReader(header)
    stype = SType(r.u8())
    width = r.varint()
    r.expect_end()
    payload = zlib.decompress(outs[0].content_bytes())
    return [from_wire(stype, width, payload, None, outs[0].device)]


register_codec(
    CodecSpec(
        "zlib_backend",
        codec_id=17,
        encode=_zlib_enc,
        decode=_zlib_dec,
        min_version=3,
        doc="stdlib DEFLATE leaf",
    )
)
