"""Shared helpers for codec implementations: header packing, stream views.

The port's copy of ``repro.codecs._util``'s header reader and writer.
Stream payloads are tensors, so the helpers that build or view streams work
on tensors and keep them on their device; decoders build their results on
the device their inputs lie on.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.message import CARRIER, Stream, SType
from ..core.wire import read_varint, write_varint


class HeaderWriter:
    def __init__(self):
        self.buf = bytearray()

    def u8(self, v: int) -> "HeaderWriter":
        self.buf.append(v & 0xFF)
        return self

    def varint(self, v: int) -> "HeaderWriter":
        write_varint(self.buf, int(v))
        return self

    def bytes_(self, b: bytes) -> "HeaderWriter":
        self.varint(len(b))
        self.buf += b
        return self

    def done(self) -> bytes:
        return bytes(self.buf)


class HeaderReader:
    def __init__(self, header: bytes):
        self.buf = header
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def varint(self) -> int:
        v, self.pos = read_varint(self.buf, self.pos)
        return v

    def bytes_(self) -> bytes:
        n = self.varint()
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def expect_end(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError("trailing bytes in codec header")


def expect_stream(s: Stream, stype: SType, width: int, op: str, what: str) -> None:
    """Fail closed unless ``s`` has the type and width its encoder writes.

    A frame carries each stored stream's type tag; a decoder that read a
    retagged stream as bytes would rebuild the input from the wrong layout.
    """
    if s.stype != stype or s.width != width:
        raise ValueError(
            f"{op}: the {what} stream is {s.stype.name.lower()}({s.width}),"
            f" not {stype.name.lower()}({width})"
        )


def numeric_stream(t: torch.Tensor) -> Stream:
    """Wrap a 1-D carrier tensor (uint8/int16/int32/int64) as a NUMERIC stream."""
    return Stream(t.reshape(-1).contiguous(), SType.NUMERIC, t.element_size())


def fixed_records(s: Stream) -> Tuple[torch.Tensor, int]:
    """View a fixed-width stream (SERIAL/STRUCT/NUMERIC) as (n, width) uint8."""
    if s.stype == SType.STRING:
        raise ValueError("fixed_records on string stream")
    w = s.width if s.stype != SType.SERIAL else 1
    return s.raw().view(-1, w), w


def rebuild_like(template_stype: SType, width: int, raw: torch.Tensor) -> Stream:
    """Rebuild a stream of (stype, width) from raw little-endian uint8 bytes,
    on the device ``raw`` lies on."""
    raw = raw.reshape(-1).contiguous()
    if template_stype == SType.NUMERIC:
        if width not in CARRIER or raw.numel() % width:
            raise ValueError(f"numeric({width}) payload of {raw.numel()} bytes")
        return Stream(raw.view(CARRIER[width]), template_stype, width).validate()
    return Stream(raw, template_stype, width).validate()
