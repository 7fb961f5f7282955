"""The self-describing wire format — the port's copy of ``repro.core.wire``.

Frame layout (all varints LEB128, little-endian payloads):

    magic   b"OZLJ"
    u8      format_version
    varint  n_graph_inputs
    varint  n_nodes
    per node:
        varint codec_id
        varint n_inputs, then n_inputs × varint input-edge-id
        varint n_outputs                  (output ids are implied sequentially)
        varint header_len, header bytes
    varint  n_stored
    per stored stream:
        varint edge_id
        u8     type tag (SType)
        varint elt width
        [STRING only] varint n_strings, n_strings × varint byte-length
        varint payload byte length, payload
    u32     crc32 of everything above

Frames are byte-identical to the reference's.  This is where a stream's
payload crosses between host and device: ``write_frame`` copies each stored
stream to the host once, and ``read_frame`` parses a frame on the host and
copies each stored payload to the decode device once.  Multi-chunk
containers (``OZLC``) are not part of this slice.
"""
from __future__ import annotations

import struct as _struct
import zlib
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from .message import Stream, SType, from_wire

MAGIC = b"OZLJ"

__all__ = ["MAGIC", "FrameError", "write_varint", "read_varint", "write_frame", "read_frame"]


class FrameError(ValueError):
    pass


# ------------------------------------------------------------------ varints
def write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        raise ValueError("varint must be non-negative")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise FrameError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise FrameError("varint overflow")


# ------------------------------------------------------------------- frames
def write_frame(
    version: int,
    n_inputs: int,
    nodes: Sequence,  # Sequence[ResolvedNode]
    stored: Sequence[Tuple[int, Stream]],
) -> bytes:
    out = bytearray()
    out += MAGIC
    out.append(version & 0xFF)
    write_varint(out, n_inputs)
    write_varint(out, len(nodes))
    for node in nodes:
        write_varint(out, node.codec_id)
        write_varint(out, len(node.inputs))
        for e in node.inputs:
            write_varint(out, e)
        write_varint(out, node.n_out)
        write_varint(out, len(node.header))
        out += node.header
    write_varint(out, len(stored))
    for eid, s in stored:
        write_varint(out, eid)
        out.append(int(s.stype))
        write_varint(out, s.width)
        if s.stype == SType.STRING:
            lens = s.lengths if s.lengths is not None else np.zeros(0, np.uint32)
            write_varint(out, int(lens.size))
            for ln in lens.tolist():
                write_varint(out, int(ln))
        payload = s.content_bytes()
        write_varint(out, len(payload))
        out += payload
    out += _struct.pack("<I", zlib.crc32(bytes(out)) & 0xFFFFFFFF)
    return bytes(out)


def read_frame(frame: bytes, device: Union[str, torch.device] = "cpu"):
    """Parse a frame -> (version, n_inputs, [ResolvedNode], {edge_id: Stream}).

    The headers are parsed on the host; each stored stream's payload is
    copied from the frame to ``device`` once.
    """
    from .engine import ResolvedNode  # local import to avoid cycle

    if len(frame) < 9 or frame[:4] != MAGIC:
        raise FrameError("bad magic")
    body, crc_bytes = frame[:-4], frame[-4:]
    (crc_expect,) = _struct.unpack("<I", crc_bytes)
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc_expect:
        raise FrameError("checksum mismatch")
    pos = 4
    version = frame[pos]
    pos += 1
    n_inputs, pos = read_varint(frame, pos)
    n_nodes, pos = read_varint(frame, pos)
    if n_nodes > 1_000_000:
        raise FrameError("implausible node count")
    nodes: List[ResolvedNode] = []
    for _ in range(n_nodes):
        codec_id, pos = read_varint(frame, pos)
        n_in, pos = read_varint(frame, pos)
        ins = []
        for _ in range(n_in):
            e, pos = read_varint(frame, pos)
            ins.append(e)
        n_out, pos = read_varint(frame, pos)
        hlen, pos = read_varint(frame, pos)
        if pos + hlen > len(body):
            raise FrameError("truncated node header")
        header = frame[pos : pos + hlen]
        pos += hlen
        nodes.append(ResolvedNode(codec_id, tuple(ins), n_out, header))
    n_stored, pos = read_varint(frame, pos)
    stored: Dict[int, Stream] = {}
    for _ in range(n_stored):
        eid, pos = read_varint(frame, pos)
        if pos >= len(body):
            raise FrameError("truncated stream entry")
        stype = SType(frame[pos])
        pos += 1
        width, pos = read_varint(frame, pos)
        lengths = None
        if stype == SType.STRING:
            n_str, pos = read_varint(frame, pos)
            lens = np.empty(n_str, dtype=np.uint32)
            for i in range(n_str):
                ln, pos = read_varint(frame, pos)
                lens[i] = ln
            lengths = lens
        plen, pos = read_varint(frame, pos)
        if pos + plen > len(body):
            raise FrameError("truncated stream payload")
        payload = memoryview(frame)[pos : pos + plen]
        pos += plen
        if eid in stored:
            raise FrameError(f"edge {eid} stored twice")
        stored[eid] = from_wire(stype, width, payload, lengths, device)
    if pos != len(body):
        raise FrameError("trailing garbage in frame")
    return version, n_inputs, nodes, stored
