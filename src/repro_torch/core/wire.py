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

Multi-chunk container record (format version >= 4), written by
``compress(..., chunk_bytes=N)`` around independently compressed chunks of
one input:

    magic   b"OZLC"
    u8      format_version
    varint  n_chunks
    per chunk: varint frame_len, one ``OZLJ`` frame
    u32     crc32 of everything above

Frames and containers are byte-identical to the reference's.  This is where
a stream's payload crosses between host and device: ``write_frame`` copies
each stored stream to the host once, and ``read_frame`` parses a frame on
the host and copies each stored payload to the decode device once.

A container whose chunk count is unknown when it starts (a pipe) reserves
a padded count and backpatches it (``ContainerWriter(out, version, None)``).
Not yet ported: the salvage scanner, which raises ``NotImplementedError``.
"""
from __future__ import annotations

import io
import struct as _struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .message import Stream, SType, from_wire

MAGIC = b"OZLJ"
CONTAINER_MAGIC = b"OZLC"
MAX_CHUNKS = 1_000_000

__all__ = [
    "MAGIC",
    "CONTAINER_MAGIC",
    "FrameError",
    "write_varint",
    "read_varint",
    "write_varints",
    "read_string_lengths",
    "write_frame",
    "read_frame",
    "is_container",
    "ContainerWriter",
    "write_container",
    "iter_container_frames",
    "read_container",
]


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


def read_stream_varint(reader) -> Tuple[int, bytes]:
    """Read one varint from a file-like object -> (value, raw bytes consumed)."""
    result = 0
    shift = 0
    raw = bytearray()
    while True:
        b = reader.read(1)
        if not b:
            raise FrameError("truncated varint")
        raw += b
        result |= (b[0] & 0x7F) << shift
        if not (b[0] & 0x80):
            return result, bytes(raw)
        shift += 7
        if shift > 63:
            raise FrameError("varint overflow")


_VARINT_MAX_BYTES = 10  # read_varint refuses a continuation past 63 bits


def write_varints(values: np.ndarray) -> bytes:
    """The LEB128 varints of non-negative integers, back to back, as
    ``write_varint`` writes them one at a time (vectorised with numpy: each
    byte past the first is computed only for the varints that reach it)."""
    v = np.asarray(values)
    if v.size and v.dtype.kind == "i" and int(v.min()) < 0:
        raise ValueError("varint must be non-negative")
    v = v.astype(np.uint64)
    nb = np.ones(v.size, np.int64)  # bytes per varint
    longer = np.flatnonzero(v >> np.uint64(7))
    for k in range(1, _VARINT_MAX_BYTES):
        longer = longer[(v[longer] >> np.uint64(7 * k)) != 0]
        nb[longer] += 1
    starts = np.cumsum(nb) - nb
    out = np.empty(int(nb.sum()), np.uint8)
    out[starts] = (v & np.uint64(0x7F)) | (np.uint64(0x80) * (nb > 1))
    idx = np.flatnonzero(nb > 1)
    for k in range(1, _VARINT_MAX_BYTES):
        if not idx.size:
            break
        byte = (v[idx] >> np.uint64(7 * k)) & np.uint64(0x7F)
        out[starts[idx] + k] = byte | (np.uint64(0x80) * (nb[idx] > k + 1))
        idx = idx[nb[idx] > k + 1]
    return out.tobytes()


def read_string_lengths(buf, pos: int, end: int, n: int) -> Tuple[np.ndarray, int]:
    """Read ``n`` varint string lengths from ``buf[pos:end]`` -> (uint32
    lengths, position after them), vectorised with numpy.

    Fails closed with :class:`FrameError`: fewer than ``n`` varints before
    ``end`` (truncated), one of more than ten bytes (overflow), or a length
    past uint32.
    """
    rem = end - pos
    if n > rem:  # every varint takes at least one byte
        raise FrameError("truncated varint")
    if n == 0:
        return np.zeros(0, np.uint32), pos
    window = np.frombuffer(buf, np.uint8, count=rem, offset=pos)
    # the last byte of each varint has its top bit clear; grow the window
    # until it holds n of them, by at most twice the shortfall a step
    parts, got, lo, hi = [], 0, 0, n
    while True:
        seg = np.flatnonzero(window[lo:hi] < 0x80)
        parts.append(seg + lo)
        got += seg.size
        if got >= n or hi == rem:
            break
        lo, hi = hi, min(rem, hi + 2 * (n - got) + 16)
    if got < n:
        raise FrameError("truncated varint")
    ends = np.concatenate(parts)[:n] + 1
    starts = np.empty(n, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1]
    nb = ends - starts
    if int(nb.max()) > _VARINT_MAX_BYTES:
        raise FrameError("varint overflow")
    val = np.zeros(n, np.uint64)
    for k in range(int(nb.max())):
        m = nb > k
        b = window[starts[m] + k].astype(np.uint64) & np.uint64(0x7F)
        if k < 5:
            val[m] |= b << np.uint64(7 * k)
        elif b.any():  # a payload bit at 2^35 or above
            raise FrameError("string length past uint32")
    if (val >> np.uint64(32)).any():
        raise FrameError("string length past uint32")
    return val.astype(np.uint32), pos + int(ends[-1])


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
            out += write_varints(lens)
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
        header = bytes(frame[pos : pos + hlen])
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
            lengths, pos = read_string_lengths(frame, pos, len(body), n_str)
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


# --------------------------------------------------------------- containers
def is_container(blob: bytes) -> bool:
    return bytes(blob[:4]) == CONTAINER_MAGIC


class ContainerWriter:
    """Incremental container emitter: header, then one chunk frame at a time.

    A running CRC replaces the full-container buffer, so peak memory is one
    chunk frame regardless of container size.  Two modes:

      * ``n_chunks`` given — the chunk-count varint is emitted with the header
        and the output is **byte-identical** to ``write_container`` for the
        same chunks; any binary sink works.
      * ``n_chunks=None`` — the count is unknown until :meth:`close`.  The
        sink must then be seekable *and* readable: a fixed-width (5-byte,
        LEB128-padded) count placeholder is reserved and backpatched, and the
        trailing CRC is recomputed by re-reading the body in blocks.  The
        padded varint decodes identically, but the bytes differ from
        ``write_container`` at exactly the count field (as the reference's).

    Use as a context manager, or call :meth:`close` explicitly; ``close``
    verifies the promised chunk count and appends the CRC trailer.
    """

    _PAD_VARINT_LEN = 5  # 5 x 7 = 35 bits of count, far above MAX_CHUNKS

    def __init__(self, out, version: int, n_chunks: Optional[int] = None):
        from .versioning import CONTAINER_MIN_VERSION

        if version < CONTAINER_MIN_VERSION:
            raise ValueError(
                f"multi-chunk container requires format version"
                f" >= {CONTAINER_MIN_VERSION}, got {version}"
            )
        self._out = out
        self._expect = n_chunks
        self._written = 0
        self._closed = False
        header = bytearray(CONTAINER_MAGIC)
        header.append(version & 0xFF)
        if n_chunks is not None:
            if n_chunks < 1:
                raise ValueError("container needs at least one chunk")
            write_varint(header, n_chunks)
            self._count_pos = None
        else:
            if not (out.seekable() and out.readable()):
                raise ValueError(
                    "ContainerWriter with unknown n_chunks needs a seekable,"
                    " readable sink (pass n_chunks for pure streaming)"
                )
            self._count_pos = out.tell() + len(header)
            header += self._pad_varint(0)
        self._crc = zlib.crc32(header)
        out.write(bytes(header))
        self.bytes_written = len(header)

    @classmethod
    def _pad_varint(cls, value: int) -> bytes:
        raw = bytearray()
        for _ in range(cls._PAD_VARINT_LEN - 1):
            raw.append((value & 0x7F) | 0x80)
            value >>= 7
        if value > 0x7F:
            raise ValueError("chunk count overflows the padded varint")
        raw.append(value)
        return bytes(raw)

    def write_chunk(self, frame: bytes) -> None:
        if self._closed:
            raise ValueError("ContainerWriter already closed")
        if bytes(frame[:4]) != MAGIC:
            raise ValueError("container chunks must be single frames (no nesting)")
        if self._expect is not None and self._written >= self._expect:
            raise ValueError(f"more than the promised {self._expect} chunks")
        piece = bytearray()
        write_varint(piece, len(frame))
        piece += frame
        self._crc = zlib.crc32(piece, self._crc)
        # one write a chunk, as the reference's: its sink seam counts writes
        self._out.write(piece)
        self.bytes_written += len(piece)
        self._written += 1

    def close(self) -> int:
        """Finish the record (count check + CRC trailer) -> total bytes."""
        if self._closed:
            return self.bytes_written
        self._closed = True
        if self._expect is not None and self._written != self._expect:
            raise ValueError(f"promised {self._expect} chunks, wrote {self._written}")
        if self._written == 0:
            raise ValueError("container needs at least one chunk")
        if self._count_pos is not None:
            # backpatch the count, then recompute the CRC over the final body
            end = self._out.tell()
            self._out.seek(self._count_pos)
            self._out.write(self._pad_varint(self._written))
            self._out.seek(end - self.bytes_written)
            crc = 0
            remaining = self.bytes_written
            while remaining:
                block = self._out.read(min(remaining, 1 << 20))
                if not block:
                    raise IOError("container body unreadable during CRC fixup")
                crc = zlib.crc32(block, crc)
                remaining -= len(block)
            self._crc = crc
        self._out.write(_struct.pack("<I", self._crc & 0xFFFFFFFF))
        self.bytes_written += 4
        return self.bytes_written

    def __enter__(self) -> "ContainerWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:  # don't mask the original error with count-mismatch noise
            self._closed = True


def write_container(version: int, chunk_frames: Sequence[bytes]) -> bytes:
    """Wrap independently compressed chunk frames into one container record."""
    buf = io.BytesIO()
    with ContainerWriter(buf, version, n_chunks=len(chunk_frames)) as w:
        for frame in chunk_frames:
            w.write_chunk(frame)
    return buf.getvalue()


def iter_container_frames(
    reader, *, allow_empty: bool = False, salvage: bool = False
) -> Iterator[bytes]:
    """Yield chunk frames from a file-like container, one chunk in memory.

    Fails closed with :class:`FrameError` on bad magic, a version below the
    container minimum, bad or truncated varints, an implausible or zero
    chunk count (``allow_empty`` accepts zero), mid-chunk EOF, nested
    containers, a chunk that is not a frame, a CRC mismatch and trailing
    garbage.  The trailing CRC is checked after the last chunk is yielded;
    each chunk frame carries its own CRC, and the iterator raises before it
    completes, so a consumer that drains it never takes a corrupt container
    for a whole one.  (``salvage`` is not yet ported.)
    """
    from .versioning import CONTAINER_MIN_VERSION

    if salvage:
        raise NotImplementedError("container salvage is not yet ported to repro_torch")
    head = reader.read(5)
    if len(head) < 5 or head[:4] != CONTAINER_MAGIC:
        raise FrameError("bad container magic")
    crc = zlib.crc32(head)
    version = head[4]
    if version < CONTAINER_MIN_VERSION:
        raise FrameError(f"container frame predates format v{CONTAINER_MIN_VERSION}")
    n_chunks, raw = read_stream_varint(reader)
    crc = zlib.crc32(raw, crc)
    if n_chunks > MAX_CHUNKS:
        raise FrameError("implausible chunk count")
    if n_chunks == 0 and not allow_empty:
        raise FrameError("empty container")
    for _ in range(n_chunks):
        flen, raw = read_stream_varint(reader)
        crc = zlib.crc32(raw, crc)
        if flen > (1 << 48):
            raise FrameError("implausible chunk length")
        chunk = reader.read(flen)
        if len(chunk) != flen:
            raise FrameError("truncated container chunk")
        crc = zlib.crc32(chunk, crc)
        if chunk[:4] == CONTAINER_MAGIC:
            raise FrameError("nested container rejected")
        if chunk[:4] != MAGIC:
            raise FrameError("container chunk is not a frame")
        yield bytes(chunk)
    trailer = reader.read(4)
    if len(trailer) != 4:
        raise FrameError("truncated container trailer")
    (crc_expect,) = _struct.unpack("<I", trailer)
    if (crc & 0xFFFFFFFF) != crc_expect:
        raise FrameError("container checksum mismatch")
    if reader.read(1):
        raise FrameError("trailing garbage in container")


def read_container(blob: bytes) -> Tuple[int, List[bytes]]:
    """Parse a container -> (version, [chunk frame bytes]).

    Fails closed as the reference does: bad magic, CRC mismatch, a version
    below the container minimum, an implausible chunk count, a truncated
    chunk, a nested container and trailing garbage raise
    :class:`FrameError`.  Each chunk is a memoryview into ``blob``.
    """
    from .versioning import CONTAINER_MIN_VERSION

    view = memoryview(blob)
    if len(view) < 10 or bytes(view[:4]) != CONTAINER_MAGIC:
        raise FrameError("bad container magic")
    end = len(view) - 4
    (crc_expect,) = _struct.unpack("<I", view[end:])
    if (zlib.crc32(view[:end]) & 0xFFFFFFFF) != crc_expect:
        raise FrameError("container checksum mismatch")
    version = view[4]
    if version < CONTAINER_MIN_VERSION:
        raise FrameError(f"container frame predates format v{CONTAINER_MIN_VERSION}")
    n_chunks, pos = read_varint(view, 5)
    if n_chunks > MAX_CHUNKS:
        raise FrameError("implausible chunk count")
    frames: List[bytes] = []
    for _ in range(n_chunks):
        flen, pos = read_varint(view, pos)
        if pos + flen > end:
            raise FrameError("truncated container chunk")
        chunk = view[pos : pos + flen]
        pos += flen
        if bytes(chunk[:4]) == CONTAINER_MAGIC:
            raise FrameError("nested container rejected")
        frames.append(chunk)
    if pos != end:
        raise FrameError("trailing garbage in container")
    return version, frames
