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

Salvage and verify (``salvage_container``, ``verify_container``,
``iter_container_frames(salvage=True)``) walk a damaged container on the
host: they parse structure and check CRCs, and decode no payload.
"""
from __future__ import annotations

import io
import struct as _struct
import zlib
from dataclasses import dataclass, field
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
    "SalvageReport",
    "salvage_container",
    "verify_container",
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
    reader,
    *,
    allow_empty: bool = False,
    salvage: bool = False,
    report: Optional["SalvageReport"] = None,
) -> Iterator[bytes]:
    """Yield chunk frames from a file-like container, one chunk in memory.

    Fails closed with :class:`FrameError` on bad magic, a version below the
    container minimum, bad or truncated varints, an implausible or zero
    chunk count (``allow_empty`` accepts zero), mid-chunk EOF, nested
    containers, a chunk that is not a frame, a CRC mismatch and trailing
    garbage.  The trailing CRC is checked after the last chunk is yielded;
    each chunk frame carries its own CRC, and the iterator raises before it
    completes, so a consumer that drains it never takes a corrupt container
    for a whole one.

    ``salvage=True`` switches to the best-effort scanner
    (:func:`salvage_container`): it yields every chunk frame whose own CRC
    verifies, skips damaged ones, and fills ``report`` (a caller-supplied
    :class:`SalvageReport`) with the recovered indices and lost ranges.  It
    reads the whole record into memory.
    """
    from .versioning import CONTAINER_MIN_VERSION

    if salvage:
        frames, rep = salvage_container(reader.read())
        if report is not None:
            report.__dict__.update(rep.__dict__)
        yield from frames
        return
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


# ------------------------------------------------------- salvage & verify
@dataclass
class SalvageReport:
    """What a damage scan found: which chunks survived, which were lost.

    ``recovered`` and ``damaged`` hold exact chunk indices (damaged as
    inclusive ``(lo, hi)`` ranges, ``hi`` None when the end is unknown).
    Where corruption destroys the *structure* (a chunk length varint, a
    truncation) the scanner resynchronizes on the next ``OZLJ`` magic whose
    structural extent carries a valid frame CRC; chunks recovered between two
    such gaps cannot be indexed exactly and are counted in
    ``recovered_unplaced``.  ``trailer_ok`` is the whole-container CRC (None
    when the record is too short to have one).
    """

    n_chunks: Optional[int] = None
    recovered: List[int] = field(default_factory=list)
    recovered_unplaced: int = 0
    damaged: List[Tuple[int, Optional[int]]] = field(default_factory=list)
    trailer_ok: Optional[bool] = None
    notes: List[str] = field(default_factory=list)

    @property
    def intact(self) -> bool:
        return (
            not self.damaged
            and not self.notes
            and self.recovered_unplaced == 0
            and bool(self.trailer_ok)
            and (self.n_chunks is None or len(self.recovered) == self.n_chunks)
        )

    def damaged_ranges(self) -> str:
        def one(lo, hi):
            if hi is None:
                return f"{lo}..?"
            return str(lo) if lo == hi else f"{lo}..{hi}"

        return ", ".join(one(lo, hi) for lo, hi in self.damaged) or "none"

    def summary(self) -> str:
        total = "?" if self.n_chunks is None else str(self.n_chunks)
        parts = [
            f"chunks: {len(self.recovered)}/{total} recovered",
            f"damaged: {self.damaged_ranges()}",
        ]
        if self.recovered_unplaced:
            parts.append(f"{self.recovered_unplaced} recovered at uncertain index")
        if self.trailer_ok is not None:
            parts.append(f"container crc {'ok' if self.trailer_ok else 'BAD'}")
        parts.extend(self.notes)
        return "; ".join(parts)

    def to_dict(self) -> dict:
        return {
            "n_chunks": self.n_chunks,
            "recovered": list(self.recovered),
            "recovered_unplaced": self.recovered_unplaced,
            "damaged": [list(r) for r in self.damaged],
            "trailer_ok": self.trailer_ok,
            "notes": list(self.notes),
            "intact": self.intact,
        }


def _frame_extent(buf: bytes, start: int, limit: int) -> int:
    """Structural end offset of the frame starting at ``start`` (< ``limit``).

    Frames are self-delimiting (every variable-length field is preceded by
    its length), so a parse walk finds the extent without trusting any outer
    container framing.  Raises :class:`FrameError` when the walk leaves
    ``[start, limit]`` or a count is implausible.  The frame's own CRC is
    *not* checked here.
    """
    if buf[start : start + 4] != MAGIC or start + 9 > limit:
        raise FrameError("bad magic")
    pos = start + 5  # magic + version byte

    def var(p: int) -> Tuple[int, int]:
        v, p = read_varint(buf, p)
        if p > limit:
            raise FrameError("frame walk leaves the record")
        return v, p

    _, pos = var(pos)  # n_graph_inputs
    n_nodes, pos = var(pos)
    if n_nodes > 1_000_000:
        raise FrameError("implausible node count")
    for _ in range(n_nodes):
        _, pos = var(pos)  # codec_id
        n_in, pos = var(pos)
        if n_in > 1_000_000:
            raise FrameError("implausible input count")
        for _ in range(n_in):
            _, pos = var(pos)
        _, pos = var(pos)  # n_out
        hlen, pos = var(pos)
        if pos + hlen > limit:
            raise FrameError("truncated node header")
        pos += hlen
    n_stored, pos = var(pos)
    if n_stored > 1_000_000:
        raise FrameError("implausible stored count")
    for _ in range(n_stored):
        _, pos = var(pos)  # edge id
        if pos >= limit:
            raise FrameError("truncated stream entry")
        stype = buf[pos]
        pos += 1
        _, pos = var(pos)  # width
        if stype == int(SType.STRING):
            n_str, pos = var(pos)
            if n_str > limit - pos:
                raise FrameError("implausible string count")
            for _ in range(n_str):
                _, pos = var(pos)
        plen, pos = var(pos)
        if pos + plen > limit:
            raise FrameError("truncated stream payload")
        pos += plen
    if pos + 4 > limit:
        raise FrameError("truncated frame crc")
    return pos + 4


def _frame_crc_ok(buf: bytes, start: int, end: int) -> bool:
    if end - start < 9:
        return False
    (crc_expect,) = _struct.unpack("<I", buf[end - 4 : end])
    return (zlib.crc32(buf[start : end - 4]) & 0xFFFFFFFF) == crc_expect


def salvage_container(data: bytes) -> Tuple[List[bytes], SalvageReport]:
    """Best-effort scan of a (possibly damaged) container record.

    Returns ``(frames, report)``: every chunk frame whose own CRC verifies,
    in physical (= chunk) order, and a :class:`SalvageReport` naming the
    chunk indices recovered and the ranges lost.

    It walks the chunk framing (length varint + frame) while it stays
    believable: a chunk whose payload is corrupt but whose length prefix is
    intact costs that one index.  Where the structure breaks (a bad varint,
    an implausible length, a truncation) it resynchronizes on the next
    ``OZLJ`` magic whose structural extent (:func:`_frame_extent`) carries a
    valid frame CRC and resumes the chunk chain after it.  Indices are
    assigned forward from 0 up to the first such gap and backward from the
    header's chunk count over the cleanly parsed tail; chunks between two
    gaps are recovered but unplaced.  The whole record is held in memory.
    """
    data = bytes(data)
    report = SalvageReport()
    if len(data) < 10:
        report.notes.append(f"record too short to be a container ({len(data)} bytes)")
        return [], report
    from .versioning import CONTAINER_MIN_VERSION

    if data[:4] != CONTAINER_MAGIC:
        report.notes.append("container magic damaged")
    elif data[4] < CONTAINER_MIN_VERSION:
        report.notes.append(f"container version byte damaged ({data[4]})")
    body_end = len(data) - 4
    (crc_expect,) = _struct.unpack("<I", data[-4:])
    report.trailer_ok = (zlib.crc32(data[:body_end]) & 0xFFFFFFFF) == crc_expect
    pos = 5
    try:
        n_chunks, pos = read_varint(data, pos)
        # a chunk costs at least 10 wire bytes (a 1-byte length varint and
        # the 9-byte minimum frame), so a count the record cannot hold is a
        # damaged varint: trusting it would mis-anchor the backward indices
        capacity = max(1, (body_end - pos) // 10)
        if 0 < n_chunks <= min(MAX_CHUNKS, capacity):
            report.n_chunks = n_chunks
        else:
            report.notes.append(f"implausible chunk count {n_chunks} in header")
            pos = 5
    except FrameError:
        report.notes.append("chunk count varint unreadable")
        pos = 5
    if report.n_chunks is None:
        # the header's structure is gone: resync onto the first frame magic
        first = data.find(MAGIC, pos)
        pos = first if first != -1 else body_end

    # scan -> ("ok", frame) | ("bad", None): a damaged chunk of known extent
    # | ("gap", None): a structural break
    items: List[Tuple[str, Optional[bytes]]] = []

    def resync(p: int) -> int:
        """Scan forward from ``p`` for a self-delimiting frame with a valid
        CRC -> the offset after it (the frame is appended), or body_end."""
        items.append(("gap", None))
        cand = data.find(MAGIC, p)
        while cand != -1 and cand < body_end:
            try:
                end = _frame_extent(data, cand, body_end)
            except FrameError:
                end = None
            if end is not None and _frame_crc_ok(data, cand, end):
                items.append(("ok", data[cand:end]))
                return end
            cand = data.find(MAGIC, cand + 1)
        return body_end

    while pos < body_end:
        try:
            flen, npos = read_varint(data, pos)
        except FrameError:
            pos = resync(pos + 1)
            continue
        if not (9 <= flen <= body_end - npos) or data[npos : npos + 4] != MAGIC:
            pos = resync(pos + 1)
            continue
        end = npos + flen
        if _frame_crc_ok(data, npos, end):
            items.append(("ok", data[npos:end]))
        else:
            # the length prefix is believable but the frame is corrupt: trust
            # it (and charge one chunk index) only when it lands on another
            # chunk boundary or the end of the record
            looks_chained = end == body_end
            if not looks_chained:
                try:
                    nxt_len, nxt_pos = read_varint(data, end)
                    looks_chained = (
                        9 <= nxt_len <= body_end - nxt_pos
                        and data[nxt_pos : nxt_pos + 4] == MAGIC
                    )
                except FrameError:
                    looks_chained = False
            if not looks_chained:
                pos = resync(pos + 1)
                continue
            items.append(("bad", None))
        pos = end
    if pos > body_end:
        items.append(("gap", None))
        report.notes.append("record truncated mid-chunk")

    # index assignment: forward to the first gap, backward from the header
    # count over the clean tail, unplaced in between
    gaps = [i for i, (k, _) in enumerate(items) if k == "gap"]
    first_gap = gaps[0] if gaps else len(items)
    last_gap = gaps[-1] if gaps else -1
    frames: List[bytes] = []
    damaged: List[int] = []
    idx = 0
    for kind, frame in items[:first_gap]:
        if kind == "ok":
            report.recovered.append(idx)
            frames.append(frame)
        else:
            damaged.append(idx)
        idx += 1
    fwd_end = idx  # the first index the forward walk does not account for
    if first_gap < len(items):
        # chunks recovered between the first and last gap have no anchor on
        # either side: keep them (physical order) and report the uncertainty
        middle = items[first_gap : last_gap + 1]
        n_mid = sum(1 for k, _ in middle if k == "ok")
        frames.extend(f for k, f in middle if k == "ok")
        if n_mid:
            report.recovered_unplaced += n_mid
            report.notes.append(
                f"{n_mid} chunk(s) recovered between structural gaps (position uncertain)"
            )
        tail = items[last_gap + 1 :]
        bwd_start = None if report.n_chunks is None else report.n_chunks - len(tail)
        if pos == body_end and bwd_start is not None and bwd_start >= fwd_end:
            # the tail chain parsed cleanly through to the trailer: anchor
            # its indices backward from the header's chunk count
            j = bwd_start
            for kind, frame in tail:
                if kind == "ok":
                    report.recovered.append(j)
                    frames.append(frame)
                else:
                    damaged.append(j)
                j += 1
            if bwd_start > fwd_end:
                report.damaged.append((fwd_end, bwd_start - 1))
        else:
            frames.extend(f for k, f in tail if k == "ok")
            report.recovered_unplaced += sum(1 for k, _ in tail if k == "ok")
            hi = None if report.n_chunks is None else report.n_chunks - 1
            report.damaged.append((fwd_end, hi))
    elif report.n_chunks is not None and idx != report.n_chunks:
        report.notes.append(f"header promises {report.n_chunks} chunks, record holds {idx}")
    # merge damaged singletons into inclusive ranges
    for i in sorted(damaged):
        if report.damaged and report.damaged[-1][1] == i - 1:
            report.damaged[-1] = (report.damaged[-1][0], i)
        else:
            report.damaged.append((i, i))
    report.damaged.sort(key=lambda r: r[0])
    report.recovered.sort()
    return frames, report


def verify_container(reader) -> SalvageReport:
    """Streaming integrity walk: every chunk frame's CRC and the container
    trailer, decoding no payload.

    Unlike :func:`iter_container_frames` it does not stop at the first bad
    chunk: it walks on while the *structure* (the length varints) holds, so
    the report lists every damaged chunk index.  A structural break ends the
    walk with a note (:func:`salvage_container` resyncs past it).  A bare
    ``OZLJ`` frame gets a one-chunk report.
    """
    from .versioning import CONTAINER_MIN_VERSION

    report = SalvageReport()
    head = reader.read(5)
    if len(head) < 5:
        report.notes.append("record too short")
        return report
    if head[:4] == MAGIC:
        frame = head + reader.read()
        report.n_chunks = 1
        if len(frame) >= 9 and _frame_crc_ok(frame, 0, len(frame)):
            report.recovered.append(0)
            report.trailer_ok = True
        else:
            report.damaged.append((0, 0))
            report.trailer_ok = False
            report.notes.append("bare frame CRC mismatch")
        return report
    if head[:4] != CONTAINER_MAGIC:
        report.notes.append("bad container magic")
        return report
    crc = zlib.crc32(head)
    if head[4] < CONTAINER_MIN_VERSION:
        report.notes.append(f"container version {head[4]} predates the record")
    try:
        n_chunks, raw = read_stream_varint(reader)
    except FrameError:
        report.notes.append("chunk count varint unreadable")
        return report
    crc = zlib.crc32(raw, crc)
    if n_chunks > MAX_CHUNKS:
        report.notes.append(f"implausible chunk count {n_chunks}")
        return report
    report.n_chunks = n_chunks
    for i in range(n_chunks):
        try:
            flen, raw = read_stream_varint(reader)
        except FrameError:
            report.notes.append(f"structure unreadable at chunk {i}")
            return report
        crc = zlib.crc32(raw, crc)
        if flen > (1 << 48):
            report.notes.append(f"implausible length for chunk {i}")
            return report
        chunk = reader.read(flen)
        if len(chunk) != flen:
            report.notes.append(f"record truncated in chunk {i}")
            report.damaged.append((i, n_chunks - 1))
            return report
        crc = zlib.crc32(chunk, crc)
        if chunk[:4] == MAGIC and _frame_crc_ok(chunk, 0, len(chunk)):
            report.recovered.append(i)
        elif report.damaged and report.damaged[-1][1] == i - 1:
            report.damaged[-1] = (report.damaged[-1][0], i)
        else:
            report.damaged.append((i, i))
    trailer = reader.read(4)
    if len(trailer) != 4:
        report.notes.append("container trailer missing")
        return report
    (crc_expect,) = _struct.unpack("<I", trailer)
    report.trailer_ok = (crc & 0xFFFFFFFF) == crc_expect
    if reader.read(1):
        report.notes.append("trailing garbage after container")
    return report


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
