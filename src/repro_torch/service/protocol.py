"""The service wire protocol: length-prefixed frames over a byte stream, the
port's copy of ``repro.service.protocol``, byte for byte on the wire.

Layout (varints are LEB128, exactly like ``repro_torch.core.wire``):

    request   magic  b"OZS1"          (magic + protocol version, one token)
              u8     verb             (PING / COMPRESS / DECOMPRESS / STATS)
              varint header_len, header bytes   (msgpack map, <= 1 MiB)
              body blocks:  (varint block_len in [1, 64 MiB], block bytes)*
              varint 0                (body terminator)
    response  magic  b"OZR1"
              u8     status           (0 = ok, 1 = error)
              varint header_len, header bytes   (msgpack map)
              body blocks + 0 terminator, as above

Headers are written and read by the port's own msgpack subset
(``repro_torch.core.serialize.packb`` / ``unpackb(..., ext=True)``), never
``msgpack``: the bytes are ``msgpack.packb(header, use_bin_type=True)``'s,
and a header ``msgpack.unpackb(raw=False)`` refuses (truncated, trailing
bytes, the reserved byte, invalid UTF-8, a key that is not ``str`` or
``bytes``, a malformed timestamp) is refused here too, as
:class:`ProtocolError`.

Both sides stream bodies as bounded blocks, so neither ever needs the whole
payload in memory to frame it, and a reader always knows how many bytes to
expect next: truncation at *any* point is a hard :class:`ProtocolError` (a
``repro_torch.core.wire.FrameError`` subclass: the service fails closed
exactly like the container format).  Oversized length varints are rejected
before any allocation.  Connections are persistent: a client sends any
number of requests back to back; responses come in order.  Writing a message
passes the fault point ``proto.send`` and the sink's writes ``proto.io.write``
(``repro_torch.reliability.faults``); reading one passes ``proto.recv``.
"""
from __future__ import annotations

import socket
from typing import BinaryIO, Iterable, Iterator, Optional, Tuple, Union

from ..core.serialize import packb, unpackb
from ..core.wire import FrameError, write_varint
from ..reliability.faults import fault_point, wrap_io

PROTOCOL_VERSION = 1
REQUEST_MAGIC = b"OZS1"
RESPONSE_MAGIC = b"OZR1"

VERB_PING = 0
VERB_COMPRESS = 1
VERB_DECOMPRESS = 2
VERB_STATS = 3
VERBS = {VERB_PING: "ping", VERB_COMPRESS: "compress",
         VERB_DECOMPRESS: "decompress", VERB_STATS: "stats"}

STATUS_OK = 0
STATUS_ERROR = 1

MAX_HEADER_BYTES = 1 << 20
MAX_BLOCK_BYTES = 64 << 20
DEFAULT_BLOCK_BYTES = 256 << 10

__all__ = [
    "PROTOCOL_VERSION",
    "REQUEST_MAGIC",
    "RESPONSE_MAGIC",
    "VERB_PING",
    "VERB_COMPRESS",
    "VERB_DECOMPRESS",
    "VERB_STATS",
    "VERBS",
    "STATUS_OK",
    "STATUS_ERROR",
    "MAX_HEADER_BYTES",
    "MAX_BLOCK_BYTES",
    "DEFAULT_BLOCK_BYTES",
    "ProtocolError",
    "BlockReader",
    "read_message",
    "write_message",
    "read_request",
    "read_request_or_eof",
    "read_request_rest",
    "write_request",
    "read_response",
    "read_response_or_eof",
    "write_response",
    "iter_body_blocks",
    "parse_address",
]


class ProtocolError(FrameError):
    """Malformed, truncated, or oversized service traffic (fail closed)."""


# ------------------------------------------------------------------ primitives
def _read_exact(r: BinaryIO, n: int) -> bytes:
    """Read exactly n bytes or raise (EOF mid-message is never silent)."""
    out = bytearray()
    while len(out) < n:
        piece = r.read(n - len(out))
        if not piece:
            raise ProtocolError(
                f"connection closed mid-message ({len(out)}/{n} bytes)"
            )
        out += piece
    return bytes(out)


def _read_varint(r: BinaryIO) -> int:
    result = 0
    shift = 0
    while True:
        b = r.read(1)
        if not b:
            raise ProtocolError("truncated varint")
        result |= (b[0] & 0x7F) << shift
        if not (b[0] & 0x80):
            return result
        shift += 7
        if shift > 63:
            raise ProtocolError("varint overflow")


def _pack_header(header: dict) -> bytes:
    blob = packb(header or {})
    if len(blob) > MAX_HEADER_BYTES:
        raise ProtocolError(f"header too large ({len(blob)} bytes)")
    return blob


def _unpack_header(blob: bytes) -> dict:
    try:
        header = unpackb(blob, ext=True)
    except Exception as err:
        raise ProtocolError(f"undecodable message header: {err}") from None
    if not isinstance(header, dict):
        raise ProtocolError("message header must be a map")
    return header


# ----------------------------------------------------------------- body stream
class BlockReader:
    """File-like view over a 0-terminated block stream (bounded memory).

    ``read(n)`` hands out bytes one block at a time, so peak memory is one
    block regardless of body size.  ``size_hint`` (from the request header,
    when the sender knows its payload length) is what lets the server's
    ``stream_io.compress_file`` take the known-chunk-count container path,
    the one whose bytes match the offline CLI exactly.  After the terminator
    the reader reports EOF; :meth:`drain` skips any unread remainder so the
    connection can be reused for the next request.

    ``limit`` (settable by the consumer) is a hard ceiling on total body
    bytes, enforced *before* each block is buffered: a sender that declared
    ``size=16`` and then streams gigabytes is cut off at the first
    over-budget block, not after the body has been swallowed into memory.
    """

    def __init__(self, r: BinaryIO, size_hint: Optional[int] = None):
        self._r = r
        self._buf = b""
        self._done = False
        self.bytes_read = 0
        self.size_hint = size_hint
        self.limit: Optional[int] = None

    def _next_block(self) -> bool:
        if self._done:
            return False
        n = _read_varint(self._r)
        if n == 0:
            self._done = True
            return False
        if n > MAX_BLOCK_BYTES:
            raise ProtocolError(f"body block too large ({n} bytes)")
        if self.limit is not None and self.bytes_read + n > self.limit:
            raise ProtocolError(
                f"body exceeds its limit of {self.limit} bytes"
                f" ({self.bytes_read + n}+ sent)"
            )
        self._buf = _read_exact(self._r, n)
        self.bytes_read += n
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            parts = [self._buf]
            self._buf = b""
            while self._next_block():
                parts.append(self._buf)
                self._buf = b""
            return b"".join(parts)
        out = bytearray()
        while len(out) < n:
            if not self._buf and not self._next_block():
                break
            take = min(n - len(out), len(self._buf))
            out += self._buf[:take]
            self._buf = self._buf[take:]
        return bytes(out)

    def drain(self) -> int:
        """Consume through the terminator -> bytes skipped (resync point)."""
        skipped = len(self._buf)
        self._buf = b""
        while self._next_block():
            skipped += len(self._buf)
            self._buf = b""
        return skipped


def iter_body_blocks(
    src: Union[bytes, bytearray, memoryview, BinaryIO],
    block_bytes: int = DEFAULT_BLOCK_BYTES,
) -> Iterator[bytes]:
    """Cut a bytes-like or binary file into body blocks of ``block_bytes``."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        view = memoryview(src)
        if view.itemsize != 1 or view.ndim != 1:
            # slice in *bytes*, not elements (e.g. an int64 array view)
            try:
                view = view.cast("B")
            except TypeError:  # non-contiguous: fall back to one copy
                view = memoryview(view.tobytes())
        for i in range(0, len(view), block_bytes):
            yield bytes(view[i : i + block_bytes])
        return
    while True:
        piece = src.read(block_bytes)
        if not piece:
            return
        yield piece


def _write_body(w: BinaryIO, body: Optional[Iterable[bytes]]) -> int:
    total = 0
    for block in body or ():
        if not block:
            continue
        if len(block) > MAX_BLOCK_BYTES:
            raise ProtocolError(f"body block too large ({len(block)} bytes)")
        prefix = bytearray()
        write_varint(prefix, len(block))
        w.write(bytes(prefix))
        w.write(block)
        total += len(block)
    w.write(b"\x00")
    return total


# ------------------------------------------------------------------- messages
def write_message(
    w: BinaryIO,
    magic: bytes,
    tag: int,
    header: dict,
    body: Optional[Iterable[bytes]] = None,
) -> int:
    """Emit one framed message -> body bytes written (flushes the sink)."""
    fault_point("proto.send")  # injectable connection drop / torn frame
    w = wrap_io(w, "proto.io")
    blob = _pack_header(header)
    head = bytearray()
    head += magic
    head.append(tag & 0xFF)
    write_varint(head, len(blob))
    head += blob
    w.write(bytes(head))
    total = _write_body(w, body)
    w.flush()
    return total


def _check_magic(got: bytes, magic: bytes) -> None:
    if got != magic:
        raise ProtocolError(
            f"bad magic {got!r} (expected {magic!r}; wrong endpoint or a"
            f" protocol-version mismatch)"
        )


def _read_tail(r: BinaryIO) -> Tuple[int, dict, BlockReader]:
    fault_point("proto.recv")  # injectable mid-message connection loss
    tag = _read_exact(r, 1)[0]
    hlen = _read_varint(r)
    if hlen > MAX_HEADER_BYTES:
        raise ProtocolError(f"header too large ({hlen} bytes)")
    header = _unpack_header(_read_exact(r, hlen))
    return tag, header, BlockReader(r, header.get("size"))


def read_message(r: BinaryIO, magic: bytes) -> Tuple[int, dict, BlockReader]:
    """Parse one message -> (tag, header, body reader).

    The caller must fully consume (or :meth:`BlockReader.drain`) the body
    before reading the next message off the same stream.
    """
    _check_magic(_read_exact(r, len(magic)), magic)
    return _read_tail(r)


def write_request(
    w: BinaryIO, verb: int, header: dict, body: Optional[Iterable[bytes]] = None
) -> int:
    return write_message(w, REQUEST_MAGIC, verb, header, body)


def read_request(r: BinaryIO) -> Tuple[int, dict, BlockReader]:
    verb, header, body = read_message(r, REQUEST_MAGIC)
    if verb not in VERBS:
        raise ProtocolError(f"unknown verb {verb}")
    return verb, header, body


def read_request_rest(r: BinaryIO, first: bytes) -> Tuple[int, dict, BlockReader]:
    """Parse a request whose first byte was already consumed by the caller
    (servers read it separately to tell an idle hangup/timeout from a
    mid-request one)."""
    _check_magic(first + _read_exact(r, len(REQUEST_MAGIC) - 1), REQUEST_MAGIC)
    verb, header, body = _read_tail(r)
    if verb not in VERBS:
        raise ProtocolError(f"unknown verb {verb}")
    return verb, header, body


def read_request_or_eof(r: BinaryIO) -> Optional[Tuple[int, dict, BlockReader]]:
    """Like :func:`read_request`, but a clean EOF *between* requests (the
    client hung up after completing its last exchange) returns None instead
    of raising: the one place on a persistent connection where closing is
    not an error."""
    first = r.read(1)
    if not first:
        return None
    return read_request_rest(r, first)


def write_response(
    w: BinaryIO, status: int, header: dict, body: Optional[Iterable[bytes]] = None
) -> int:
    return write_message(w, RESPONSE_MAGIC, status, header, body)


def _check_status(status: int) -> None:
    if status not in (STATUS_OK, STATUS_ERROR):
        raise ProtocolError(f"unknown response status {status}")


def read_response(r: BinaryIO) -> Tuple[int, dict, BlockReader]:
    status, header, body = read_message(r, RESPONSE_MAGIC)
    _check_status(status)
    return status, header, body


def read_response_or_eof(r: BinaryIO) -> Optional[Tuple[int, dict, BlockReader]]:
    """Like :func:`read_response`, but a clean EOF *before any response byte*
    returns None instead of raising: the signature of a server that closed a
    persistent connection (idle timeout, restart) between exchanges.  A
    truncation after the first byte is still a hard :class:`ProtocolError`."""
    first = r.read(1)
    if not first:
        return None
    _check_magic(first + _read_exact(r, len(RESPONSE_MAGIC) - 1), RESPONSE_MAGIC)
    status, header, body = _read_tail(r)
    _check_status(status)
    return status, header, body


# ------------------------------------------------------------------ addresses
def parse_address(spec: Union[str, Tuple[str, int]]) -> Tuple[int, object]:
    """Resolve an address spec -> (socket family, connect/bind argument).

    Accepted forms: ``unix:/path``, any string containing ``/`` (a Unix
    socket path), ``host:port``, ``:port`` (localhost), or an explicit
    ``(host, port)`` tuple.
    """
    if isinstance(spec, tuple):
        host, port = spec
        return socket.AF_INET, (host or "127.0.0.1", int(port))
    if not isinstance(spec, str) or not spec:
        raise ValueError(f"bad service address {spec!r}")
    if spec.startswith("unix:"):
        return socket.AF_UNIX, spec[len("unix:") :]
    if "/" in spec:
        return socket.AF_UNIX, spec
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"bad service address {spec!r} (want unix:/path, /path, host:port)"
        )
    return socket.AF_INET, (host or "127.0.0.1", int(port))
