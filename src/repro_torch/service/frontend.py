"""Non-blocking connection frontend, the port's copy of
``repro.service.frontend``: one event loop, no thread per socket, in front of
the port's :class:`~repro_torch.service.server.RequestCore` on the card.

The threaded :class:`~repro_torch.service.server.CompressionServer` spends a
whole thread per connection, most of it blocked in ``recv``: a few hundred
idle keep-alive clients exhaust the pool, and a slow-loris peer dribbling one
byte per second pins a worker for nothing.  This frontend multiplexes every
connection over a single ``selectors`` event loop instead:

* **Incremental parsing.**  :class:`FrameParser` consumes ``OZS1`` frames
  from whatever ``recv`` returns (magic, verb, varint header length, msgpack
  header, body blocks), holding only the current partial token plus a
  spooled body.  A thousand half-open frames cost a thousand small buffers,
  not a thousand threads.
* **Buffered bodies, same compression path.**  A request's body is spooled
  to completion *before* dispatch, then handed to the shared ``RequestCore``
  as a seekable :class:`BufferedBody` with ``size_hint`` set.  It is the
  same ``stream_io`` path as the offline CLI, the known-count container
  layout included, so containers are byte-identical to the threaded
  server's, to ``python -m repro_torch compress``'s and to the reference's.
* **The loop never touches the card.**  ``RequestCore.handle`` (every kernel
  launch, every copy to and from the card, every synchronize) runs only on a
  small compute thread pool; results come back through a self-pipe, and
  responses stream from the host spool the core wrote.  So one 64 MiB
  request on the card stalls no accept and no parse.  This module imports no
  ``torch``.
* **Paused-read backpressure.**  While a request executes, its connection's
  read side is unregistered; the kernel socket buffer, and eventually the
  peer's TCP window, absorb any pipelined backlog.  Responses stream from
  the result spool through a bounded write buffer, so a large result never
  sits in memory.
* **Admission before work.**  Per-client token buckets reject over-budget
  requests at header-parse time (the body is discarded, never spooled),
  connection-count overload sheds at accept time with a structured
  ``overloaded`` frame, and the ``RequestCore`` keeps its session-pool
  admission timeout for the compute stage.
* **Faults are answered.**  A card fault takes the ``RequestCore``'s path
  (charged to the plan's quarantine, a structured error on a connection that
  stays open); nothing is retried on the host.
* **Deadlines.**  Idle connections get ``idle_timeout``; once a request's
  first byte arrives, the whole frame must land within ``request_timeout``
  (the slow-loris budget).
* **Shutdown with card work in flight.**  ``stop()`` ends the loop; its
  cleanup waits for the compute pool, so every pooled session is checked
  back in before the caller closes the core.

The loop is transport-only; verbs, counters, and degradation live in
``RequestCore``.
"""
from __future__ import annotations

import collections
import io
import selectors
import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from time import monotonic
from typing import Callable, Deque, Dict, Iterator, Optional

from ..core.wire import write_varint

from . import protocol as P
from .ratelimit import RateLimiter
from .server import RequestCore, RequestError

__all__ = ["FrameParser", "BufferedBody", "ServiceFrontend"]

#: Write-buffer high watermark: pull response chunks only while below this.
_OUT_WATERMARK = 256 << 10
_RECV_BYTES = 64 << 10

# parser states
_MAGIC, _VERB, _HLEN, _HEADER, _BLEN, _BLOCK = range(6)


class BufferedBody:
    """A fully-received request body: quacks like ``BlockReader`` for
    :class:`RequestCore` (``size_hint``/``limit``/``bytes_read``/``drain``)
    and like a seekable file for ``stream_io`` (the known-count container
    path).
    """

    def __init__(self, f, total: int, size_hint: Optional[int]):
        self._f = f  # spool at position 0; None for a discarded body
        self.size_hint = size_hint
        self.limit: Optional[int] = None  # cap already enforced at parse time
        self.bytes_read = total  # the whole body has already arrived

    def read(self, n: int = -1) -> bytes:
        return self._f.read(n) if self._f is not None else b""

    def seekable(self) -> bool:
        return self._f is not None

    def seek(self, pos: int, whence: int = 0) -> int:
        return self._f.seek(pos, whence)

    def tell(self) -> int:
        return self._f.tell()

    def drain(self) -> int:
        return 0  # nothing unread remains on the wire

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class FrameParser:
    """Incremental ``OZS1`` request parser.

    ``feed(data, on_header)`` consumes whatever arrived and returns the list
    of *completed* requests as ``(verb, header, BufferedBody, reject)``
    tuples.  ``on_header(verb, header)`` runs the moment a header is fully
    parsed, before any body byte is buffered; returning a truthy value
    (e.g. a rate-limit rejection) switches the body to discard mode and is
    passed through as ``reject``.  Malformed input raises
    :class:`~repro_torch.service.protocol.ProtocolError`; the connection owns no
    resync point past that.
    """

    def __init__(self, *, max_body_bytes: int, spool_factory: Callable[[], io.IOBase]):
        self._buf = bytearray()
        self._spool_factory = spool_factory
        self.max_body_bytes = max_body_bytes
        self._reset_request()

    def _reset_request(self) -> None:
        self._state = _MAGIC
        self._need = len(P.REQUEST_MAGIC)
        self._varint = 0
        self._shift = 0
        self._verb: Optional[int] = None
        self._header: Optional[dict] = None
        self._spool = None
        self._body_bytes = 0
        self._reject = None

    @property
    def mid_request(self) -> bool:
        """True once any byte of the next request has been consumed."""
        return self._state != _MAGIC or len(self._buf) > 0

    @property
    def buffered(self) -> int:
        return len(self._buf)

    def _take_varint(self) -> Optional[int]:
        while self._buf:
            b = self._buf[0]
            del self._buf[:1]
            self._varint |= (b & 0x7F) << self._shift
            if not (b & 0x80):
                v = self._varint
                self._varint = 0
                self._shift = 0
                return v
            self._shift += 7
            if self._shift > 63:
                raise P.ProtocolError("varint overflow")
        return None

    def feed(self, data: bytes, on_header=None) -> list:
        self._buf += data
        out = []
        while True:
            if self._state == _MAGIC:
                if len(self._buf) < self._need:
                    break
                got = bytes(self._buf[: self._need])
                del self._buf[: self._need]
                if got != P.REQUEST_MAGIC:
                    raise P.ProtocolError(
                        f"bad magic {got!r} (expected {P.REQUEST_MAGIC!r}; wrong"
                        f" endpoint or a protocol-version mismatch)"
                    )
                self._state = _VERB
            elif self._state == _VERB:
                if not self._buf:
                    break
                verb = self._buf[0]
                del self._buf[:1]
                if verb not in P.VERBS:
                    raise P.ProtocolError(f"unknown verb {verb}")
                self._verb = verb
                self._state = _HLEN
            elif self._state == _HLEN:
                v = self._take_varint()
                if v is None:
                    break
                if v > P.MAX_HEADER_BYTES:
                    raise P.ProtocolError(f"header too large ({v} bytes)")
                self._need = v
                self._state = _HEADER
            elif self._state == _HEADER:
                if len(self._buf) < self._need:
                    break
                blob = bytes(self._buf[: self._need])
                del self._buf[: self._need]
                self._header = P._unpack_header(blob)
                if on_header is not None:
                    self._reject = on_header(self._verb, self._header)
                if self._reject is None:
                    self._spool = self._spool_factory()
                self._state = _BLEN
            elif self._state == _BLEN:
                v = self._take_varint()
                if v is None:
                    break
                if v == 0:
                    out.append(self._finish())
                    continue
                if v > P.MAX_BLOCK_BYTES:
                    raise P.ProtocolError(f"body block too large ({v} bytes)")
                if self._body_bytes + v > self.max_body_bytes:
                    raise P.ProtocolError(
                        f"body exceeds its limit of {self.max_body_bytes}"
                        f" bytes ({self._body_bytes + v}+ sent)"
                    )
                self._need = v
                self._state = _BLOCK
            elif self._state == _BLOCK:
                if not self._buf:
                    break
                take = min(self._need, len(self._buf))
                piece = self._buf[:take]
                del self._buf[:take]
                if self._spool is not None:
                    self._spool.write(piece)
                self._body_bytes += take
                self._need -= take
                if self._need == 0:
                    self._state = _BLEN
        return out

    def _finish(self):
        spool = self._spool
        if spool is not None:
            spool.seek(0)
        body = BufferedBody(
            spool, self._body_bytes, (self._header or {}).get("size")
        )
        req = (self._verb, self._header, body, self._reject)
        self._spool = None
        self._reset_request()
        return req

    def abandon(self) -> None:
        """Drop any partially-spooled body (connection is going away)."""
        if self._spool is not None:
            self._spool.close()
            self._spool = None


def _response_chunks(
    status: int, header: dict, body_file, block_bytes: int = P.DEFAULT_BLOCK_BYTES
) -> Iterator[bytes]:
    """Frame a response lazily: byte-identical to ``protocol.write_response``,
    but pulled chunk by chunk so a spooled result never sits in memory."""
    blob = P._pack_header(header)
    head = bytearray()
    head += P.RESPONSE_MAGIC
    head.append(status & 0xFF)
    write_varint(head, len(blob))
    head += blob
    yield bytes(head)
    if body_file is not None:
        while True:
            piece = body_file.read(block_bytes)
            if not piece:
                break
            prefix = bytearray()
            write_varint(prefix, len(piece))
            yield bytes(prefix) + piece
    yield b"\x00"


class _Conn:
    __slots__ = (
        "sock", "key", "parser", "out", "source", "body_file", "pending",
        "executing", "close_after_write", "last_activity", "request_started",
        "events",
    )

    def __init__(self, sock: socket.socket, key: str, parser: FrameParser, now: float):
        self.sock = sock
        self.key = key
        self.parser = parser
        self.out = bytearray()
        self.source: Optional[Iterator[bytes]] = None
        self.body_file = None
        self.pending: Deque = collections.deque()
        self.executing = False
        self.close_after_write = False
        self.last_activity = now
        self.request_started: Optional[float] = None
        self.events = 0  # current selector registration (0 = parked)


class ServiceFrontend:
    """One selector loop serving many connections against a ``RequestCore``.

    The listener is *borrowed*: the caller binds it (and, in a multi-process
    plane, shares the same fd across its workers) and decides its lifetime;
    ``owns_listener=True`` closes it on stop for standalone use.  ``core``
    is a :class:`~repro_torch.service.server.RequestCore` on any device; the
    loop thread uses only its ``bump``, ``max_body_bytes`` and spool factory,
    so it never touches the card.
    """

    def __init__(
        self,
        core: RequestCore,
        listener: socket.socket,
        *,
        max_conns: int = 512,
        compute_threads: int = 4,
        idle_timeout: float = 300.0,
        request_timeout: float = 60.0,
        rate_limiter: Optional[RateLimiter] = None,
        owns_listener: bool = False,
        name: str = "ozl-frontend",
    ):
        self.core = core
        self.max_conns = max_conns
        self.idle_timeout = idle_timeout
        self.request_timeout = request_timeout
        self.rate_limiter = rate_limiter
        self._owns_listener = owns_listener
        self._sel = selectors.DefaultSelector()
        self._listener = listener
        listener.setblocking(False)
        self._sel.register(listener, selectors.EVENT_READ, ("accept", None))
        # self-pipe: compute threads finish off-loop and must wake the
        # selector to deliver their results
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))
        self._completed: Deque = collections.deque()
        self._executor = ThreadPoolExecutor(
            max_workers=compute_threads, thread_name_prefix=name
        )
        self._conns: Dict[socket.socket, _Conn] = {}
        self._aux: Dict[socket.socket, Callable[[], None]] = {}
        self._stopping = threading.Event()
        self._conn_seq = 0
        self._last_scan = 0.0
        #: optional per-iteration hook (a plane worker's heartbeat push);
        #: runs on the loop thread, at most every selector tick
        self.on_tick: Optional[Callable[[], None]] = None
        self.counters = {
            "connections": 0,
            "active_connections": 0,
            "shed_connections": 0,
        }
        # prebuilt accept-overload frame: one optimistic send, then close
        buf = io.BytesIO()
        P.write_response(
            buf,
            P.STATUS_ERROR,
            {
                "error": "server overloaded: connection limit reached",
                "error_kind": "overloaded",
                "retry_after": 0.5,
            },
        )
        self._shed_frame = buf.getvalue()
        # serve transport counters through the stats verb unless the owner
        # (e.g. a plane worker, which aggregates) installs a richer provider
        core.stats_provider = self._default_stats

    def _default_stats(self) -> dict:
        st = {**self.core.stats(), **self.transport_stats()}
        if self.rate_limiter is not None:
            st["rate_limiter"] = self.rate_limiter.stats()
        return st

    # ------------------------------------------------------------ aux readers
    def add_reader(self, sock, callback: Callable[[], None]) -> None:
        """Poll an extra socket (a plane worker's control channel) on this
        loop; ``callback`` runs on the loop thread when it turns readable."""
        sock.setblocking(False)
        self._aux[sock] = callback
        self._sel.register(sock, selectors.EVENT_READ, ("aux", sock))

    # --------------------------------------------------------------- running
    def stop(self) -> None:
        """Ask the loop to exit (thread- and signal-safe)."""
        self._stopping.set()
        self._wake()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x01")
        except (BlockingIOError, BrokenPipeError, OSError):
            pass  # pipe full == a wakeup is already pending

    def serve_forever(self) -> None:
        try:
            while not self._stopping.is_set():
                events = self._sel.select(timeout=0.2)
                for sel_key, _mask in events:
                    kind, payload = sel_key.data
                    if kind == "accept":
                        self._on_accept()
                    elif kind == "wake":
                        self._drain_wake()
                    elif kind == "aux":
                        self._aux[payload]()
                    else:  # a connection
                        conn = payload
                        if _mask & selectors.EVENT_WRITE:
                            self._pump_write(conn)
                        if (
                            _mask & selectors.EVENT_READ
                            and conn.sock in self._conns
                        ):
                            self._on_readable(conn)
                self._drain_completed()
                self._scan_deadlines()
                if self.on_tick is not None:
                    self.on_tick()
        finally:
            self._cleanup()

    def _cleanup(self) -> None:
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        # compute threads may still be running requests; let them finish so
        # pooled sessions are checked back in before the core is torn down
        self._executor.shutdown(wait=True)
        self._drain_completed()  # discard results for already-closed conns
        for sock in list(self._aux):
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError):
                pass
        try:
            self._sel.unregister(self._wake_r)
        except (KeyError, ValueError):
            pass
        self._wake_r.close()
        self._wake_w.close()
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        if self._owns_listener:
            try:
                self._listener.close()
            except OSError:
                pass
        self._sel.close()

    # ---------------------------------------------------------------- accept
    def _on_accept(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # listener closed (shutdown) or transient accept error
            if self._stopping.is_set():
                sock.close()
                return
            if len(self._conns) >= self.max_conns:
                # shed at the door with a structured frame: one optimistic
                # non-blocking send (the frame is tiny), never a stall
                self.counters["shed_connections"] += 1
                self.core.bump(shed=1)
                try:
                    sock.setblocking(False)
                    sock.send(self._shed_frame)
                except OSError:
                    pass
                sock.close()
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass  # AF_UNIX
            self._conn_seq += 1
            if isinstance(addr, tuple):
                key = str(addr[0])  # per-peer-IP budget on TCP
            else:
                key = f"conn:{self._conn_seq}"  # Unix peers are indistinct
            now = monotonic()
            conn = _Conn(
                sock,
                key,
                FrameParser(
                    max_body_bytes=self.core.max_body_bytes,
                    spool_factory=self.core._spool,
                ),
                now,
            )
            self._conns[sock] = conn
            self.counters["connections"] += 1
            self.counters["active_connections"] += 1
            self._sel.register(sock, selectors.EVENT_READ, ("conn", conn))
            conn.events = selectors.EVENT_READ

    # ----------------------------------------------------------------- close
    def _close_conn(self, conn: _Conn, *, error: bool = False) -> None:
        if conn.sock not in self._conns:
            return
        if error:
            self.core.bump(errors=1)
        del self._conns[conn.sock]
        self.counters["active_connections"] -= 1
        if conn.events != 0:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.events = 0
        try:
            conn.sock.close()
        except OSError:
            pass
        conn.parser.abandon()
        for _verb, _header, body, _reject in conn.pending:
            body.close()
        conn.pending.clear()
        if conn.body_file is not None:
            conn.body_file.close()
            conn.body_file = None
        conn.source = None
        # an executing request keeps running; _drain_completed sees the conn
        # is gone and just discards the result

    # ------------------------------------------------------------- selectors
    def _update_events(self, conn: _Conn) -> None:
        if conn.sock not in self._conns:
            return
        want = 0
        if conn.out or conn.source is not None:
            want = selectors.EVENT_WRITE
        elif not conn.executing and not conn.pending:
            want = selectors.EVENT_READ
        # executing, or queued behind an in-flight request: parked entirely;
        # backpressure is the kernel socket buffer filling up; deadlines and
        # reset detection resume when the conn re-registers
        if want == conn.events:
            return
        if conn.events != 0:
            self._sel.unregister(conn.sock)
        if want != 0:
            self._sel.register(conn.sock, want, ("conn", conn))
        conn.events = want

    # ------------------------------------------------------------------ read
    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(_RECV_BYTES)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn, error=conn.parser.mid_request)
            return
        if not data:
            # clean hangup between requests is normal; mid-frame it's an error
            self._close_conn(conn, error=conn.parser.mid_request)
            return
        now = monotonic()
        conn.last_activity = now
        self._feed(conn, data, now)

    def _feed(self, conn: _Conn, data: bytes, now: float) -> None:
        try:
            reqs = conn.parser.feed(
                data, on_header=lambda v, h: self._on_header(conn, v, h)
            )
        except P.ProtocolError as err:
            self.core.bump(errors=1)
            self._respond(
                conn,
                P.STATUS_ERROR,
                {"error": f"malformed request: {err}"},
                None,
                close_after=True,
            )
            return
        conn.pending.extend(reqs)
        # the request clock covers the *current partial frame* only
        if conn.parser.mid_request:
            if conn.request_started is None:
                conn.request_started = now
        else:
            conn.request_started = None
        self._maybe_dispatch(conn)

    def _on_header(self, conn: _Conn, verb: int, header: dict):
        if self.rate_limiter is not None and verb in (
            P.VERB_COMPRESS, P.VERB_DECOMPRESS,
        ):
            ok, retry_after = self.rate_limiter.check(conn.key)
            if not ok:
                self.core.bump(verb=P.VERBS[verb], rate_limited=1)
                return (
                    "rate limit exceeded for this client",
                    {
                        "error_kind": "rate_limited",
                        "retry_after": round(max(retry_after, 0.001), 3),
                    },
                )
        return None

    # -------------------------------------------------------------- dispatch
    def _maybe_dispatch(self, conn: _Conn) -> None:
        if (
            conn.executing
            or conn.source is not None
            or conn.out
            or not conn.pending
        ):
            self._update_events(conn)
            return
        verb, header, body, reject = conn.pending.popleft()
        if reject is not None:
            body.close()
            msg, extra = reject
            self.core.bump(errors=1)
            self._respond(conn, P.STATUS_ERROR, {"error": msg, **extra}, None)
            return
        conn.executing = True
        self._update_events(conn)  # reads pause while the request runs
        self._executor.submit(self._execute, conn, verb, header, body)

    def _execute(self, conn: _Conn, verb: int, header: dict, body) -> None:
        """Runs on a compute thread, the only place the card is used; results
        travel back via the self-pipe."""
        try:
            try:
                resp_header, out = self.core.handle(verb, header, body)
                result = (P.STATUS_OK, resp_header, out)
            except RequestError as err:
                self.core.bump(errors=1)
                result = (P.STATUS_ERROR, {"error": str(err), **err.extra}, None)
            except Exception as err:  # noqa: BLE001 - answered, not fatal
                self.core.bump(errors=1)
                result = (
                    P.STATUS_ERROR,
                    {"error": f"{type(err).__name__}: {err}"},
                    None,
                )
        finally:
            body.close()
        self._completed.append((conn, result))
        self._wake()

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _drain_completed(self) -> None:
        while self._completed:
            conn, (status, header, out) = self._completed.popleft()
            conn.executing = False
            if conn.sock not in self._conns:
                if out is not None:
                    out.close()
                continue
            self._respond(conn, status, header, out)

    # ----------------------------------------------------------------- write
    def _respond(
        self, conn: _Conn, status: int, header: dict, out, *, close_after=False
    ) -> None:
        conn.body_file = out
        conn.source = _response_chunks(status, header, out)
        conn.close_after_write = conn.close_after_write or close_after
        self._pump_write(conn)

    def _pump_write(self, conn: _Conn) -> None:
        if conn.sock not in self._conns:
            return
        while True:
            while conn.source is not None and len(conn.out) < _OUT_WATERMARK:
                try:
                    conn.out += next(conn.source)
                except StopIteration:
                    conn.source = None
            if not conn.out:
                break
            try:
                n = conn.sock.send(conn.out)
            except (BlockingIOError, InterruptedError):
                self._update_events(conn)
                return
            except OSError:
                self._close_conn(conn, error=False)
                return
            if n <= 0:
                break
            conn.last_activity = monotonic()  # write progress arms the clock
            del conn.out[:n]
        if conn.source is None and not conn.out:
            # response fully flushed
            if conn.body_file is not None:
                conn.body_file.close()
                conn.body_file = None
            if conn.close_after_write:
                self._close_conn(conn)
                return
            conn.last_activity = monotonic()
            # pipelined bytes may already hold the next request
            self._feed(conn, b"", conn.last_activity)
        else:
            self._update_events(conn)

    # ------------------------------------------------------------- deadlines
    def _scan_deadlines(self) -> None:
        now = monotonic()
        if now - self._last_scan < 0.1:
            return
        self._last_scan = now
        for conn in list(self._conns.values()):
            if conn.executing:
                continue  # compute has its own timeouts (pool admission)
            if conn.source is not None or conn.out:
                # a peer that stops reading its response: no write progress
                # within request_timeout means the conn is wedged, not slow
                if now - conn.last_activity > self.request_timeout:
                    self._close_conn(conn, error=True)
            elif conn.request_started is not None:
                if now - conn.request_started > self.request_timeout:
                    # slow-loris: a frame that cannot finish in time
                    self._close_conn(conn, error=True)
            elif now - conn.last_activity > self.idle_timeout:
                self._close_conn(conn)

    # ----------------------------------------------------------------- stats
    def transport_stats(self) -> dict:
        return dict(self.counters)
