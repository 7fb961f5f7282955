"""The compression daemon: hot sessions on the card behind a socket, the
port's copy of ``repro.service.server``.

Two layers live here:

* :class:`RequestCore`: the transport-independent verb engine.  It owns
  exactly the state the one-shot CLI rebuilds on every invocation (resolved
  plans, the coder-table cache, session pools, the shared decoder) plus the
  degradation machinery (plan quarantine, admission shedding) and per-verb
  latency accounting.  Because it runs the same ``stream_io`` code path as
  the offline CLI, its frames are byte-identical to ``python -m repro_torch
  compress``'s, and to the reference's.

* :class:`CompressionServer`: the thread-per-connection daemon (Unix/TCP,
  persistent connections, blocking I/O).

Every pooled session and the shared decoder run on one device, resolved once
at construction (``device=``, the card unless the caller names the CPU;
without a card construction raises ``NoCardError``).  That takes the place
of the reference's ``backend=``, and there is no host failover: the
reference's sessions retry a chunk on the host when the device fails
(``failover=``), so a device fault never reaches its ``RequestCore``.  Here
it does.  A real one (a ``KernelError``, a CUDA error) is a
``RuntimeError`` and takes the reference's path for a failed session: it is
charged to the plan digest's
:class:`~repro_torch.reliability.failover.Quarantine` and answered with a
structured error on a connection that stays usable.  A card fault injected
at ``device.encode.*`` is an :class:`InjectedDeviceFault`, an ``OSError``
the reference's handler would take for transport trouble: it is caught by
its type, charged the same way and answered with
``error_kind="device_fault"``.  Every other ``OSError`` (reading the body,
writing the spool) keeps the reference's transport path.  Nothing is ever
retried on the host.

Memory stays bounded under load from three directions: ``max_clients`` caps
concurrent requests, each compression session's in-flight ``window`` bounds
chunks per request (the server reads request blocks only as the window
frees, so TCP flow control pushes back on fast senders), and results spool
to disk past ``spool_bytes``.  A request that fails never wedges its worker:
the body is drained (or the connection dropped), an error response is
attempted, and the checked-out session is returned, or discarded if it
failed mid-use.
"""
from __future__ import annotations

import io
import os
import socket
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from .. import _device
from ..core import stream_io, wire
from ..core.engine import DecompressorSession, ExecScratch, SessionPool, resolve_cache_info
from ..core.stream_io import DEFAULT_CHUNK_BYTES
from ..reliability.failover import Quarantine
from ..reliability.faults import InjectedDeviceFault, crash_point
from . import protocol as P
from .metrics import CONTENT_TYPE as METRICS_CONTENT_TYPE
from .metrics import render_prometheus
from .ratelimit import RateLimiter

__all__ = ["CompressionServer", "RequestCore", "RequestError"]

MAX_CHUNK_BYTES = 256 << 20

#: Entries kept in each verb's sliding latency window (quantiles + req/s).
LATENCY_WINDOW = 1024


class RequestError(Exception):
    """Request-level failure that carries structured response-header fields.

    ``extra`` is merged into the error response header: the transport for
    machine-readable degradation signals (``error_kind``, ``retry_after``)
    without touching the version-locked protocol framing.
    """

    def __init__(self, message: str, **extra):
        super().__init__(message)
        self.extra = dict(extra)


class RequestCore:
    """Transport-independent verb engine.

    ``handle(verb, header, body)`` runs one request to completion and returns
    ``(response_header, body_file_or_None)``; the caller frames and writes
    the response (and closes the body file).  Failures *raise*: a
    :class:`RequestError` carries structured degradation fields
    (``error_kind``/``retry_after``), any other exception is a generic
    request failure, and protocol/transport errors propagate untouched so
    the transport can decide whether the connection is still usable.

    The ``body`` argument is duck-typed: anything with ``read``/``drain``/
    ``bytes_read``/``size_hint``/``limit`` works (the threaded server passes
    a live :class:`~repro_torch.service.protocol.BlockReader`).
    """

    def __init__(
        self,
        registry,
        *,
        sessions_per_plan: int = 2,
        n_workers: Optional[int] = None,
        window: Optional[int] = None,
        request_timeout: float = 60.0,
        spool_bytes: int = 32 << 20,
        max_body_bytes: int = 1 << 30,
        admission_timeout: Optional[float] = None,
        device=_device.DEFAULT_DEVICE,
        quarantine_threshold: int = 3,
        quarantine_cooldown_s: float = 10.0,
    ):
        # resolved once: every pooled session and the decoder run here
        self.device = _device.resolve_device(device)
        self.registry = registry
        self.n_workers = n_workers
        self.window = window
        self.request_timeout = request_timeout
        self.spool_bytes = spool_bytes
        self.max_body_bytes = max_body_bytes
        # admission control: None keeps the backpressure behaviour (block up
        # to request_timeout for a pooled session); a float sheds instead:
        # waiters past the deadline get a structured "overloaded" error with
        # a retry_after hint rather than a connection drop
        self.admission_timeout = admission_timeout
        # per-plan-digest circuit breaker: a plan whose requests keep failing
        # inside their session stops eating pool capacity until its cooldown
        self.quarantine = Quarantine(
            threshold=quarantine_threshold, cooldown_s=quarantine_cooldown_s
        )
        self.pool = SessionPool(max_per_key=sessions_per_plan)
        # one process-wide coder-table cache: every session (all plans, both
        # directions) shares it, so the stats verb's hit/miss counters
        # describe the whole process's table-build traffic
        self._scratch = ExecScratch()
        self._decoder = DecompressorSession(
            device=self.device, n_workers=n_workers, window=window, scratch=self._scratch
        )
        self.started = time.monotonic()
        # the owner may install a richer stats source (the threaded server
        # adds connection counters); handle() serves whatever this returns
        self.stats_provider: Callable[[], dict] = self.stats
        self._stats_lock = threading.Lock()
        self._counters = {
            "errors": 0,
            "shed": 0,
            "rate_limited": 0,
            "requests": {name: 0 for name in P.VERBS.values()},
            "bytes_in": 0,
            "bytes_out": 0,
        }
        self._latency: Dict[str, deque] = {
            name: deque(maxlen=LATENCY_WINDOW) for name in P.VERBS.values()
        }

    # -------------------------------------------------------------- plumbing
    def bump(self, *, verb: Optional[str] = None, **deltas: int) -> None:
        with self._stats_lock:
            if verb is not None:
                self._counters["requests"][verb] += 1
            for k, v in deltas.items():
                self._counters[k] += v

    def record_latency(self, verb: str, seconds: float) -> None:
        with self._stats_lock:
            self._latency[verb].append((time.monotonic(), seconds))

    def _spool(self):
        return tempfile.SpooledTemporaryFile(max_size=self.spool_bytes)

    def session_key(self, entry) -> str:
        """Ensure a pool factory exists for this plan -> its digest key."""
        if entry.digest not in self.pool.keys():
            comp = entry.compressor
            kw = dict(
                device=self.device,
                chunk_bytes=None,
                n_workers=self.n_workers,
                window=self.window,
                scratch=self._scratch,
            )
            self.pool.register(entry.digest, lambda: comp.session(**kw))
        return entry.digest

    def ping_header(self) -> dict:
        return {
            "ok": True,
            "protocol_version": P.PROTOCOL_VERSION,
            "plans": len(self.registry),
            "uptime_s": round(time.monotonic() - self.started, 3),
            "pid": os.getpid(),
        }

    # ------------------------------------------------------------- dispatch
    def handle(
        self, verb: int, header: dict, body
    ) -> Tuple[dict, Optional[io.IOBase]]:
        """Run one request -> (response header, body file or None).

        The caller owns (and must close) the returned body file.  Raises on
        any failure; no response bytes have been produced by then, so the
        transport can always frame a structured error instead.
        """
        self.bump(verb=P.VERBS[verb])
        t0 = time.perf_counter()
        if verb == P.VERB_PING:
            body.drain()
            out: Tuple[dict, Optional[io.IOBase]] = (self.ping_header(), None)
        elif verb == P.VERB_STATS:
            body.drain()
            out = self._do_stats(header)
        elif verb == P.VERB_COMPRESS:
            out = self._do_compress(header, body)
        elif verb == P.VERB_DECOMPRESS:
            out = self._do_decompress(header, body)
        else:  # unreachable: the request parser validated the verb
            raise P.ProtocolError(f"unknown verb {verb}")
        self.record_latency(P.VERBS[verb], time.perf_counter() - t0)
        return out

    def _do_stats(self, header: dict) -> Tuple[dict, Optional[io.IOBase]]:
        st = self.stats_provider()
        if header.get("format") == "prometheus":
            text = render_prometheus(st)
            return (
                {"content_type": METRICS_CONTENT_TYPE, "size": len(text)},
                io.BytesIO(text),
            )
        return st, None

    def _body_budget(self, body) -> Optional[int]:
        """Narrow the body budget to the declared size -> that size (if any).

        The transport already installed ``max_body_bytes`` as the hard
        ceiling; the client's declared ``size`` may only *narrow* it, never
        widen it: a hostile ``size=2**60`` is rejected up front (and the
        reject path's ``drain()`` stays bounded by the ceiling).
        """
        declared = body.size_hint
        if declared is not None:
            if declared > self.max_body_bytes:
                raise ValueError(
                    f"declared size {declared} exceeds the server's"
                    f" per-request limit of {self.max_body_bytes} bytes"
                )
            # cut a lying sender off at the first over-budget block, before
            # its body is buffered, on the bare-frame path too (which reads
            # the whole payload at once)
            body.limit = declared
        return declared

    def _do_compress(self, header: dict, body) -> Tuple[dict, io.IOBase]:
        key = header.get("plan")
        if not key or not isinstance(key, str):
            raise ValueError("compress request needs a 'plan' header")
        entry = self.registry.resolve(key)
        chunk_bytes = header.get("chunk_bytes")
        if chunk_bytes is None:
            chunk_bytes = DEFAULT_CHUNK_BYTES
        chunk_bytes = int(chunk_bytes)
        if chunk_bytes < 0 or chunk_bytes > MAX_CHUNK_BYTES:
            raise ValueError(f"bad chunk_bytes {chunk_bytes}")
        declared = self._body_budget(body)
        remaining = self.quarantine.blocked(entry.digest)
        if remaining is not None:
            raise RequestError(
                f"plan {key!r} is quarantined after repeated failures",
                error_kind="plan_quarantined",
                retry_after=round(remaining, 3),
            )
        pool_key = self.session_key(entry)
        admission = (
            self.request_timeout
            if self.admission_timeout is None
            else self.admission_timeout
        )
        crash_point("svc.request.compress.begin")
        out = self._spool()
        try:
            try:
                with self.pool.acquire(pool_key, timeout=admission) as sess:
                    stats = stream_io.compress_file(
                        body,
                        out,
                        entry.compressor.plan,
                        chunk_bytes=chunk_bytes or None,
                        session=sess,
                    )
            except TimeoutError:
                # every pooled session busy past the admission deadline: shed
                # with a structured signal instead of tying up the worker (or,
                # with shedding disabled, keep the historical generic error)
                if self.admission_timeout is None:
                    raise
                self.bump(shed=1)
                raise RequestError(
                    f"server overloaded: no free session for plan {key!r}"
                    f" within {admission:.3g}s",
                    error_kind="overloaded",
                    retry_after=round(max(admission, 0.05), 3),
                ) from None
            except InjectedDeviceFault as err:
                # a card fault is the plan's, though it is an OSError: no
                # session fails over to the host here, so it is charged and
                # answered on a connection that stays usable
                self.quarantine.record_failure(entry.digest)
                raise RequestError(
                    f"{type(err).__name__}: {err}", error_kind="device_fault"
                ) from err
            except (P.ProtocolError, OSError, socket.timeout):
                raise  # transport trouble, not the plan's fault
            except Exception:
                # the session died mid-request: charge the plan digest so a
                # poisoned plan trips its breaker instead of burning through
                # fresh pool sessions forever
                self.quarantine.record_failure(entry.digest)
                raise
            self.quarantine.record_success(entry.digest)
            # fail closed on size lies: compare the bytes that actually
            # arrived (not stats["bytes_in"], which on the known-size chunked
            # path *is* the declared value) against the declaration: a short
            # body must never be silently compressed as if complete
            body.drain()
            if declared is not None and body.bytes_read != declared:
                raise ValueError(
                    f"request declared size={declared} but sent"
                    f" {body.bytes_read} bytes"
                )
            crash_point("svc.request.compress.mid")
            self.bump(bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"])
            out.seek(0)
            return (
                {
                    **stats,
                    "plan_id": entry.plan_id,
                    "digest": entry.digest,
                    "size": stats["bytes_out"],
                },
                out,
            )
        except BaseException:
            out.close()
            raise

    def _do_decompress(self, header: dict, body) -> Tuple[dict, io.IOBase]:
        self._body_budget(body)
        crash_point("svc.request.decompress.begin")
        out = self._spool()
        try:
            stats = stream_io.decompress_file(body, out, session=self._decoder)
            if body.drain():
                raise wire.FrameError("trailing garbage after frame")
            self.bump(bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"])
            out.seek(0)
            return {**stats, "size": stats["bytes_out"]}, out
        except BaseException:
            out.close()
            raise

    # ----------------------------------------------------------------- stats
    def _latency_stats(self) -> Dict[str, dict]:
        now = time.monotonic()
        out: Dict[str, dict] = {}
        with self._stats_lock:
            windows = {verb: list(ring) for verb, ring in self._latency.items()}
        for verb, entries in windows.items():
            recent = [(t, s) for t, s in entries if now - t <= 60.0]
            if not recent:
                continue
            durs = sorted(s for _t, s in recent)

            def q(p: float) -> float:
                return durs[min(len(durs) - 1, int(round(p * (len(durs) - 1))))]

            span = max(now - min(t for t, _s in recent), 1e-9)
            out[verb] = {
                "n": len(durs),
                "p50_ms": round(q(0.50) * 1e3, 3),
                "p99_ms": round(q(0.99) * 1e3, 3),
                "req_s": round(len(durs) / span, 3),
            }
        return out

    def counters(self) -> dict:
        with self._stats_lock:
            return {
                "errors": self._counters["errors"],
                "shed": self._counters["shed"],
                "rate_limited": self._counters["rate_limited"],
                "requests": dict(self._counters["requests"]),
                "bytes_in": self._counters["bytes_in"],
                "bytes_out": self._counters["bytes_out"],
            }

    def stats(self) -> dict:
        return {
            **self.ping_header(),
            **self.counters(),
            "registry": self.registry.entries(),
            "sessions": self.pool.stats(),
            "decoder": dict(self._decoder.stats),
            "latency": self._latency_stats(),
            # cache effectiveness: a cold resolve or coder-table rebuild per
            # request is exactly the kind of throughput cliff the sessions
            # exist to prevent, so the counters are surfaced
            "resolve_cache": resolve_cache_info(),
            "coder_cache": self._scratch.table_cache_info(),
            # the key is kept for the reference's readers: no device is
            # ever benched for the host here, so it is empty, as a reference
            # server on the host backend reports it
            "backend_health": {},
            "quarantine": self.quarantine.stats(),
        }

    def close(self) -> None:
        self.pool.close()
        self._decoder.close()


class CompressionServer:
    """Thread-per-connection daemon over one :class:`RequestCore`.

    ``device`` (the card unless the caller names the CPU) takes the place of
    the reference's ``backend``; without a card construction raises
    ``NoCardError`` before any socket is bound.
    """

    def __init__(
        self,
        registry=None,
        *,
        socket_path: Optional[str] = None,
        host: Optional[str] = None,
        port: int = 0,
        max_clients: int = 8,
        sessions_per_plan: int = 2,
        n_workers: Optional[int] = None,
        window: Optional[int] = None,
        request_timeout: float = 60.0,
        idle_timeout: float = 300.0,
        spool_bytes: int = 32 << 20,
        max_body_bytes: int = 1 << 30,
        admission_timeout: Optional[float] = None,
        device=_device.DEFAULT_DEVICE,
        quarantine_threshold: int = 3,
        quarantine_cooldown_s: float = 10.0,
        rate_limit: Optional[float] = None,
        rate_burst: Optional[float] = None,
    ):
        if (socket_path is None) == (host is None):
            raise ValueError("pass exactly one of socket_path= or host=")
        if registry is None:
            from .registry import PlanRegistry

            registry = PlanRegistry()
        self.core = RequestCore(
            registry,
            sessions_per_plan=sessions_per_plan,
            n_workers=n_workers,
            window=window,
            request_timeout=request_timeout,
            spool_bytes=spool_bytes,
            max_body_bytes=max_body_bytes,
            admission_timeout=admission_timeout,
            device=device,
            quarantine_threshold=quarantine_threshold,
            quarantine_cooldown_s=quarantine_cooldown_s,
        )
        self.core.stats_provider = self.stats
        self.registry = registry
        self.max_clients = max_clients
        self.request_timeout = request_timeout
        # a persistent client legitimately pauses between requests far longer
        # than any single request takes, so idleness has its own timeout
        self.idle_timeout = idle_timeout
        self.max_body_bytes = max_body_bytes
        # per-connection token buckets: Unix-socket peers are indistinct, so
        # the key is the connection itself; a flooding client starves only
        # its own budget, never a neighbour's
        self.rate_limiter = (
            RateLimiter(rate_limit, rate_burst) if rate_limit else None
        )
        self._shutdown = threading.Event()
        self._conn_lock = threading.Lock()
        self._conns: set = set()
        self._accept_thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self._stats = {"connections": 0, "active_connections": 0}

        if socket_path is not None:
            self.socket_path: Optional[str] = str(socket_path)
            Path(self.socket_path).unlink(missing_ok=True)
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(self.socket_path)
            self.address = f"unix:{self.socket_path}"
        else:
            self.socket_path = None
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            bound_host, bound_port = self._listener.getsockname()[:2]
            self.address = f"{bound_host}:{bound_port}"
        self._listener.listen(max_clients * 2)
        # accept() must wake up for shutdown: closing a socket does not
        # reliably interrupt a thread blocked in accept(), so poll instead
        self._listener.settimeout(0.1)
        self._executor = ThreadPoolExecutor(
            max_workers=max_clients, thread_name_prefix="ozl-serve"
        )

    @property
    def device(self):
        return self.core.device

    @property
    def pool(self):
        return self.core.pool

    @property
    def quarantine(self):
        return self.core.quarantine

    @property
    def admission_timeout(self):
        return self.core.admission_timeout

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "CompressionServer":
        """Accept connections on a background thread (returns immediately)."""
        self._accept_thread = threading.Thread(
            target=self.serve_forever, name="ozl-serve-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def serve_forever(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _addr = self._listener.accept()
            except socket.timeout:
                continue  # periodic shutdown-flag check
            except OSError:
                break  # listener closed by shutdown()
            with self._conn_lock:
                if self._shutdown.is_set():
                    conn.close()
                    break
                self._conns.add(conn)
            self._bump(connections=1, active_connections=1)
            self._executor.submit(self._handle_conn, conn)

    def request_stop(self) -> None:
        """Ask the accept loop to exit (signal-handler safe, non-blocking).

        ``serve_forever`` returns shortly after; call :meth:`shutdown` (or let
        the ``finally`` around ``serve_forever`` do it) for the full cleanup.
        """
        self._shutdown.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def shutdown(self) -> None:
        """Stop accepting, drop live connections, release every session."""
        self.request_stop()
        with self._conn_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._executor.shutdown(wait=True)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        self.core.close()
        if self.socket_path:
            Path(self.socket_path).unlink(missing_ok=True)

    def __enter__(self) -> "CompressionServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()

    # -------------------------------------------------------------- plumbing
    def _bump(self, **deltas: int) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def _handle_conn(self, sock: socket.socket) -> None:
        r = sock.makefile("rb")
        w = sock.makefile("wb")
        conn_key = f"conn:{id(sock):x}"
        try:
            while not self._shutdown.is_set():
                # between requests the connection may sit idle for a long
                # time (idle_timeout); once a request has started, every
                # read must make progress within request_timeout
                sock.settimeout(self.idle_timeout)
                try:
                    first = r.read(1)
                except (OSError, socket.timeout):
                    # idle past idle_timeout, or hung up between requests:
                    # not an error, so reclaim the worker quietly
                    return
                if not first:
                    return  # clean client hangup between requests
                sock.settimeout(self.request_timeout)
                try:
                    verb, header, body = P.read_request_rest(r, first)
                except (P.ProtocolError, OSError, socket.timeout):
                    # a *started* request that stalls or breaks is real
                    # malformed traffic
                    self.core.bump(errors=1)
                    self._try_error(w, "malformed request (connection dropped)")
                    return
                # hard cap installed before any dispatch or validation, so
                # *every* later drain, including error paths that reject the
                # request before its declared size is even looked at, is
                # bounded; a flood hits the limit and drops the connection
                body.limit = self.max_body_bytes
                try:
                    self._dispatch(verb, header, body, w, conn_key)
                except (P.ProtocolError, OSError, socket.timeout):
                    # framing is broken (or the peer vanished): no resync
                    # point exists, so drop the connection
                    self.core.bump(errors=1)
                    self._try_error(w, "request body unreadable")
                    return
                except Exception as err:
                    # request-level failure with intact framing: report and
                    # keep serving this connection
                    self.core.bump(errors=1)
                    extra = getattr(err, "extra", None)
                    if isinstance(extra, dict):
                        msg = str(err)
                    else:
                        msg, extra = f"{type(err).__name__}: {err}", None
                    try:
                        body.drain()
                    except (P.ProtocolError, OSError, socket.timeout):
                        self._try_error(w, msg, extra)
                        return
                    if not self._try_error(w, msg, extra):
                        return
        finally:
            for f in (w, r):
                try:
                    f.close()
                except OSError:
                    pass
            try:
                sock.close()
            except OSError:
                pass
            with self._conn_lock:
                self._conns.discard(sock)
            self._bump(active_connections=-1)

    def _try_error(self, w, message: str, extra: Optional[dict] = None) -> bool:
        try:
            P.write_response(w, P.STATUS_ERROR, {"error": message, **(extra or {})})
            return True
        except (OSError, ValueError):
            return False

    # ------------------------------------------------------------- dispatch
    def _dispatch(
        self, verb: int, header: dict, body: P.BlockReader, w, conn_key: str
    ) -> None:
        if self.rate_limiter is not None and verb in (
            P.VERB_COMPRESS, P.VERB_DECOMPRESS,
        ):
            ok, retry_after = self.rate_limiter.check(conn_key)
            if not ok:
                self.core.bump(verb=P.VERBS[verb], rate_limited=1)
                raise RequestError(
                    "rate limit exceeded for this client",
                    error_kind="rate_limited",
                    retry_after=round(max(retry_after, 0.001), 3),
                )
        resp_header, out = self.core.handle(verb, header, body)
        try:
            if out is None:
                P.write_response(w, P.STATUS_OK, resp_header)
            else:
                P.write_response(
                    w, P.STATUS_OK, resp_header, P.iter_body_blocks(out)
                )
        finally:
            if out is not None:
                out.close()

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._stats_lock:
            conn_counters = dict(self._stats)
        st = {
            **self.core.stats(),
            "address": self.address,
            "max_clients": self.max_clients,
            **conn_counters,
        }
        if self.rate_limiter is not None:
            st["rate_limiter"] = self.rate_limiter.stats()
        return st
