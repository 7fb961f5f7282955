"""Blocking client for the compression daemon, the port's copy of
``repro.service.client``: it speaks the reference's protocol byte for byte,
so it talks to either package's server, and never touches the card.

One :class:`ServiceClient` holds one persistent connection; every call is a
complete request/response exchange, so a client object is safe to reuse for
many operations (and cheap: connection setup happens once).  A connection the
server closed cleanly between exchanges (its idle timeout, or a restart) is
re-established transparently: every verb is stateless on the server, so the
request is simply resent once on a fresh connection.  File payloads stream
through in protocol blocks — the client never loads a file whole — and file
outputs are written with the same temp-file + atomic-rename discipline as
``repro_torch.core.stream_io`` (``client compress F -o F`` is safe).

    with ServiceClient("unix:/tmp/ozl.sock") as c:
        frame, info = c.compress_bytes(b"...", plan="text")
        data, info = c.decompress_bytes(frame)
        c.compress_file("corpus.bin", "corpus.ozl", plan="logs")
        print(c.stats()["requests"])
"""
from __future__ import annotations

import os
import random
import socket
import time
from typing import Callable, Iterable, Optional, Tuple, Union

from ..core.stream_io import DEFAULT_CHUNK_BYTES, _atomic_sink, _open

from . import protocol as P

__all__ = ["ServiceClient", "ServiceUnavailable", "ConnectionLost"]

PathOrBytes = Union[bytes, bytearray, memoryview]

# a request body is always passed as a zero-arg factory returning the block
# iterable, so a transparent reconnect can rebuild (and resend) it
BodyFactory = Callable[[], Iterable[bytes]]

# server-reported error kinds that mean "try again later", not "your request
# is wrong": the bounded-retry loop only ever retries these
RETRYABLE_ERROR_KINDS = frozenset(
    {"overloaded", "plan_quarantined", "rate_limited"}
)


class ServiceUnavailable(RuntimeError):
    """The server answered, but declined the request for now (shedding under
    overload, or the plan's circuit breaker is open).  Carries the server's
    ``retry_after`` hint in seconds when one was sent."""

    def __init__(
        self,
        message: str,
        *,
        kind: Optional[str] = None,
        retry_after: Optional[float] = None,
    ):
        super().__init__(message)
        self.kind = kind
        self.retry_after = retry_after


class ConnectionLost(P.ProtocolError):
    """The connection died before a complete response arrived: a server
    restart or a crashed worker.  Every verb is stateless and a request that
    never got a response is safe to resend, so clients that opted into
    ``retries=`` treat this exactly like an ``overloaded`` answer: back off,
    reconnect, try again."""


class ServiceClient:
    def __init__(
        self,
        address: Union[str, Tuple[str, int]],
        *,
        timeout: float = 60.0,
        block_bytes: int = P.DEFAULT_BLOCK_BYTES,
        retries: int = 0,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        rng: Optional[random.Random] = None,
    ):
        self.address = address
        self.timeout = timeout
        self.block_bytes = block_bytes
        # bounded retries for *retryable* server refusals (overload shedding,
        # plan quarantine): exponential backoff with full jitter, floored at
        # the server's retry_after hint.  retries=0 (default) keeps every
        # refusal a hard ServiceUnavailable.
        if retries < 0:
            raise ValueError("retries must be >= 0")
        self.retries = retries
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._rng = rng if rng is not None else random.Random()
        self._connect()

    def _connect(self) -> None:
        family, target = P.parse_address(self.address)
        sock = socket.socket(family, socket.SOCK_STREAM)
        try:
            sock.settimeout(self.timeout)
            sock.connect(target)
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        self._r = self._sock.makefile("rb")
        self._w = self._sock.makefile("wb")

    # -------------------------------------------------------------- exchange
    def _call(
        self,
        verb: int,
        header: dict,
        body: Optional[BodyFactory] = None,
    ) -> Tuple[dict, P.BlockReader]:
        """One request/response (with bounded retries) -> (header, body).

        Raises :class:`ServiceUnavailable` when the server sheds or the
        plan is quarantined and the retry budget is spent, RuntimeError on any
        other server-reported error, ProtocolError on malformed traffic.
        Connection-level failures — refused while a worker restarts, reset
        when one dies mid-exchange — retry under the same jittered budget.
        The caller must drain the returned body before issuing the next call.
        """
        for attempt in range(self.retries + 1):
            try:
                return self._call_once(verb, header, body)
            except ServiceUnavailable as err:
                if attempt >= self.retries:
                    raise
                self._backoff(attempt, err.retry_after)
            except (ConnectionError, ConnectionLost):
                # ECONNREFUSED / ECONNRESET / died-before-response: the far
                # side is restarting or a worker crashed.  Drop the dead
                # connection now; the next attempt redials from scratch.
                if attempt >= self.retries:
                    raise
                self.close()
                self._backoff(attempt, None)
        raise AssertionError("unreachable")

    def _backoff(self, attempt: int, retry_after: Optional[float]) -> None:
        # full jitter (uniform over [0, cap]) decorrelates a thundering herd
        # of shed clients; the server's retry_after hint is a *floor* — it
        # knows how long the congestion it saw actually lasts
        cap = min(self.backoff_max, self.backoff_base * (2 ** attempt))
        delay = self._rng.uniform(0.0, cap)
        if retry_after:
            delay = max(delay, float(retry_after))
        time.sleep(delay)

    def _call_once(
        self,
        verb: int,
        header: dict,
        body: Optional[BodyFactory] = None,
    ) -> Tuple[dict, P.BlockReader]:
        """A single exchange on the wire.

        A server that closed the connection cleanly before answering (idle
        timeout, restart) gets one transparent retry on a fresh connection —
        the protocol is stateless, so a resend is always safe.  A truncation
        mid-response stays a hard error: fail closed, never guess.
        """
        if self._sock is None:
            self._connect()
        got = None
        for attempt in (0, 1):
            try:
                P.write_request(
                    self._w, verb, header, body() if body is not None else None
                )
                got = P.read_response_or_eof(self._r)
            except (BrokenPipeError, ConnectionResetError):
                got = None
            if got is not None:
                break
            if attempt:
                raise ConnectionLost(
                    "server closed the connection before responding"
                )
            self.close()
            self._connect()
        status, resp, rbody = got
        if status == P.STATUS_ERROR:
            rbody.drain()
            message = f"service error: {resp.get('error', 'unknown error')}"
            kind = resp.get("error_kind")
            if kind in RETRYABLE_ERROR_KINDS:
                retry_after = resp.get("retry_after")
                raise ServiceUnavailable(
                    message,
                    kind=kind,
                    retry_after=None if retry_after is None else float(retry_after),
                )
            raise RuntimeError(message)
        return resp, rbody

    @staticmethod
    def _nbytes(data: PathOrBytes) -> int:
        # len(memoryview) counts elements, not bytes, for itemsize > 1
        return memoryview(data).nbytes

    def _bytes_body(self, data: PathOrBytes) -> BodyFactory:
        return lambda: P.iter_body_blocks(data, self.block_bytes)

    def _file_body(self, fin) -> BodyFactory:
        """Body factory over an open file; rewinds for a reconnect retry when
        the source is seekable, and refuses the retry (fail closed, with the
        real cause) when it is not."""
        try:
            pos = fin.tell() if fin.seekable() else None
        except (AttributeError, OSError, ValueError):
            pos = None
        used = [False]

        def factory() -> Iterable[bytes]:
            if used[0]:
                if pos is None:
                    raise P.ProtocolError(
                        "connection lost and the request body is not"
                        " rewindable (non-seekable source)"
                    )
                fin.seek(pos)
            used[0] = True
            return P.iter_body_blocks(fin, self.block_bytes)

        return factory

    # -------------------------------------------------------------- commands
    def ping(self) -> dict:
        resp, body = self._call(P.VERB_PING, {})
        body.drain()
        return resp

    def stats(self) -> dict:
        resp, body = self._call(P.VERB_STATS, {})
        body.drain()
        return resp

    def metrics(self) -> bytes:
        """Prometheus exposition text (the stats verb with an additive
        ``format`` header key — same counters, scrape-ready rendering)."""
        resp, body = self._call(P.VERB_STATS, {"format": "prometheus"})
        return body.read()

    def compress_bytes(
        self,
        data: PathOrBytes,
        plan: str,
        *,
        chunk_bytes: Optional[int] = DEFAULT_CHUNK_BYTES,
    ) -> Tuple[bytes, dict]:
        """Compress an in-memory payload -> (wire frame, server stats)."""
        header = {
            "plan": plan,
            "size": self._nbytes(data),
            "chunk_bytes": int(chunk_bytes or 0),
        }
        resp, body = self._call(P.VERB_COMPRESS, header, self._bytes_body(data))
        return body.read(), resp

    def decompress_bytes(self, frame: PathOrBytes) -> Tuple[bytes, dict]:
        """Universal decode of an in-memory frame -> (content bytes, stats)."""
        resp, body = self._call(
            P.VERB_DECOMPRESS, {"size": self._nbytes(frame)}, self._bytes_body(frame)
        )
        return body.read(), resp

    def compress_file(
        self,
        src,
        dst,
        plan: str,
        *,
        chunk_bytes: Optional[int] = DEFAULT_CHUNK_BYTES,
    ) -> dict:
        """Stream a file through the daemon -> stats dict (atomic dst)."""
        size = os.path.getsize(src) if isinstance(src, (str, os.PathLike)) else None
        header = {"plan": plan, "chunk_bytes": int(chunk_bytes or 0)}
        if size is not None:
            header["size"] = size
        with _open(src, "rb") as fin:
            resp, body = self._call(P.VERB_COMPRESS, header, self._file_body(fin))
        self._body_to_file(body, dst)
        return resp

    def decompress_file(self, src, dst) -> dict:
        """Stream any frame/container through the universal decoder -> stats."""
        size = os.path.getsize(src) if isinstance(src, (str, os.PathLike)) else None
        header = {} if size is None else {"size": size}
        with _open(src, "rb") as fin:
            resp, body = self._call(
                P.VERB_DECOMPRESS, header, self._file_body(fin)
            )
        self._body_to_file(body, dst)
        return resp

    def _body_to_file(self, body: P.BlockReader, dst) -> None:
        with _atomic_sink(dst) as fout:
            while True:
                piece = body.read(self.block_bytes)
                if not piece:
                    break
                fout.write(piece)

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._sock is None:
            return
        for f in (self._w, self._r):
            try:
                f.close()
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None  # _call_once redials on the next use

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
