"""The port's non-blocking service frontend on the CPU, against the reference's:
``repro_torch.service.ServiceFrontend`` over ``RequestCore(device="cpu")``.

The six frontend cases of ``tests/test_service_fuzz.py`` (hostile blobs,
slow-loris partial frames, a mid-frame disconnect storm, the rate limit,
shedding over capacity, pipelined requests) run against the port's frontend
with a copy of their harness.  Differential tests hold the port's
``FrameParser`` against the reference's on seeded request streams cut at the
same random points (every completed request, ``mid_request``, ``buffered`` and
every ``ProtocolError`` equal after each ``feed``), and ``_response_chunks``
against both packages' framing, tolerance 0.  Containers through the port's
frontend equal the offline ``compress``, the threaded server's and the
reference frontend's, each package's client on the other's frontend.  A
request held inside ``handle`` leaves the loop answering other connections,
``stop()`` with a request in flight waits for it and checks its session back
in, a card fault takes the threaded server's path, and the frontend's stats
render equally through both packages' ``render_prometheus``.
"""
import ast
import contextlib
import io
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.codecs import profiles as RPF  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import serial as ref_serial  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro.service import PlanRegistry as RefRegistry  # noqa: E402
from repro.service import RequestCore as RefCore  # noqa: E402
from repro.service import ServiceClient as RefClient  # noqa: E402
from repro.service import ServiceFrontend as RefFrontend  # noqa: E402
from repro.service import frontend as RF  # noqa: E402
from repro.service import protocol as RP  # noqa: E402
from repro.service.metrics import render_prometheus as ref_render  # noqa: E402
from repro_torch.codecs import profiles as PF  # noqa: E402
from repro_torch.core import stream_io  # noqa: E402
from repro_torch.core.graph import GraphBuilder  # noqa: E402
from repro_torch.kernels.ops import KernelError  # noqa: E402
from repro_torch.reliability import FaultPlan  # noqa: E402
from repro_torch.service import (  # noqa: E402
    CompressionServer,
    PlanRegistry,
    RateLimiter,
    RequestCore,
    ServiceClient,
    ServiceFrontend,
    ServiceUnavailable,
    render_prometheus,
)
from repro_torch.service import frontend as F  # noqa: E402
from repro_torch.service import protocol as SP  # noqa: E402

CPU = "cpu"
DATA = b"fuzz corpus: level=INFO svc=auth handled\n" * 200
TEXT = b"req=deadbeef level=INFO svc=auth handled in 42us\n" * 800  # ~39 KB
CHUNK = 8 << 10
TIMEOUT = 20.0
FRONTEND_SOURCE = Path(F.__file__)


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both packages' resolve caches empty, so that a frame's selector choices
    are made on this test's data in each package."""
    ref_engine.resolve_cache_clear()
    repro_torch.resolve_cache_clear()


# ------------------------------------------------ the reference's harness
def _connect(server) -> socket.socket:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(10.0)
    s.connect(server.socket_path)
    return s


def _send_then_close(server, blob: bytes) -> bytes:
    """Write raw bytes, half-close, read whatever the server answers (a reset
    mid-exchange reads as no response)."""
    s = _connect(server)
    out = bytearray()
    try:
        if blob:
            s.sendall(blob)
        s.shutdown(socket.SHUT_WR)
        while True:
            piece = s.recv(65536)
            if not piece:
                return bytes(out)
            out += piece
    except (ConnectionResetError, BrokenPipeError):
        return bytes(out)
    finally:
        s.close()


def _valid_request_bytes(chunk_bytes: int = 4096) -> bytes:
    buf = io.BytesIO()
    SP.write_request(buf, SP.VERB_COMPRESS,
                     {"plan": "generic", "size": len(DATA), "chunk_bytes": chunk_bytes},
                     SP.iter_body_blocks(DATA, 1024))
    return buf.getvalue()


def _offline(profile: str, data: bytes, chunk: int) -> bytes:
    return repro_torch.compress(getattr(PF, f"{profile}_profile")(), repro_torch.serial(data),
                                device=CPU, chunk_bytes=chunk or None)


def _assert_healthy(server):
    """The postcondition every scenario must leave behind."""
    with ServiceClient(server.address, timeout=10.0) as c:
        frame, _ = c.compress_bytes(DATA, "generic", chunk_bytes=4096)
        assert frame == _offline("generic", DATA, 4096)
        st = c.stats()
    for key_stats in st["sessions"].values():
        assert key_stats["in_use"] == 0, "leaked checked-out session"


def _response_status(blob: bytes):
    """None when the server just closed; else the response status code."""
    if not blob:
        return None
    status, header, body = SP.read_response(io.BytesIO(blob))
    body.drain()
    return status, header


class _Frontend:
    """Duck-types the CompressionServer surface the helpers above touch: the
    port's frontend on a thread over a ``RequestCore(device="cpu")``."""

    def __init__(self, tmp_path, *specs, rate_limit=None, rate_burst=None, registry=None,
                 core_kw=None, **kw):
        if registry is None:
            registry = PlanRegistry()
            for spec in specs or ("generic",):
                registry.register_profile(spec)
        self.registry = registry
        self.socket_path = str(tmp_path / "front.sock")
        self.address = f"unix:{self.socket_path}"
        self.core = RequestCore(registry, device=CPU, sessions_per_plan=2,
                                request_timeout=kw.get("request_timeout", 5.0),
                                **(core_kw or {}))
        lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lst.bind(self.socket_path)
        lst.listen(128)
        limiter = RateLimiter(rate_limit, rate_burst) if rate_limit else None
        kw.setdefault("compute_threads", 2)
        self.frontend = ServiceFrontend(self.core, lst, rate_limiter=limiter,
                                        owns_listener=True, **kw)
        self._thread = threading.Thread(target=self.frontend.serve_forever, daemon=True)
        self._thread.start()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.frontend.stop()
        self._thread.join(10)
        assert not self._thread.is_alive(), "event loop failed to exit"
        self.core.close()


@contextlib.contextmanager
def _frontend(tmp_path, *specs, **kw):
    with _Frontend(tmp_path, *specs, **kw) as f:
        yield f


def _wait_for(pred, seconds: float = 5.0) -> bool:
    deadline = time.monotonic() + seconds
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


# ------------------------------------- the reference's six frontend cases
def test_frontend_survives_hostile_blobs(tmp_path):
    """The incremental parser fails closed on the classic hostile shapes."""
    hostile = [
        b"",
        b"NOPE" + b"\x00" * 16,                      # bad magic
        SP.REQUEST_MAGIC,                            # magic, then EOF
        SP.REQUEST_MAGIC + b"\x63",                  # unknown verb
        SP.REQUEST_MAGIC + b"\x00" + b"\xff" * 10,   # varint overflow
        SP.REQUEST_MAGIC + b"\x00\x05nope!",         # undecodable header
        _valid_request_bytes()[:40],                 # truncated mid-header
    ]
    with _frontend(tmp_path) as srv:
        for blob in hostile:
            out = _send_then_close(srv, blob)
            if out:
                status, header = _response_status(out)
                assert status == SP.STATUS_ERROR
                assert header.get("error")
        _assert_healthy(srv)


def test_frontend_slow_loris_partial_frames(tmp_path):
    """Dozens of sockets each park a byte or two of a request and go silent:
    the loop keeps serving honest clients, then reaps every loris at the
    request deadline, without a thread per victim."""
    req = _valid_request_bytes()
    with _frontend(tmp_path, request_timeout=1.0, max_conns=128) as srv:
        lorises = []
        for i in range(40):
            s = _connect(srv)
            s.sendall(req[: 1 + (i % 7)])  # mid-frame: the deadline must arm
            lorises.append(s)
        try:
            t0 = time.monotonic()
            _assert_healthy(srv)
            assert time.monotonic() - t0 < 5.0, "loris crowd stalled the loop"
            deadline = time.monotonic() + 10.0
            for s in lorises:
                s.settimeout(max(0.1, deadline - time.monotonic()))
                while True:
                    try:
                        if not s.recv(65536):
                            break
                    except (ConnectionResetError, BrokenPipeError):
                        break
        finally:
            for s in lorises:
                s.close()
        _assert_healthy(srv)
        st = srv.frontend.transport_stats()
        assert st["active_connections"] <= 1  # at most the health check's


def test_frontend_mid_frame_disconnect_storm(tmp_path):
    """Connections that vanish mid-frame, back to back, accumulate no state
    and do not wedge the loop."""
    rng = np.random.default_rng(23)
    req = _valid_request_bytes()
    with _frontend(tmp_path, request_timeout=2.0) as srv:
        for _ in range(60):
            cut = int(rng.integers(1, len(req)))
            s = _connect(srv)
            s.sendall(req[:cut])
            s.close()  # no shutdown, no read: just gone
        _assert_healthy(srv)


def test_frontend_rate_limit_rejects_and_recovers(tmp_path):
    with _frontend(tmp_path, rate_limit=1.0, rate_burst=2.0) as srv:
        with ServiceClient(srv.address, timeout=10.0) as c:
            c.compress_bytes(DATA, "generic", chunk_bytes=4096)
            c.compress_bytes(DATA, "generic", chunk_bytes=4096)
            with pytest.raises(ServiceUnavailable) as exc:
                c.compress_bytes(DATA, "generic", chunk_bytes=4096)
            assert exc.value.kind == "rate_limited"
            assert exc.value.retry_after and exc.value.retry_after > 0
            # the connection survives the rejection; control verbs stay free
            assert c.ping()["ok"]
            assert c.stats()["rate_limited"] >= 1
        # a fresh connection holds a fresh bucket (Unix peers are per-conn)
        _assert_healthy(srv)


def test_frontend_sheds_connections_over_capacity(tmp_path):
    """Accepts past max_conns get the prebuilt overloaded frame at once,
    while the seated connections keep working."""
    with _frontend(tmp_path, max_conns=2) as srv:
        seated = [_connect(srv) for _ in range(2)]
        try:
            out = _send_then_close(srv, b"")
            assert out, "over-capacity connect got no shed frame"
            status, header = _response_status(out)
            assert status == SP.STATUS_ERROR
            assert header.get("error_kind") == "overloaded"
            assert header.get("retry_after")
        finally:
            for s in seated:
                s.close()
        # the loop must notice the hangups first: a dial that races the EOF
        # processing is (correctly) shed, which is not what is tested here
        assert _wait_for(lambda: srv.frontend.transport_stats()["active_connections"] == 0)
        _assert_healthy(srv)
        assert srv.frontend.transport_stats()["shed_connections"] >= 1


def test_frontend_pipelined_requests_one_connection(tmp_path):
    """Two complete requests written back to back on one socket get two
    complete, in-order responses (the parser re-feeds buffered bytes)."""
    req = _valid_request_bytes()
    with _frontend(tmp_path) as srv:
        blob = _send_then_close(srv, req + req)
        r = io.BytesIO(blob)
        for _ in range(2):
            status, header, body = SP.read_response(r)
            out = body.read()
            assert status == SP.STATUS_OK
            assert out == _offline("generic", DATA, 4096)
        assert not r.read()
        _assert_healthy(srv)


# ------------------------------------------- FrameParser, differentially
def _norm(v):
    """A decoded header in a form both packages' values compare in."""
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)) and not hasattr(v, "code") and not hasattr(v, "seconds"):
        return [_norm(x) for x in v]
    if hasattr(v, "code"):
        return ("ext", v.code, bytes(v.data))
    if hasattr(v, "seconds"):
        return ("ts", v.seconds, v.nanoseconds)
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def _random_value(rng, depth: int = 0):
    kind = int(rng.integers(0, 9 if depth < 2 else 6))
    if kind == 0:
        return int(rng.integers(-(1 << 40), 1 << 40)) >> int(rng.integers(0, 40))
    if kind == 1:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, int(rng.integers(0, 40))))
    if kind == 2:
        return rng.bytes(int(rng.integers(0, 300)))
    if kind == 3:
        return float(rng.normal())
    if kind == 4:
        return bool(rng.integers(0, 2))
    if kind == 5:
        return None
    if kind == 6:
        return [_random_value(rng, depth + 1) for _ in range(int(rng.integers(0, 5)))]
    return {f"k{i}": _random_value(rng, depth + 1) for i in range(int(rng.integers(0, 4)))}


def _random_request(rng) -> bytes:
    verb = int(rng.choice(sorted(SP.VERBS)))
    header = {"plan": "generic"}
    for i in range(int(rng.integers(0, 6))):
        header[f"h{i}"] = _random_value(rng)
    if rng.random() < 0.5:
        header["size"] = int(rng.integers(0, 1 << 20))
    msg = bytearray(RP.REQUEST_MAGIC + bytes([verb]))
    blob = RP._pack_header(header)
    ref_wire.write_varint(msg, len(blob))
    msg += blob
    for _ in range(int(rng.integers(0, 4))):
        block = rng.bytes(int(rng.integers(1, 3000)))
        ref_wire.write_varint(msg, len(block))
        msg += block
    msg += b"\x00"
    return bytes(msg)


def _random_stream(rng) -> bytes:
    stream = bytearray(b"".join(_random_request(rng) for _ in range(int(rng.integers(1, 4)))))
    roll = rng.random()
    if roll < 0.35:  # one byte changed
        stream[int(rng.integers(0, len(stream)))] = int(rng.integers(0, 256))
    elif roll < 0.45:  # one byte cut
        del stream[int(rng.integers(0, len(stream)))]
    elif roll < 0.5:  # one byte inserted
        stream.insert(int(rng.integers(0, len(stream) + 1)), int(rng.integers(0, 256)))
    return bytes(stream)


def _parse_log(mod, proto, stream: bytes, cuts, max_body: int):
    """Feed ``stream`` to ``mod.FrameParser`` in the pieces ``cuts`` makes ->
    what was seen after each feed, in a form both packages compare in."""
    calls = []

    def on_header(verb, header):
        calls.append((verb, _norm(header)))
        if len(calls) % 3 == 0:
            return ("rejected", {"error_kind": "rate_limited", "n": len(calls)})
        return None

    parser = mod.FrameParser(max_body_bytes=max_body, spool_factory=io.BytesIO)
    log = []
    bounds = [0, *cuts, len(stream)]
    for a, b in zip(bounds, bounds[1:]):
        try:
            reqs = parser.feed(stream[a:b], on_header)
        except proto.ProtocolError as err:
            msg = str(err)
            if msg.startswith("undecodable message header"):
                msg = "undecodable message header"  # the decoder's own text differs
            log.append(("ProtocolError", msg, list(calls)))
            parser.abandon()
            return log
        done = []
        for verb, header, body, reject in reqs:
            done.append((verb, _norm(header), body.read(), body.size_hint, body.bytes_read,
                         body.seekable(), body.limit, body.drain(), reject))
            body.close()
        log.append((done, parser.mid_request, parser.buffered, list(calls)))
    return log


@pytest.mark.parametrize("seed", range(40))
def test_frame_parser_equals_the_reference_on_seeded_splits(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(25):
        stream = _random_stream(rng)
        cuts = sorted(int(c) for c in rng.integers(0, len(stream) + 1, int(rng.integers(0, 9))))
        max_body = int(rng.choice([1 << 30, 1 << 30, 1 << 30, 4000, 2999, 1]))
        want = _parse_log(RF, RP, stream, cuts, max_body)
        assert _parse_log(F, SP, stream, cuts, max_body) == want


@pytest.mark.parametrize("blob", [
    b"", SP.REQUEST_MAGIC, b"NOPE", SP.REQUEST_MAGIC + b"\x04", SP.REQUEST_MAGIC + b"\x00",
    SP.REQUEST_MAGIC + b"\x00" + b"\xff" * 10,
    SP.REQUEST_MAGIC + b"\x00\x81\x80\x40",  # a header length past 1 MiB
    SP.REQUEST_MAGIC + b"\x00\x01\x80\x00", SP.REQUEST_MAGIC + b"\x00\x01\x90\x00",
    SP.REQUEST_MAGIC + b"\x00\x01\x80\xff\xff\xff\xff\x01",  # a block past 64 MiB
    SP.REQUEST_MAGIC + b"\x00\x05nope!",
    SP.REQUEST_MAGIC + b"\x00\x01\x80\x05abc",  # mid-block
], ids=lambda b: b.hex()[:24] or "empty")
def test_frame_parser_byte_at_a_time_equals_the_reference(blob):
    cuts = list(range(1, len(blob)))
    assert _parse_log(F, SP, blob, cuts, 1 << 30) == _parse_log(RF, RP, blob, cuts, 1 << 30)


@pytest.mark.parametrize("slack", [-1, 0, 1])
@pytest.mark.parametrize("blocks", [(1,), (1000,), (700, 300), (1, 998, 1)])
def test_frame_parser_at_the_body_limit_equals_the_reference(blocks, slack):
    """A body of exactly ``max_body_bytes`` is taken; one byte more is not."""
    buf = io.BytesIO()
    RP.write_request(buf, RP.VERB_COMPRESS, {"plan": "generic", "size": sum(blocks)},
                     [bytes([7]) * n for n in blocks])
    stream = buf.getvalue()
    limit = sum(blocks) + slack
    for cuts in ([], list(range(1, len(stream)))):
        want = _parse_log(RF, RP, stream, cuts, limit)
        assert _parse_log(F, SP, stream, cuts, limit) == want
        assert (want[-1][0] == "ProtocolError") == (slack < 0)


def test_buffered_body_is_seekable_with_its_size_hint():
    spool = io.BytesIO(b"abcdef")
    body = F.BufferedBody(spool, 6, 6)
    assert body.seekable() and body.size_hint == 6 and body.bytes_read == 6
    assert body.read(2) == b"ab" and body.tell() == 2 and body.seek(0, 2) == 6
    assert stream_io._input_size(F.BufferedBody(io.BytesIO(b"abc"), 3, None)) == 3
    assert body.drain() == 0 and body.limit is None
    body.close()
    gone = F.BufferedBody(None, 9, 9)  # a discarded (rejected) body
    assert not gone.seekable() and gone.read() == b"" and gone.bytes_read == 9
    gone.close()


# --------------------------------------------------- _response_chunks
@pytest.mark.parametrize("status,header,body,block", [
    (SP.STATUS_OK, {}, None, SP.DEFAULT_BLOCK_BYTES),
    (SP.STATUS_OK, {"ok": True, "plans": 2}, b"", SP.DEFAULT_BLOCK_BYTES),
    (SP.STATUS_OK, {"size": 1}, b"x", 1),
    (SP.STATUS_OK, {"size": 5000}, bytes(range(256)) * 20, 1000),
    (SP.STATUS_OK, {"size": 4096}, b"\x00" * 4096, 4096),
    (SP.STATUS_OK, {"size": 4097}, b"\x01" * 4097, 4096),
    (SP.STATUS_ERROR, {"error": "boom", "error_kind": "device_fault"}, None, 64),
    (SP.STATUS_ERROR, {"error": "é" * 200, "retry_after": 0.5}, None, 64),
    (SP.STATUS_OK, {"blob": b"\xff" * 70000, "n": -(1 << 40)}, b"abc" * 100000,
     SP.DEFAULT_BLOCK_BYTES),
    (SP.STATUS_OK, {"nested": {"a": [1, 2.5, None, "x"]}}, TEXT, 127),
], ids=["bare", "empty-body", "one-byte", "ragged", "one-block", "block-plus-one", "error",
        "utf8-error", "large", "text-127"])
def test_response_chunks_equal_both_packages_framing(status, header, body, block):
    def framed(write):
        buf = io.BytesIO()
        write(buf, status, header, None if body is None else SP.iter_body_blocks(body, block))
        return buf.getvalue()

    ours = b"".join(F._response_chunks(status, header, None if body is None else io.BytesIO(body),
                                       block))
    theirs = b"".join(RF._response_chunks(status, header,
                                          None if body is None else io.BytesIO(body), block))
    assert ours == theirs
    assert ours == framed(SP.write_response) == framed(RP.write_response)


# ------------------------------------------------------------ containers
@pytest.mark.parametrize("chunk", [0, 4096, CHUNK, 65536])
def test_frontend_containers_equal_offline_and_the_threaded_server(tmp_path, chunk):
    """The spooled, seekable body keeps the known-count container path: the
    frontend's container is the threaded server's and the offline one's."""
    with _frontend(tmp_path, "text", "generic") as srv, \
            CompressionServer(srv.registry, socket_path=str(tmp_path / "thr.sock"), device=CPU,
                              request_timeout=TIMEOUT) as thr:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            frame, info = c.compress_bytes(TEXT, "text", chunk_bytes=chunk)
            assert c.decompress_bytes(frame)[0] == TEXT
        with ServiceClient(thr.address, timeout=TIMEOUT) as c:
            threaded, tinfo = c.compress_bytes(TEXT, "text", chunk_bytes=chunk)
    assert frame == threaded == _offline("text", TEXT, chunk)
    offline = io.BytesIO()
    stream_io.compress_file(io.BytesIO(TEXT), offline, PF.text_profile(), device=CPU,
                            chunk_bytes=chunk or None)
    assert frame == offline.getvalue()
    assert info == tinfo and info["container"] == (0 < chunk < len(TEXT))


def test_frontend_compress_without_a_size_header_is_still_known_count(tmp_path):
    """No ``size`` header: the spooled body is seekable, so the frontend writes
    the known-count container, as the reference's frontend does."""
    with _frontend(tmp_path, "text") as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            out = io.BytesIO()
            stats = c.compress_file(io.BytesIO(TEXT), out, "text", chunk_bytes=CHUNK)
            assert stats["chunks"] == -(-len(TEXT) // CHUNK)
            assert out.getvalue() == _offline("text", TEXT, CHUNK)


def _ref_frontend(tmp_path, name: str):
    reg = RefRegistry()
    reg.register_profile("generic")
    core = RefCore(reg, backend="device", sessions_per_plan=2, request_timeout=TIMEOUT)
    lst = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lst.bind(str(tmp_path / name))
    lst.listen(16)
    fe = RefFrontend(core, lst, compute_threads=2, owns_listener=True)
    t = threading.Thread(target=fe.serve_forever, daemon=True)
    t.start()
    return core, fe, t


@pytest.mark.parametrize("chunk", [0, 4096, CHUNK, 65536])
def test_cross_package_clients_and_frontends_give_equal_containers(tmp_path, chunk):
    """A reference client against the port's frontend and a port client
    against the reference's frontend (over the reference's ``RequestCore``):
    the same bytes, both packages' offline ``compress``'s."""
    core, fe, t = _ref_frontend(tmp_path, "ref.sock")
    try:
        with ServiceClient(f"unix:{tmp_path / 'ref.sock'}", timeout=TIMEOUT) as c:
            theirs, tinfo = c.compress_bytes(DATA, "generic", chunk_bytes=chunk)
            assert c.decompress_bytes(theirs)[0] == DATA
            assert c.ping()["protocol_version"] == 1
    finally:
        fe.stop()
        t.join(10)
        core.close()
    assert not t.is_alive()
    with _frontend(tmp_path, "generic") as srv:
        with RefClient(srv.address, timeout=TIMEOUT) as c:
            ours, info = c.compress_bytes(DATA, "generic", chunk_bytes=chunk)
            assert c.decompress_bytes(ours)[0] == DATA
            assert c.ping()["protocol_version"] == 1
    assert ours == theirs == _offline("generic", DATA, chunk)
    assert ours == ref_compress(RPF.generic_profile(), ref_serial(DATA), backend="device",
                                chunk_bytes=chunk or None)
    assert info == tinfo


# ------------------------------------------------------ where the card is
def test_the_frontend_source_imports_no_torch():
    """The loop is transport only: the module itself never imports torch."""
    tree = ast.parse(FRONTEND_SOURCE.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert "torch" not in names
    assert names <= {"__future__", "collections", "io", "selectors", "socket", "threading",
                     "concurrent.futures", "time", "typing", "..core.wire", ".", ".ratelimit",
                     ".server"}


def _hold_compress(core):
    """Make ``core.handle`` wait inside every compress until released ->
    (started, release, results): each handled compress's output file."""
    started, release, results = threading.Event(), threading.Event(), []
    real = core.handle

    def held(verb, header, body):
        if verb == SP.VERB_COMPRESS:
            started.set()
            assert release.wait(30)
        out = real(verb, header, body)
        results.append(out[1])
        return out

    core.handle = held
    return started, release, results


def test_a_request_held_inside_handle_does_not_block_the_loop(tmp_path):
    """While a compute thread sits in ``handle`` (where a request's card work
    runs), other connections are accepted, parsed and answered."""
    with _frontend(tmp_path, "generic") as srv:
        started, release, _ = _hold_compress(srv.core)
        got = {}

        def slow_client():
            with ServiceClient(srv.address, timeout=TIMEOUT) as c:
                got["frame"] = c.compress_bytes(DATA, "generic", chunk_bytes=4096)[0]

        t = threading.Thread(target=slow_client)
        t.start()
        try:
            assert started.wait(10)
            t0 = time.monotonic()
            for _ in range(5):
                with ServiceClient(srv.address, timeout=5.0) as c:
                    assert c.ping()["ok"]
                    assert c.stats()["active_connections"] >= 2
            assert time.monotonic() - t0 < 5.0
            loris = _connect(srv)
            loris.sendall(_valid_request_bytes()[:9])
            assert _wait_for(lambda: srv.frontend.transport_stats()["active_connections"] >= 2)
            loris.close()
            assert not got  # the held request is still inside handle
        finally:
            release.set()
            t.join(20)
        assert got["frame"] == _offline("generic", DATA, 4096)
        _assert_healthy(srv)


def test_stop_with_a_request_in_flight_waits_for_it(tmp_path):
    """``stop()`` while a compress runs: the loop exits only once the compute
    pool is done, the session is back in the pool before ``core.close()``,
    and the result for the closed connection is closed and discarded."""
    srv = _Frontend(tmp_path, "generic")
    digest = srv.registry.resolve("generic").digest
    started, release, results = _hold_compress(srv.core)
    s = _connect(srv)
    try:
        s.sendall(_valid_request_bytes())
        assert started.wait(10)
        assert srv.core.stats()["sessions"].get(digest, {}).get("in_use", 0) == 0
        srv.frontend.stop()
        time.sleep(0.5)
        assert srv._thread.is_alive(), "the loop left while a request was running"
        release.set()
        srv._thread.join(10)
        assert not srv._thread.is_alive()
        assert s.recv(65536) == b""  # closed without a response
    finally:
        release.set()
        s.close()
    st = srv.core.stats()
    assert st["sessions"][digest]["in_use"] == 0 and st["requests"]["compress"] == 1
    assert len(results) == 1 and results[0].closed
    assert srv.frontend.transport_stats()["active_connections"] == 0
    srv.core.close()


def test_stats_render_equally_through_both_packages(tmp_path):
    with _frontend(tmp_path, "generic", rate_limit=100.0, rate_burst=10.0) as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            c.compress_bytes(DATA, "generic", chunk_bytes=4096)
            st = c.stats()
            text = c.metrics()
        for key in ("connections", "active_connections", "shed_connections", "rate_limiter"):
            assert key in st
        assert st["connections"] == 1 and st["active_connections"] == 1
        assert render_prometheus(st) == ref_render(st)
        assert b"ozl_connections_total 1" in text and b"ozl_active_connections 1" in text
        assert srv.core.stats_provider == srv.frontend._default_stats


# ------------------------------------------------------- the card's faults
def _float32_plan():
    """float32 weights as raw bytes: reinterpret, then the float profile."""
    g = GraphBuilder(1)
    x = g.add("interpret_numeric", g.input(0), width=4)
    signs, exp, man = g.add("float_split", x, fmt=2)
    g.select("bytes_auto", signs)
    g.select("entropy_auto", exp)
    g.select("numeric_auto", man)
    return g.build("float32")


def test_a_card_fault_through_the_frontend_is_answered_charged_and_never_retried(tmp_path):
    """The threaded server's path: ``device_fault`` on a connection that stays
    open, the plan charged, quarantined at the threshold, nothing on the host."""
    weights = np.random.default_rng(0).normal(0, 0.02, 4096).astype(np.float32).tobytes()
    reg = PlanRegistry()
    reg.register_profile("text")
    reg.register_compressor(repro_torch.Compressor(_float32_plan()))
    with _frontend(tmp_path, registry=reg,
                   core_kw={"quarantine_threshold": 3, "quarantine_cooldown_s": 0.3}) as srv:
        digest = reg.resolve("float32").digest
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            good, _ = c.compress_bytes(weights, "float32", chunk_bytes=8192)
            with FaultPlan().at("device.encode.cpu.float_split", times=10 ** 6).arm(
                    all_threads=True) as plan:
                for i in range(3):
                    with pytest.raises(RuntimeError, match="InjectedDeviceFault") as ei:
                        c.compress_bytes(weights, "float32", chunk_bytes=8192)
                    assert not isinstance(ei.value, ServiceUnavailable)
                    assert srv.core.stats()["quarantine"][digest]["consecutive_failures"] == i + 1
                fired = len(plan.fired)
                with pytest.raises(ServiceUnavailable) as ei:
                    c.compress_bytes(weights, "float32", chunk_bytes=8192)
                assert ei.value.kind == "plan_quarantined" and ei.value.retry_after > 0
                assert len(plan.fired) == fired  # a quarantined request runs nothing
                assert c.compress_bytes(TEXT, "text", chunk_bytes=CHUNK)[1]["plan_id"] == "text"
                assert c.ping()["ok"]
            st = c.stats()
            assert st["connections"] == 1 and st["errors"] == 4
            assert st["quarantine"][digest]["trips"] == 1
            assert all(n == "device.encode.cpu.float_split" for n, _k, _a in plan.fired)
            time.sleep(0.35)
            assert c.compress_bytes(weights, "float32", chunk_bytes=8192)[0] == good
        assert not srv.core.stats()["quarantine"][digest]["quarantined"]


def test_a_kernel_error_takes_the_threaded_servers_path(tmp_path, monkeypatch):
    """A real card fault (a ``KernelError``) gives the same answer and the same
    charge through the frontend as through the threaded server."""
    def broken(*a, **kw):
        raise KernelError("delta_encode: launch failed (an injected test fault)")

    monkeypatch.setattr(stream_io, "compress_file", broken)
    answers = []
    for make in ("frontend", "threaded"):
        reg = PlanRegistry()
        reg.register_profile("generic")
        if make == "frontend":
            (tmp_path / make).mkdir()
            ctx = _frontend(tmp_path / make, registry=reg)
        else:
            ctx = CompressionServer(reg, socket_path=str(tmp_path / "thr.sock"), device=CPU,
                                    request_timeout=TIMEOUT)
        with ctx as srv:
            with ServiceClient(srv.address, timeout=TIMEOUT) as c:
                with pytest.raises(RuntimeError) as ei:
                    c.compress_bytes(DATA, "generic", chunk_bytes=4096)
                assert not isinstance(ei.value, ServiceUnavailable)
                assert c.ping()["ok"]  # the connection stays open
                st = c.stats()
            q = st["quarantine"][reg.resolve("generic").digest]
            answers.append((str(ei.value), st["errors"], st["connections"],
                            q["consecutive_failures"]))
    assert answers[0] == answers[1]
    assert answers[0][0] == ("service error: KernelError: delta_encode: launch failed"
                             " (an injected test fault)")
    assert answers[0][1:] == (1, 1, 1)
