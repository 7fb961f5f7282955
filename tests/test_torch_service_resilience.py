"""The port's daemon under hostile traffic, overload and faults, on the CPU.

The cases of ``tests/test_service_fuzz.py`` (every prefix truncation, random
bytes, bad magic and verbs, oversized varints, undecodable headers, mid-body
disconnects, pipelined requests then garbage, hostile and honest clients at
once, more bad connections than workers, the body caps) and of
``tests/test_service_resilience.py`` (shedding and blocking admission, client
retries, the poison-plan breaker), plus the rate limit, run against
``repro_torch.service.CompressionServer(device="cpu")`` and fail closed as
they do against the reference's: the server answers with an error response
and/or drops the connection, and a well-formed request on a fresh connection
then succeeds with every pooled session returned.

The card-fault path differs from the reference's by design: the reference's
sessions retry a failed chunk on the host, the port's never do.  A card
fault (here injected at ``device.encode.cpu.<codec>``, an
``InjectedDeviceFault``, which is an ``OSError``) is answered with a
structured ``device_fault`` error on a connection that stays open, charged to
the plan's quarantine, and after ``quarantine_threshold`` failures the plan's
requests get ``plan_quarantined`` while other plans keep serving.  Any other
``OSError`` raised while the request body is read (a stalled sender, a fault
injected at ``io.src.read``) is transport trouble, as in the reference: the
connection is dropped and no plan is charged.
"""
import io
import random
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro.reliability import FaultPlan as RefFaultPlan  # noqa: E402
from repro.service import CompressionServer as RefServer  # noqa: E402
from repro.service import PlanRegistry as RefRegistry  # noqa: E402
from repro_torch.codecs import profiles as PF  # noqa: E402
from repro_torch.core.graph import GraphBuilder  # noqa: E402
from repro_torch.reliability import FaultPlan  # noqa: E402
from repro_torch.service import (  # noqa: E402
    CompressionServer,
    PlanRegistry,
    ServiceClient,
    ServiceUnavailable,
)
from repro_torch.service import protocol as SP  # noqa: E402

CPU = "cpu"
DATA = b"fuzz corpus: level=INFO svc=auth handled\n" * 200
TEXT = b"req=deadbeef level=INFO svc=auth handled in 42us\n" * 800
CHUNK = 8 << 10
TIMEOUT = 15.0


def _server(tmp_path, *specs, **kw):
    reg = PlanRegistry()
    for spec in specs or ("generic",):
        reg.register_profile(spec)
    kw.setdefault("request_timeout", 5.0)
    kw.setdefault("max_clients", 8)
    kw.setdefault("sessions_per_plan", 2)
    return CompressionServer(reg, socket_path=str(tmp_path / "fuzz.sock"), device=CPU, **kw)


@pytest.fixture()
def server(tmp_path):
    with _server(tmp_path) as srv:
        yield srv


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


def _want() -> bytes:
    return repro_torch.compress(PF.generic_profile(), repro_torch.serial(DATA), device=CPU,
                                chunk_bytes=4096)


def _assert_healthy(server):
    """The postcondition every scenario must leave behind."""
    with ServiceClient(server.address, timeout=10.0) as c:
        frame, _ = c.compress_bytes(DATA, "generic", chunk_bytes=4096)
        assert frame == _want()
        st = c.stats()
    for key_stats in st["sessions"].values():
        assert key_stats["in_use"] == 0, "leaked checked-out session"


def _response_status(blob: bytes):
    if not blob:
        return None
    status, header, body = SP.read_response(io.BytesIO(blob))
    body.drain()
    return status, header


def _assert_error_or_nothing(out: bytes):
    if out:
        status, header = _response_status(out)
        assert status == SP.STATUS_ERROR and header.get("error")


# ---------------------------------------------------------- hostile traffic
def test_every_prefix_truncation(server):
    req = _valid_request_bytes()
    for cut in range(0, len(req), max(len(req) // 59, 1)):
        _assert_error_or_nothing(_send_then_close(server, req[:cut]))
    _assert_healthy(server)


def test_random_bytes_fail_closed(server):
    rng = np.random.default_rng(7)
    for n in (1, 4, 16, 200, 4096):
        _assert_error_or_nothing(_send_then_close(server, rng.bytes(n)))
    _assert_healthy(server)


def test_garbage_verb_and_bad_magic_rejected(server):
    buf = io.BytesIO()
    SP.write_message(buf, SP.REQUEST_MAGIC, 99, {"plan": "generic"}, [b"x"])
    status, header = _response_status(_send_then_close(server, buf.getvalue()))
    assert status == SP.STATUS_ERROR and "malformed request" in header["error"]
    _assert_error_or_nothing(_send_then_close(server, b"EVIL" + _valid_request_bytes()[4:]))
    _assert_healthy(server)


def test_oversized_length_varints_rejected(server):
    _assert_error_or_nothing(_send_then_close(
        server, SP.REQUEST_MAGIC + bytes([SP.VERB_PING]) + b"\xff" * 10))
    head = bytearray(SP.REQUEST_MAGIC + bytes([SP.VERB_PING]))
    ref_wire.write_varint(head, SP.MAX_HEADER_BYTES + 1)
    _assert_error_or_nothing(_send_then_close(server, bytes(head)))
    buf = io.BytesIO()
    SP.write_message(buf, SP.REQUEST_MAGIC, SP.VERB_COMPRESS, {"plan": "generic"})
    blob = bytearray(buf.getvalue()[:-1])
    ref_wire.write_varint(blob, SP.MAX_BLOCK_BYTES + 1)
    _assert_error_or_nothing(_send_then_close(server, bytes(blob)))
    _assert_healthy(server)


@pytest.mark.parametrize("junk", [b"\xc1\xc1\xc1\xc1", b"\x81\x01\x02", b"\x81\xa1a\xa2\xff\xfe",
                                  b"\x81\xa1a\xd5\xff\x00\x01", b"\x93\x01\x02\x03"],
                         ids=["reserved byte", "int key", "invalid utf-8", "bad timestamp",
                              "not a map"])
def test_undecodable_header_rejected(server, junk):
    blob = bytearray(SP.REQUEST_MAGIC + bytes([SP.VERB_COMPRESS]))
    ref_wire.write_varint(blob, len(junk))
    blob += junk
    status, header = _response_status(_send_then_close(server, bytes(blob)))
    assert status == SP.STATUS_ERROR and "malformed request" in header["error"]
    _assert_healthy(server)


def test_an_ext_value_in_a_header_is_accepted_as_msgpack_accepts_it(server):
    """A header value msgpack reads (an ``ExtType``) is no protocol error: the
    unknown key is ignored and the request is served."""
    buf = io.BytesIO()
    SP.write_request(buf, SP.VERB_PING, {})
    blob = bytearray(buf.getvalue()[:5])
    header = b"\x81\xa5extra\xd4\x05\x01"
    ref_wire.write_varint(blob, len(header))
    blob += header + b"\x00"
    status, resp = _response_status(_send_then_close(server, bytes(blob)))
    assert status == SP.STATUS_OK and resp["ok"]


def test_mid_body_disconnect(server):
    req = _valid_request_bytes()
    buf = io.BytesIO()
    SP.write_message(buf, SP.REQUEST_MAGIC, SP.VERB_COMPRESS,
                     {"plan": "generic", "size": len(DATA), "chunk_bytes": 4096})
    header_len = len(buf.getvalue()) - 1
    _assert_error_or_nothing(_send_then_close(server, req[:header_len + (len(req) - header_len)
                                                          // 2]))
    _assert_healthy(server)


def test_stacked_requests_then_garbage(server):
    req = _valid_request_bytes()
    out = _send_then_close(server, req * 3 + b"\x00garbage-that-is-not-a-request")
    r = io.BytesIO(out)
    for _ in range(3):
        status, _h, body = SP.read_response(r)
        assert status == SP.STATUS_OK and body.read() == _want()
    rest = r.read()
    if rest:
        status, _h, body = SP.read_response(io.BytesIO(rest))
        body.drain()
        assert status == SP.STATUS_ERROR
    _assert_healthy(server)


def test_concurrent_clients_with_interleaved_garbage(server):
    want = _want()
    req = _valid_request_bytes()
    errors = []

    def hostile(i):
        try:
            for cut in range(0, len(req), max(len(req) // 7, 1)):
                _send_then_close(server, req[: cut + i])
        except Exception as err:  # pragma: no cover
            errors.append(("hostile", i, err))

    def honest(i):
        try:
            with ServiceClient(server.address, timeout=TIMEOUT) as c:
                for _ in range(3):
                    assert c.compress_bytes(DATA, "generic", chunk_bytes=4096)[0] == want
        except Exception as err:  # pragma: no cover
            errors.append(("honest", i, err))

    threads = [threading.Thread(target=hostile if i % 2 else honest, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    _assert_healthy(server)


def test_worker_not_wedged_by_many_bad_connections(server):
    for i in range(3 * server.max_clients):
        _send_then_close(server, b"\xff" * (i % 7))
    _assert_healthy(server)


def test_compress_declared_size_caps_body(server):
    s = _connect(server)
    try:
        w = s.makefile("wb")
        SP.write_request(w, SP.VERB_COMPRESS, {"plan": "generic", "size": 16, "chunk_bytes": 0},
                         SP.iter_body_blocks(DATA, 1024))
    except (BrokenPipeError, ConnectionResetError):
        pass  # cut off mid-flood: the point
    finally:
        s.close()
    _assert_healthy(server)


def _small_cap_server(tmp_path, cap: int = 64 << 10):
    return _server(tmp_path, max_body_bytes=cap)


def test_declared_size_cannot_widen_the_cap(tmp_path):
    with _small_cap_server(tmp_path) as srv:
        for verb, header in ((SP.VERB_COMPRESS, {"plan": "generic", "size": 1 << 60,
                                                 "chunk_bytes": 0}),
                             (SP.VERB_DECOMPRESS, {"size": 1 << 60})):
            buf = io.BytesIO()
            SP.write_request(buf, verb, header, [b"tiny"])
            status, header = _response_status(_send_then_close(srv, buf.getvalue()))
            assert status == SP.STATUS_ERROR and "limit" in header["error"]
        _assert_healthy(srv)


@pytest.mark.parametrize("declared", [True, False], ids=["over-declared", "undeclared"])
def test_a_flood_is_cut_off_at_the_cap(tmp_path, declared):
    with _small_cap_server(tmp_path) as srv:
        header = {"plan": "generic", "chunk_bytes": 0}
        if declared:
            header["size"] = 1 << 60
        buf = io.BytesIO()
        SP.write_request(buf, SP.VERB_COMPRESS, header,
                         SP.iter_body_blocks(b"\xaa" * (4 * srv.max_body_bytes), 8192))
        _assert_error_or_nothing(_send_then_close(srv, buf.getvalue()))
        _assert_healthy(srv)


def test_reject_path_drain_is_bounded(tmp_path):
    with _small_cap_server(tmp_path) as srv:
        buf = io.BytesIO()
        SP.write_request(buf, SP.VERB_COMPRESS, {"plan": "no-such-plan", "chunk_bytes": 0},
                         SP.iter_body_blocks(b"\xaa" * (4 * srv.max_body_bytes), 8192))
        SP.write_request(buf, SP.VERB_PING, {})
        out = _send_then_close(srv, buf.getvalue())
        r = io.BytesIO(out)
        if out:
            status, _h, body = SP.read_response(r)
            body.drain()
            assert status == SP.STATUS_ERROR
        assert not r.read(), "server drained an over-cap body and kept serving"
        _assert_healthy(srv)


def test_client_rejects_malformed_response():
    fake = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    fake.bind(("127.0.0.1", 0))
    fake.listen(1)
    port = fake.getsockname()[1]

    def fake_server():
        conn, _ = fake.accept()
        conn.recv(65536)
        conn.sendall(b"HTTP/1.1 200 OK\r\n\r\nnot the protocol")
        conn.close()

    t = threading.Thread(target=fake_server)
    t.start()
    try:
        c = ServiceClient(("127.0.0.1", port), timeout=5.0)
        with pytest.raises(SP.ProtocolError, match="bad magic"):
            c.ping()
        c.close()
    finally:
        t.join(10)
        fake.close()


# --------------------------------------------------------------------- load
def _load_server(tmp_path, **kw):
    return _server(tmp_path, "text", "struct:3,5", sessions_per_plan=1,
                   request_timeout=20.0, **kw)


def test_overload_sheds_with_retry_after(tmp_path):
    with _load_server(tmp_path, admission_timeout=0.05) as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            ref, _ = c.compress_bytes(TEXT, plan="text", chunk_bytes=CHUNK)
            lease = srv.pool.acquire(srv.registry.resolve("text").digest)
            lease.__enter__()  # hold the only session hostage
            try:
                with pytest.raises(ServiceUnavailable) as ei:
                    c.compress_bytes(TEXT, plan="text", chunk_bytes=CHUNK)
            finally:
                lease.__exit__(None, None, None)
            assert ei.value.kind == "overloaded" and ei.value.retry_after > 0
            assert c.compress_bytes(TEXT, plan="text", chunk_bytes=CHUNK)[0] == ref
        assert srv.stats()["shed"] >= 1


def test_blocking_admission_is_the_default(tmp_path):
    with _load_server(tmp_path) as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            ref, _ = c.compress_bytes(TEXT, plan="text", chunk_bytes=CHUNK)
            lease = srv.pool.acquire(srv.registry.resolve("text").digest)
            lease.__enter__()
            timer = threading.Timer(0.2, lease.__exit__, (None, None, None))
            timer.start()
            try:
                assert c.compress_bytes(TEXT, plan="text", chunk_bytes=CHUNK)[0] == ref
            finally:
                timer.join()
        assert srv.stats()["shed"] == 0


def test_client_retries_through_transient_overload(tmp_path):
    with _load_server(tmp_path, admission_timeout=0.05) as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT, retries=8, backoff_base=0.05,
                           rng=random.Random(0)) as c:
            ref, _ = c.compress_bytes(TEXT, plan="text", chunk_bytes=CHUNK)
            lease = srv.pool.acquire(srv.registry.resolve("text").digest)
            lease.__enter__()
            timer = threading.Timer(0.25, lease.__exit__, (None, None, None))
            timer.start()
            try:
                assert c.compress_bytes(TEXT, plan="text", chunk_bytes=CHUNK)[0] == ref
            finally:
                timer.join()
        assert srv.stats()["shed"] >= 1


def test_client_rejects_negative_retries():
    with pytest.raises(ValueError):
        ServiceClient("/nonexistent.sock", retries=-1)


def test_poison_plan_trips_breaker_without_hurting_neighbours(tmp_path):
    with _load_server(tmp_path, quarantine_threshold=3, quarantine_cooldown_s=0.2) as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            bad = b"x" * 1001  # not a whole number of 8-byte records
            for _ in range(3):
                with pytest.raises(RuntimeError, match="whole number of records"):
                    c.compress_bytes(bad, plan="struct:3,5", chunk_bytes=0)
            with pytest.raises(ServiceUnavailable) as ei:
                c.compress_bytes(bad, plan="struct:3,5", chunk_bytes=0)
            assert ei.value.kind == "plan_quarantined" and ei.value.retry_after > 0
            c.compress_bytes(TEXT, plan="text", chunk_bytes=CHUNK)
            digest = srv.registry.resolve("struct:3,5").digest
            q = srv.stats()["quarantine"][digest]
            assert q["quarantined"] and q["trips"] == 1
            time.sleep(0.25)  # the cooldown admits a probe; a good request clears it
            c.compress_bytes(b"x" * 1000, plan="struct:3,5", chunk_bytes=0)
            assert not srv.stats()["quarantine"][digest]["quarantined"]


def test_rate_limit_rejects_and_recovers(tmp_path):
    with _server(tmp_path, rate_limit=1.0, rate_burst=2.0) as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            c.compress_bytes(DATA, "generic", chunk_bytes=4096)
            c.compress_bytes(DATA, "generic", chunk_bytes=4096)
            with pytest.raises(ServiceUnavailable) as exc:
                c.compress_bytes(DATA, "generic", chunk_bytes=4096)
            assert exc.value.kind == "rate_limited" and exc.value.retry_after > 0
            assert c.ping()["ok"]  # control verbs are not metered
            st = c.stats()
            assert st["rate_limited"] == 1 and st["rate_limiter"]["rejected"] == 1
        _assert_healthy(srv)  # a fresh connection holds a fresh bucket


# --------------------------------------------------------- the card's faults
def _float32_plan():
    """float32 weights as raw bytes: reinterpret, then the float profile."""
    g = GraphBuilder(1)
    x = g.add("interpret_numeric", g.input(0), width=4)
    signs, exp, man = g.add("float_split", x, fmt=2)
    g.select("bytes_auto", signs)
    g.select("entropy_auto", exp)
    g.select("numeric_auto", man)
    return g.build("float32")


def test_a_card_fault_is_answered_charged_and_never_retried_on_the_host(tmp_path):
    """A difference by design: the reference retries such a chunk on the host
    (``failover=``); the port answers ``device_fault`` on a connection that
    stays usable, charges the plan, and quarantines it at the threshold."""
    weights = np.random.default_rng(0).normal(0, 0.02, 4096).astype(np.float32).tobytes()
    reg = PlanRegistry()
    reg.register_profile("text")
    reg.register_compressor(repro_torch.Compressor(_float32_plan()))
    with CompressionServer(reg, socket_path=str(tmp_path / "f.sock"), device=CPU,
                           quarantine_threshold=3, quarantine_cooldown_s=0.3) as srv:
        digest = srv.registry.resolve("float32").digest
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            good, _ = c.compress_bytes(weights, "float32", chunk_bytes=8192)
            with FaultPlan().at("device.encode.cpu.float_split", times=10 ** 6).arm(
                    all_threads=True) as plan:
                for i in range(3):
                    with pytest.raises(RuntimeError, match="InjectedDeviceFault") as ei:
                        c.compress_bytes(weights, "float32", chunk_bytes=8192)
                    assert not isinstance(ei.value, ServiceUnavailable)
                    assert srv.stats()["quarantine"][digest]["consecutive_failures"] == i + 1
                fired = len(plan.fired)
                with pytest.raises(ServiceUnavailable) as ei:
                    c.compress_bytes(weights, "float32", chunk_bytes=8192)
                assert ei.value.kind == "plan_quarantined" and ei.value.retry_after > 0
                assert len(plan.fired) == fired  # a quarantined request runs nothing
                assert c.compress_bytes(TEXT, "text", chunk_bytes=CHUNK)[1]["plan_id"] == "text"
                assert c.ping()["ok"]  # the same connection throughout
            st = srv.stats()
            assert st["connections"] == 1 and st["errors"] == 4
            assert st["backend_health"] == {} and st["quarantine"][digest]["trips"] == 1
            # each failed request stopped at its first encoder fault: nothing
            # ran again on any other device
            assert all(n == "device.encode.cpu.float_split" for n, _k, _a in plan.fired)
            time.sleep(0.35)
            assert c.compress_bytes(weights, "float32", chunk_bytes=8192)[0] == good
        assert not srv.stats()["quarantine"][digest]["quarantined"]


def test_the_structured_error_carries_the_device_fault_kind(tmp_path):
    with _server(tmp_path, "struct:4", "generic") as srv:
        buf = io.BytesIO()
        SP.write_request(buf, SP.VERB_COMPRESS, {"plan": "struct:4", "size": 4096,
                                                 "chunk_bytes": 0}, [bytes(4096)])
        with FaultPlan().at("device.encode.cpu.*", times=10 ** 6).arm(all_threads=True):
            status, header = _response_status(_send_then_close(srv, buf.getvalue() * 2))
        assert status == SP.STATUS_ERROR and header["error_kind"] == "device_fault"
        assert header["error"].startswith(
            "InjectedDeviceFault: injected fault at 'device.encode.cpu.")
        _assert_healthy(srv)


def test_an_oserror_reading_the_body_is_transport_trouble(tmp_path):
    """A sender that stalls mid-body makes the body's read time out (an
    ``OSError``): the connection is dropped as unreadable and the plan is not
    charged."""
    with _server(tmp_path, "generic", request_timeout=0.3) as srv:
        s = _connect(srv)
        try:
            w = s.makefile("wb")
            head = io.BytesIO()
            SP.write_request(head, SP.VERB_COMPRESS,
                             {"plan": "generic", "size": 3 * 8192, "chunk_bytes": 4096},
                             [b"a" * 8192])
            w.write(head.getvalue()[:-1])  # one block of three, no terminator
            w.flush()
            r = s.makefile("rb")
            status, header, body = SP.read_response(r)  # the server answers, then closes
            body.drain()
            assert status == SP.STATUS_ERROR and header["error"] == "request body unreadable"
            assert r.read() == b""
        finally:
            s.close()
        st = srv.stats()
        assert all(q["consecutive_failures"] == 0 for q in st["quarantine"].values())
        assert st["quarantine"] == {} and st["errors"] == 1
        _assert_healthy(srv)


def test_a_fault_injected_reading_the_body_is_transport_trouble_as_in_the_reference(tmp_path):
    """A fault at ``io.src.read`` (the session's own wrapper over the body)
    is an ``OSError`` that did not arise on the card: the port answers it as
    the reference's server does, drops the connection and charges no plan."""
    answers = []
    for server_cls, registry_cls, plan_cls, kw in (
            (CompressionServer, PlanRegistry, FaultPlan, {"device": CPU}),
            (RefServer, RefRegistry, RefFaultPlan, {})):
        reg = registry_cls()
        reg.register_profile("generic")
        with server_cls(reg, socket_path=str(tmp_path / "src.sock"), request_timeout=5.0,
                        **kw) as srv:
            with plan_cls().at("io.src.read").arm(all_threads=True) as plan:
                answers.append(_response_status(_send_then_close(srv, _valid_request_bytes())))
            assert [n for n, _k, _a in plan.fired] == ["io.src.read"]
            st = srv.stats()
            assert st["quarantine"] == {} and st["errors"] == 1
            if server_cls is CompressionServer:
                _assert_healthy(srv)
    assert answers[0] == answers[1] == (SP.STATUS_ERROR, {"error": "request body unreadable"})
