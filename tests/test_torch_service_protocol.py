"""The service's host pieces against the reference's, on the CPU: the wire
protocol (``repro_torch.service.protocol``), the plan registry, the
Prometheus renderer, the plan quarantine and the rate limiter.

Requests and responses are the reference's bytes for a parametrised set of
headers and bodies, and each package reads the other's; a header is accepted
by the port exactly when ``msgpack.unpackb(raw=False)`` accepts it (seeded
mutations of real headers, and the hand-made traps: ``ext`` values, malformed
timestamps, non-string keys, invalid UTF-8, the reserved byte), and refused
as ``ProtocolError``; ``render_prometheus`` gives the reference's bytes;
``Quarantine``, ``TokenBucket`` and ``RateLimiter`` answer as the
reference's under one injected clock; registry ids and digests are the
reference's for profile specs and every tracked ``.ozp`` file.
"""
import io
import random
import struct
from pathlib import Path

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import wire as ref_wire  # noqa: E402
from repro.reliability import failover as ref_failover  # noqa: E402
from repro.service import metrics as ref_metrics  # noqa: E402
from repro.service import protocol as RP  # noqa: E402
from repro.service import ratelimit as ref_ratelimit  # noqa: E402
from repro.service import registry as ref_registry  # noqa: E402
from repro_torch.core import serialize  # noqa: E402
from repro_torch.reliability import FaultPlan, InjectedFault, Quarantine  # noqa: E402
from repro_torch.service import metrics, ratelimit, registry  # noqa: E402
from repro_torch.service import protocol as P  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

HEADERS = {
    "empty": {},
    "compress": {"plan": "generic", "size": 39_200, "chunk_bytes": 4 << 20},
    "error": {"error": "service error: plan 'x' is quarantined", "error_kind": "plan_quarantined",
              "retry_after": 0.25},
    "ping": {"ok": True, "protocol_version": 1, "plans": 2, "uptime_s": 12.345, "pid": 4242},
    "scalars": {"none": None, "f": False, "t": True, "neg": -1, "neg8": -100, "neg16": -30_000,
                "neg32": -(1 << 31), "neg64": -(1 << 63), "u8": 200, "u16": 60_000,
                "u32": 1 << 31, "u64": (1 << 64) - 1, "float": -0.5, "inf": float("inf"),
                "bin": b"\x00\xff" * 3},
    "widths": {"s31": "x" * 31, "s32": "y" * 32, "s300": "z" * 300, "s70k": "w" * 70_000,
               "b300": bytes(300), "b70k": bytes(70_000), "l15": list(range(15)),
               "l16": list(range(16)), "l70k": [0] * 70_000, "utf8": "héllo ✓ ∑"},
    "nested": {"latency": {"compress": {"n": 3, "p50_ms": 1.5, "p99_ms": 9.25, "req_s": 0.7}},
               "sessions": {"ab" * 32: {"created": 1, "idle": 1, "in_use": 0, "acquires": 3}},
               "registry": [{"plan_id": "text", "level": 5}, {"plan_id": "generic"}],
               "m16": {f"k{i}": i for i in range(20)}, "tuple": (1, 2, 3)},
}
BODIES = {
    "none": None,
    "empty blocks": [b"", b""],
    "one byte": [b"x"],
    "three": [b"abc", b"", b"d" * 200, b"e" * 70_000],
    "cut": list(P.iter_body_blocks(bytes(range(256)) * 2400, 8192)),
}


def _request(proto, verb, header, body):
    buf = io.BytesIO()
    proto.write_request(buf, verb, header, body)
    return buf.getvalue()


def _response(proto, status, header, body):
    buf = io.BytesIO()
    proto.write_response(buf, status, header, body)
    return buf.getvalue()


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("header", sorted(HEADERS))
def test_requests_and_responses_are_the_references_bytes(header, body):
    h, b = HEADERS[header], BODIES[body]
    for verb in (P.VERB_PING, P.VERB_COMPRESS):
        mine = _request(P, verb, h, b)
        assert mine == _request(RP, verb, h, b)
        v, got, rd = RP.read_request(io.BytesIO(mine))  # the reference reads the port's
        v2, got2, rd2 = P.read_request(io.BytesIO(mine))  # and the port its own
        assert v == v2 == verb and got == got2 == msgpack.unpackb(msgpack.packb(h), raw=False)
        assert rd.read() == rd2.read() == b"".join(b or ())
    for status in (P.STATUS_OK, P.STATUS_ERROR):
        theirs = _response(RP, status, h, b)
        assert _response(P, status, h, b) == theirs
        s, got, rd = P.read_response(io.BytesIO(theirs))  # the port reads the reference's
        assert s == status and got == msgpack.unpackb(msgpack.packb(h), raw=False)
        assert rd.read() == b"".join(b or ())


def test_constants_and_addresses_are_the_references():
    for name in ("PROTOCOL_VERSION", "REQUEST_MAGIC", "RESPONSE_MAGIC", "VERBS", "STATUS_OK",
                 "STATUS_ERROR", "MAX_HEADER_BYTES", "MAX_BLOCK_BYTES", "DEFAULT_BLOCK_BYTES"):
        assert getattr(P, name) == getattr(RP, name), name
    for spec in ("unix:/tmp/a.sock", "/tmp/b.sock", "rel/c.sock", "127.0.0.1:80", ":9000",
                 ("", 7), ("10.0.0.1", "81"), "host:", "nope", "", None, 5):
        try:
            want = RP.parse_address(spec)
        except ValueError:
            with pytest.raises(ValueError):
                P.parse_address(spec)
            continue
        assert P.parse_address(spec) == want


def test_body_blocks_cut_bytes_not_elements():
    arr = np.arange(1000, dtype=np.int64)
    for src in (memoryview(arr), memoryview(arr)[::2], arr.tobytes(), io.BytesIO(arr.tobytes())):
        want = list(RP.iter_body_blocks(src if not isinstance(src, io.BytesIO)
                                        else io.BytesIO(arr.tobytes()), 3000))
        assert list(P.iter_body_blocks(src, 3000)) == want


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


def _both_read(blob: bytes):
    """Each package's reading of one header blob -> (reference, port), each a
    normalized value or ``"refused"``."""
    out = []
    for proto in (RP, P):
        msg = bytearray(proto.REQUEST_MAGIC + bytes([proto.VERB_PING]))
        ref_wire.write_varint(msg, len(blob))
        msg += blob + b"\x00"
        try:
            _v, header, _b = proto.read_request(io.BytesIO(bytes(msg)))
            out.append(_norm(header))
        except proto.ProtocolError:
            out.append("refused")
    return tuple(out)


TRAPS = {
    "reserved byte": b"\x81\xa1a\xc1",
    "int key": b"\x81\x01\x02",
    "array key": b"\x81\x90\x02",
    "bin key": b"\x81\xc4\x01a\x02",
    "invalid utf-8": b"\x81\xa1a\xa2\xff\xfe",
    "not a map": b"\x93\x01\x02\x03",
    "empty": b"",
    "trailing": b"\x80\x00",
    "truncated str": b"\x81\xa1a\xa5ab",
    "fixext": b"\x81\xa1a\xd4\x05\x01",
    "ext8 empty": b"\x81\xa1a\xc7\x00\x05",
    "ext16": b"\x81\xa1a\xc8\x00\x02\x05ab",
    "ext32": b"\x81\xa1a\xc9\x00\x00\x00\x01\x7fz",
    "reserved ext code": b"\x81\xa1a\xd5\x80ab",
    "timestamp32": b"\x81\xa1a\xd6\xff\x00\x00\x00\x01",
    "timestamp64": b"\x81\xa1a\xd7\xff" + struct.pack(">Q", (999_999_999 << 34) | 5),
    "timestamp64 ns 1e9": b"\x81\xa1a\xd7\xff" + struct.pack(">Q", (10 ** 9 << 34) | 5),
    "timestamp96": b"\x81\xa1a\xc7\x0c\xff" + struct.pack(">Iq", 7, -5),
    "timestamp96 ns 1e9": b"\x81\xa1a\xc7\x0c\xff" + struct.pack(">Iq", 10 ** 9, 5),
    "timestamp of 2": b"\x81\xa1a\xd5\xff\x00\x01",
    "timestamp of 3": b"\x81\xa1a\xc7\x03\xff" + b"abc",
    "float32 nan": b"\x81\xa1a\xca\x7f\xc0\x00\x00",
    "deep": b"\x81\xa1a" + b"\x91" * 1100 + b"\x00",
    "map count past the end": b"\x81\xa1a\xdf\xff\xff\xff\xff",
    "duplicate keys": b"\x82\xa1a\x01\xa1a\x02",
}


@pytest.mark.parametrize("trap", sorted(TRAPS))
def test_a_header_is_refused_exactly_where_msgpack_refuses_it(trap):
    ref, port = _both_read(TRAPS[trap])
    try:
        want = _norm(msgpack.unpackb(TRAPS[trap], raw=False))
        want = want if isinstance(want, dict) else "refused"
    except Exception:
        want = "refused"
    assert port == ref == want


def test_seeded_header_mutations_fail_closed_as_msgpack_does():
    rng = random.Random(11)
    seeds = [msgpack.packb(h, use_bin_type=True) for h in HEADERS.values()
             if len(msgpack.packb(h)) < 4096]
    accepted = refused = 0
    for _ in range(1500):
        blob = bytearray(rng.choice(seeds))
        for _ in range(rng.randint(1, 3)):
            op = rng.random()
            pos = rng.randrange(len(blob) + 1)
            if op < 0.5 and blob:
                blob[min(pos, len(blob) - 1)] = rng.randrange(256)
            elif op < 0.75:
                blob[pos:pos] = bytes([rng.randrange(256)])
            else:
                del blob[pos:]
        ref, port = _both_read(bytes(blob))
        assert port == ref, bytes(blob).hex()
        accepted += ref != "refused"
        refused += ref == "refused"
    assert accepted > 100 and refused > 100


def test_header_size_cap_on_both_sides():
    big = {"x": "y" * P.MAX_HEADER_BYTES}
    with pytest.raises(P.ProtocolError, match="header too large"):
        P.write_request(io.BytesIO(), P.VERB_PING, big)
    msg = bytearray(P.REQUEST_MAGIC + bytes([P.VERB_PING]))
    ref_wire.write_varint(msg, P.MAX_HEADER_BYTES + 1)
    with pytest.raises(P.ProtocolError, match="header too large"):
        P.read_request(io.BytesIO(bytes(msg)))
    assert issubclass(P.ProtocolError, ValueError)


def test_every_proper_prefix_fails_closed():
    """``tests/test_service_fuzz.py``'s primitive case, on the port."""
    with pytest.raises(P.ProtocolError):
        P.read_response(io.BytesIO(P.RESPONSE_MAGIC))
    with pytest.raises(P.ProtocolError):
        P.read_response(io.BytesIO(P.RESPONSE_MAGIC + b"\x00\xff"))
    blob = _response(P, P.STATUS_OK, {"x": 1}, [b"abc"])
    for cut in range(len(blob)):
        with pytest.raises(P.ProtocolError):
            status, header, body = P.read_response(io.BytesIO(blob[:cut]))
            body.read()
    status, header, body = P.read_response(io.BytesIO(blob))
    assert (status, header, body.read()) == (P.STATUS_OK, {"x": 1}, b"abc")
    assert P.read_response_or_eof(io.BytesIO(b"")) is None
    assert P.read_request_or_eof(io.BytesIO(b"")) is None
    for bad, match in ((b"EVIL\x00\x01\x80\x00", "bad magic"),
                       (P.RESPONSE_MAGIC + b"\x07\x01\x80\x00", "status")):
        with pytest.raises(P.ProtocolError, match=match):
            P.read_response(io.BytesIO(bad))
    msg = _request(P, P.VERB_PING, {}, None)
    with pytest.raises(P.ProtocolError, match="unknown verb"):
        P.read_request(io.BytesIO(msg[:4] + b"\x63" + msg[5:]))
    with pytest.raises(P.ProtocolError, match="varint overflow"):
        P.read_request(io.BytesIO(P.REQUEST_MAGIC + b"\x00" + b"\xff" * 10))


def test_block_reader_limits_and_drain():
    buf = io.BytesIO()
    P.write_message(buf, P.REQUEST_MAGIC, P.VERB_COMPRESS, {"plan": "g", "size": 16}, [b"x" * 64])
    _v, header, body = P.read_request(io.BytesIO(buf.getvalue()))
    assert body.size_hint == 16
    body.limit = 16
    with pytest.raises(P.ProtocolError, match="limit"):
        body.read()
    _v, _h, body = P.read_request(io.BytesIO(buf.getvalue() * 2))
    assert body.read(10) == b"x" * 10 and body.drain() == 54 and body.read() == b""
    big = bytearray(buf.getvalue()[:-66])
    ref_wire.write_varint(big, P.MAX_BLOCK_BYTES + 1)
    _v, _h, body = P.read_request(io.BytesIO(bytes(big)))
    with pytest.raises(P.ProtocolError, match="too large"):
        body.read()


def test_proto_fault_points_fire_at_send_and_recv():
    msg = _request(P, P.VERB_PING, {}, [b"abc"])
    with FaultPlan().at("proto.send").arm():
        with pytest.raises(InjectedFault):
            P.write_request(io.BytesIO(), P.VERB_PING, {})
    with FaultPlan().at("proto.recv", action="drop").arm():
        with pytest.raises(ConnectionResetError):
            P.read_request(io.BytesIO(msg))
    torn = io.BytesIO()
    with FaultPlan().at("proto.io.write", nth=2, action="short").arm() as plan:
        with pytest.raises(InjectedFault):
            P.write_request(torn, P.VERB_PING, {}, [b"z" * 100])
    assert plan.fired == [("proto.io.write", 2, "short")]
    assert msg[:6] == torn.getvalue()[:6] and len(torn.getvalue()) < len(msg) + 100
    with FaultPlan(record=True).arm() as plan:
        P.read_request(io.BytesIO(msg))[2].drain()
        P.write_response(io.BytesIO(), P.STATUS_OK, {})
    assert [n for n, _ in plan.sites] == ["proto.recv", "proto.send", "proto.io.write",
                                          "proto.io.write"]


# --------------------------------------------------------------- host pieces
def _stats_dicts():
    plane = {
        "uptime_s": 12.5, "plans": 3, "requests": {"compress": 4, "ping": 1, "stats": 0},
        "errors": 1, "shed": 2, "rate_limited": 0, "bytes_in": 1 << 33, "bytes_out": 17,
        "connections": 9, "active_connections": 1, "latency": {
            "compress": {"n": 4, "p50_ms": 1.25, "p99_ms": 7.0, "req_s": 0.333},
            "ping": {"n": 1, "p50_ms": 0.1, "p99_ms": 0.1, "req_s": None}},
        "sessions": {"f" * 64: {"created": 2, "idle": 1, "in_use": 1, "acquires": 5},
                     "0" * 64: {"created": 0, "idle": 0, "in_use": 0}},
        "resolve_cache": {"hits": 3, "misses": 1, "size": 1}, "coder_cache": {"hits": 0},
        "backend_health": {"device": {"quarantined": True, "failovers": 3}},
        "quarantine": {"a" * 64: {"quarantined": True, "trips": 2},
                       "b" * 64: {"quarantined": False, "trips": 0}},
        "rate_limiter": {"clients": 4}, "workers": 2, "workers_alive": 1,
        "worker_restarts": 1, "per_worker": {
            "1": {"requests": {"compress": 3}, "sessions": {"x": {"in_use": 2}},
                  "coder_cache": {"hits": 4}},
            'w"2\n': {"requests": {}, "sessions": {}}},
    }
    return {"empty": {}, "server": {"uptime_s": 0.0, "plans": 0, "requests": {"ping": 0},
                                    "errors": 0, "shed": 0, "quarantine": {},
                                    "backend_health": {}, "ok": True},
            "plane": plane}


@pytest.mark.parametrize("name", ["empty", "server", "plane"])
def test_render_prometheus_is_the_references_bytes(name):
    st = _stats_dicts()[name]
    assert metrics.render_prometheus(st) == ref_metrics.render_prometheus(st)
    assert metrics.CONTENT_TYPE == ref_metrics.CONTENT_TYPE


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_quarantine_answers_as_the_references():
    clocks = (_Clock(), _Clock())
    ours = Quarantine(threshold=3, cooldown_s=2.0, clock=clocks[0])
    theirs = ref_failover.Quarantine(threshold=3, cooldown_s=2.0, clock=clocks[1])
    rng = random.Random(5)
    for _ in range(600):
        key = rng.choice(["a", "b", "c"])
        op = rng.random()
        dt = rng.choice([0.0, 0.1, 0.7])
        for c in clocks:
            c.t += dt
        if op < 0.45:
            ours.record_failure(key), theirs.record_failure(key)
        elif op < 0.6:
            ours.record_success(key), theirs.record_success(key)
        got, want = ours.blocked(key), theirs.blocked(key)
        assert got == want
        assert ours.stats() == theirs.stats()
    assert any(v["trips"] for v in ours.stats().values())
    with pytest.raises(ValueError):
        Quarantine(threshold=0)


def test_token_bucket_and_rate_limiter_answer_as_the_references():
    rng = random.Random(9)
    clocks = (_Clock(), _Clock())
    ours = ratelimit.RateLimiter(2.0, 3.0, max_clients=3, clock=clocks[0])
    theirs = ref_ratelimit.RateLimiter(2.0, 3.0, max_clients=3, clock=clocks[1])
    for _ in range(800):
        dt = rng.choice([0.0, 0.01, 0.2, 1.5])
        for c in clocks:
            c.t += dt
        key, cost = f"conn:{rng.randrange(5)}", rng.choice([1.0, 1.0, 2.5])
        assert ours.check(key, cost) == theirs.check(key, cost)
    assert ours.stats() == theirs.stats() and ours.stats()["rejected"] > 0
    assert ratelimit.RateLimiter(0.5).burst == ref_ratelimit.RateLimiter(0.5).burst == 1.0
    b, rb = ratelimit.TokenBucket(1.0, 2.0, 0.0), ref_ratelimit.TokenBucket(1.0, 2.0, 0.0)
    for now in (0.0, 0.0, 0.0, 0.4, 3.0, 3.0, 3.1):
        assert b.try_take(now) == rb.try_take(now)
    for bad in ((0, 1), (1, 0), (-1, 1)):
        with pytest.raises(ValueError):
            ratelimit.TokenBucket(*bad, 0.0)


SPECS = ["text", "generic", "numeric", "float32", "bfloat16", "float64", "sao", "graph",
         "struct:3,5", "struct:8", "csv:8", "csv:3:;", "graph:bin:4", "graph:::"]


def test_registry_ids_and_digests_are_the_references():
    ours, theirs = registry.PlanRegistry(), ref_registry.PlanRegistry()
    for spec in SPECS:
        a, b = ours.register_profile(spec), theirs.register_profile(spec)
        assert a.describe() == b.describe()
        assert ours.register_profile(spec) is a  # idempotent
    assert ours.entries() == theirs.entries() and len(ours) == len(theirs) == len(SPECS)
    for reg in (ours, theirs):
        entry = reg.resolve("text")
        assert reg.resolve(entry.digest) is entry and reg.resolve(entry.digest[:12]) is entry
        for bad in ("nope", entry.digest[:4]):
            with pytest.raises(KeyError):
                reg.resolve(bad)
        with pytest.raises(ValueError):
            reg.register_profile("generic", plan_id="text")
        with pytest.raises(ValueError, match="unknown profile"):
            reg.register_profile("not-a-profile")
        assert "text" in reg and entry.digest in reg and "zzz" not in reg
    # an alias keeps its own id; the digest address stays with the first id
    a, b = ours.register_profile("text", plan_id="alias"), theirs.register_profile("text", "alias")
    assert a.describe() == b.describe() and ours.resolve(a.digest).plan_id == "text"


def test_registry_reads_every_tracked_plan_file_as_the_reference():
    paths = sorted((REPO / "tests" / "golden").glob("*.ozp")) + sorted(
        (REPO / "results" / "trained").glob("*.ozp"))
    assert len(paths) == 104
    ours, theirs = registry.PlanRegistry(), ref_registry.PlanRegistry()
    for path in paths:
        a = ours.register_file(path)
        assert a.describe() == theirs.register_file(path).describe()
        assert a.plan_id == path.stem and a.source == f"file:{path}"
    assert ours.entries() == theirs.entries()
    assert serialize.plan_digest(a.compressor.plan, format_version=a.compressor.format_version,
                                 level=a.compressor.level) == a.digest
