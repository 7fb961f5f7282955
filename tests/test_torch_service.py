"""The port's compression daemon end to end on the CPU, against the
reference's: ``repro_torch.service.CompressionServer(device="cpu")``.

Mirrors ``tests/test_service.py``: frames through the service equal the
offline ``compress``/``stream_io.compress_file`` frames and the reference's
``CompressionServer(backend="device")``'s, byte for byte, at several chunk
sizes; a port client talks to a reference server and a reference client to a
port server with equal containers; registry addressing by digest, file paths
and in-place, unknown sizes, concurrent clients, trained plans, unknown plans
keeping the connection, size lies, multi-byte views, idle reconnects,
garbage decompress, TCP, the cache counters, and the stats verb's keys equal
to the reference's.  Without a card the default device raises ``NoCardError``
before any socket is bound.  Every client has a timeout and every server is
shut down by its ``with``.
"""
import io
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.codecs import profiles as RPF  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import serial as ref_serial  # noqa: E402
from repro.service import CompressionServer as RefServer  # noqa: E402
from repro.service import PlanRegistry as RefRegistry  # noqa: E402
from repro.service import ServiceClient as RefClient  # noqa: E402
from repro.service import protocol as RP  # noqa: E402
from repro_torch import _device  # noqa: E402
from repro_torch.codecs import profiles as PF  # noqa: E402
from repro_torch.core import stream_io  # noqa: E402
from repro_torch.service import CompressionServer, PlanRegistry, ServiceClient  # noqa: E402
from repro_torch.service import protocol as P  # noqa: E402

CPU = "cpu"
DATA = (b"req=deadbeef level=INFO svc=auth handled in 42us\n" * 800)  # ~39 KB
CHUNK = 8 << 10
TIMEOUT = 20.0


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Both packages' resolve caches empty, so that a frame's selector choices
    are made on this test's data in each package."""
    ref_engine.resolve_cache_clear()
    repro_torch.resolve_cache_clear()


def _registry(*specs):
    reg = PlanRegistry()
    for spec in specs:
        reg.register_profile(spec)
    return reg


def _server(tmp_path, *specs, name="ozl.sock", **kw):
    kw.setdefault("request_timeout", TIMEOUT)
    return CompressionServer(_registry(*specs), socket_path=str(tmp_path / name),
                             device=CPU, **kw)


@pytest.fixture()
def server(tmp_path):
    with _server(tmp_path, "text", "generic", max_clients=8, sessions_per_plan=2) as srv:
        yield srv


def _offline(profile, data: bytes, chunk: int) -> bytes:
    return repro_torch.compress(getattr(PF, f"{profile}_profile")(), repro_torch.serial(data),
                                device=CPU, chunk_bytes=chunk or None)


# ----------------------------------------------------------------- identity
@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["single", "chunked"])
def test_service_byte_identical_to_offline(server, chunk):
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        frame, info = c.compress_bytes(DATA, "text", chunk_bytes=chunk)
        assert frame == _offline("text", DATA, chunk)
        assert info["bytes_in"] == len(DATA) and info["container"] == bool(chunk)
        back, dinfo = c.decompress_bytes(frame)
        assert back == DATA and dinfo["bytes_out"] == len(DATA)


@pytest.mark.parametrize("chunk", [0, 4096, CHUNK, 65536])
def test_cross_package_clients_and_servers_give_equal_containers(tmp_path, chunk):
    """A port client against a reference server(backend="device"), a
    reference client against a port server(device="cpu"): the same bytes."""
    ref_reg = RefRegistry()
    ref_reg.register_profile("generic")
    with RefServer(ref_reg, socket_path=str(tmp_path / "ref.sock"), backend="device",
                   request_timeout=TIMEOUT) as ref_srv, \
            _server(tmp_path, "generic", name="port.sock") as srv:
        with ServiceClient(ref_srv.address, timeout=TIMEOUT) as c:
            theirs, tinfo = c.compress_bytes(DATA, "generic", chunk_bytes=chunk)
            assert c.decompress_bytes(theirs)[0] == DATA
            assert c.ping()["protocol_version"] == 1
        with RefClient(srv.address, timeout=TIMEOUT) as c:
            ours, info = c.compress_bytes(DATA, "generic", chunk_bytes=chunk)
            assert c.decompress_bytes(ours)[0] == DATA
            assert c.ping()["protocol_version"] == 1
    assert ours == theirs
    assert ours == ref_compress(RPF.generic_profile(), ref_serial(DATA), backend="device",
                                chunk_bytes=chunk or None)
    assert info == tinfo  # the same stats keys and values, digest included


def test_service_plan_by_digest(server):
    entry = server.registry.resolve("generic")
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        frame, info = c.compress_bytes(DATA, entry.digest, chunk_bytes=CHUNK)
        assert info["plan_id"] == "generic" and info["digest"] == entry.digest
        assert frame == _offline("generic", DATA, CHUNK)


def test_service_file_paths_and_in_place(server, tmp_path):
    src = tmp_path / "corpus.bin"
    src.write_bytes(DATA)
    dst = tmp_path / "corpus.ozl"
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        stats = c.compress_file(src, dst, "text", chunk_bytes=CHUNK)
        assert stats["chunks"] == -(-len(DATA) // CHUNK)
        assert dst.read_bytes() == _offline("text", DATA, CHUNK)
        c.compress_file(src, src, "text", chunk_bytes=CHUNK)  # in place: no data loss
        assert src.read_bytes() == dst.read_bytes()
        c.decompress_file(src, src)
        assert src.read_bytes() == DATA
    offline = tmp_path / "offline.ozl"
    stream_io.compress_file(io.BytesIO(DATA), offline, PF.text_profile(), device=CPU,
                            chunk_bytes=CHUNK)
    assert offline.read_bytes() == dst.read_bytes()


def test_service_compress_without_size_header(server, tmp_path):
    """A file-object source sends no ``size``: the unknown-count path."""
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        for chunk in (0, CHUNK):
            dst = tmp_path / f"nosize{chunk}.ozl"
            stats = c.compress_file(io.BytesIO(DATA), dst, "text", chunk_bytes=chunk)
            assert stats["bytes_in"] == len(DATA)
            back, _ = c.decompress_bytes(dst.read_bytes())
            assert back == DATA


def test_service_concurrent_clients_byte_identical(server):
    """8 concurrent clients, interleaved plans: every frame matches offline."""
    want = {"text": _offline("text", DATA, CHUNK), "generic": _offline("generic", DATA, CHUNK)}
    errors = []

    def worker(i):
        plan = "text" if i % 2 == 0 else "generic"
        try:
            with ServiceClient(server.address, timeout=TIMEOUT) as c:
                for _ in range(3):
                    frame, _ = c.compress_bytes(DATA, plan, chunk_bytes=CHUNK)
                    assert frame == want[plan]
                    assert c.decompress_bytes(frame)[0] == DATA
        except Exception as err:  # pragma: no cover - failure reporting
            errors.append((i, err))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    st = server.stats()
    assert st["requests"]["compress"] == 24 and st["errors"] == 0
    for key_stats in st["sessions"].values():
        assert key_stats["in_use"] == 0
        assert key_stats["created"] <= server.pool.max_per_key


def test_service_trained_plan_deploys(tmp_path):
    comp = repro_torch.Compressor(repro_torch.pipeline(("zlib_backend", {"level": 6})),
                                  name="trained", level=6)
    ozp = tmp_path / "trained.ozp"
    ozp.write_bytes(comp.serialize())
    payload = np.cumsum(np.random.default_rng(3).integers(0, 9, 40_000)).astype(
        np.uint32).tobytes()
    reg = PlanRegistry()
    reg.register_file(ozp)
    with CompressionServer(reg, socket_path=str(tmp_path / "t.sock"), device=CPU) as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            frame, _ = c.compress_bytes(payload, "trained", chunk_bytes=CHUNK)
    reloaded = repro_torch.Compressor.deserialize(ozp.read_bytes(), device=CPU)
    assert frame == reloaded.compress(repro_torch.serial(payload), chunk_bytes=CHUNK)
    assert repro_torch.decompress(frame, device=CPU)[0].content_bytes() == payload


# ----------------------------------------------------------- error handling
def test_service_unknown_plan_keeps_connection(server):
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        with pytest.raises(RuntimeError, match="unknown plan"):
            c.compress_bytes(DATA, "no-such-plan")
        frame, _ = c.compress_bytes(DATA, "text", chunk_bytes=CHUNK)
        assert frame == _offline("text", DATA, CHUNK)
    assert server.stats()["errors"] == 1


def _hostile_compress(c, header):
    """A size-lying request -> the error header, or None when the server
    dropped the connection instead (an equally valid rejection)."""
    try:
        P.write_request(c._w, P.VERB_COMPRESS, header, P.iter_body_blocks(DATA))
        got = P.read_response_or_eof(c._r)
    except (BrokenPipeError, ConnectionResetError):
        return None
    if got is None:
        return None
    status, resp, body = got
    body.drain()
    assert status == P.STATUS_ERROR
    return resp


def test_service_size_lies_rejected(server):
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        _hostile_compress(c, {"plan": "text", "size": 10, "chunk_bytes": 0})
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        _hostile_compress(c, {"plan": "text", "size": len(DATA) * 2, "chunk_bytes": CHUNK})
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        assert len(DATA) % CHUNK != 0
        resp = _hostile_compress(c, {"plan": "text", "size": len(DATA) + 1,
                                     "chunk_bytes": CHUNK})
        if resp is not None:
            assert "declared size" in resp.get("error", "")
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        assert c.ping()["ok"]


def test_service_multibyte_memoryview_payload(server):
    arr = np.arange(1000, dtype=np.int64)
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        frame, info = c.compress_bytes(memoryview(arr), "generic", chunk_bytes=CHUNK)
        assert info["bytes_in"] == arr.nbytes
        assert c.decompress_bytes(frame)[0] == arr.tobytes()


def test_idle_client_reconnects_transparently(tmp_path):
    with _server(tmp_path, "generic", idle_timeout=0.2) as srv:
        src = tmp_path / "in.bin"
        src.write_bytes(DATA)
        with ServiceClient(srv.address, timeout=10.0) as c:
            frame, _ = c.compress_bytes(DATA, "generic", chunk_bytes=CHUNK)
            time.sleep(0.6)  # past the idle cutoff
            assert c.compress_bytes(DATA, "generic", chunk_bytes=CHUNK)[0] == frame
            time.sleep(0.6)
            dst = tmp_path / "out.ozl"
            c.compress_file(src, dst, "generic", chunk_bytes=CHUNK)
            assert dst.read_bytes() == frame
        assert srv.stats()["connections"] >= 3


def test_service_decompress_garbage_rejected(server):
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        with pytest.raises(RuntimeError, match="service error"):
            c.decompress_bytes(b"OZLJ this is not a real frame")
        assert c.ping()["ok"]


# -------------------------------------------------------------------- stats
def test_service_stats_keys_are_the_references(server, tmp_path):
    ref_reg = RefRegistry()
    ref_reg.register_profile("text")
    ref_reg.register_profile("generic")
    with RefServer(ref_reg, socket_path=str(tmp_path / "ref.sock"), backend="device",
                   request_timeout=TIMEOUT) as ref_srv:
        sts = []
        for address in (server.address, ref_srv.address):
            with ServiceClient(address, timeout=TIMEOUT) as c:
                frame, _ = c.compress_bytes(DATA, "text", chunk_bytes=CHUNK)
                c.decompress_bytes(frame)
                sts.append(c.stats())
    ours, theirs = sts
    assert set(ours) == set(theirs)
    for key in ("requests", "latency", "registry", "quarantine"):
        assert type(ours[key]) is type(theirs[key])
    assert set(ours["requests"]) == set(theirs["requests"])
    assert ours["registry"] == theirs["registry"]
    assert ours["requests"] == theirs["requests"] == {"ping": 0, "compress": 1,
                                                      "decompress": 1, "stats": 1}
    assert ours["bytes_in"] == theirs["bytes_in"] and ours["bytes_out"] == theirs["bytes_out"]
    assert set(ours["latency"]["compress"]) == set(theirs["latency"]["compress"])
    # the port has no host failover: nothing is ever benched or failed over
    assert ours["backend_health"] == {}
    assert theirs["backend_health"]["device"]["failovers"] == 0
    assert set(ours["sessions"]) == set(theirs["sessions"])
    for digest, counters in ours["sessions"].items():
        assert set(counters) == set(theirs["sessions"][digest])


def test_service_stats_expose_cache_counters(tmp_path):
    comp = repro_torch.Compressor(repro_torch.pipeline("huffman", "fse"), name="entropy")
    ozp = tmp_path / "entropy.ozp"
    ozp.write_bytes(comp.serialize())
    reg = PlanRegistry()
    reg.register_file(ozp)
    with CompressionServer(reg, socket_path=str(tmp_path / "ozl.sock"), device=CPU) as srv:
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            c.compress_bytes(DATA, "entropy")
            cold = c.stats()
            c.compress_bytes(DATA, "entropy")
            warm = c.stats()
    for st in (cold, warm):
        for key in ("resolve_cache", "coder_cache"):
            assert {"hits", "misses"} <= set(st[key]), st[key]
    assert warm["resolve_cache"]["hits"] > cold["resolve_cache"]["hits"]
    assert warm["coder_cache"]["hits"] > cold["coder_cache"]["hits"]


def test_metrics_verb_renders_the_stats(server):
    with ServiceClient(server.address, timeout=TIMEOUT) as c:
        c.compress_bytes(DATA, "text", chunk_bytes=CHUNK)
        text = c.metrics().decode()
    assert 'ozl_requests_total{verb="compress"} 1' in text
    assert "ozl_quarantined_plans 0" in text and text.endswith("\n")


def test_service_tcp_transport(tmp_path):
    with CompressionServer(_registry("generic"), host="127.0.0.1", port=0, device=CPU) as srv:
        assert ":" in srv.address
        with ServiceClient(srv.address, timeout=TIMEOUT) as c:
            frame, _ = c.compress_bytes(b"tcp payload " * 100, "generic")
            assert c.decompress_bytes(frame)[0] == b"tcp payload " * 100


def test_the_card_is_the_default_and_its_absence_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "nocard.sock"
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(_device.NoCardError):
            CompressionServer(_registry("text"), socket_path=str(path), **kw)
        assert not path.exists()
    with CompressionServer(_registry("text"), socket_path=str(path), device=CPU) as srv:
        assert srv.device == torch.device("cpu")
        assert srv.pool.keys() == []  # sessions are made per plan on first use
    with pytest.raises(ValueError, match="exactly one"):
        CompressionServer(_registry("text"), device=CPU)
    assert RP.PROTOCOL_VERSION == P.PROTOCOL_VERSION
