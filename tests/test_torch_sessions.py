"""Sessions, the resolve and coder-table caches, and file streaming against
the reference, on the CPU, tolerance 0.

Mirrors ``tests/test_streaming_sessions.py``.  Every frame, container, file
and trace of the port (``device="cpu"``, ``n_workers`` 1 and 4) is held
against the reference's ``CompressorSession(backend="device")``,
``DecompressorSession`` and ``stream_io`` on the same inputs, with both
packages' resolve caches (and coder-table caches) cleared at the same points,
so the caches' hits and misses can be compared too.  The port's sessions
have no host failover, and a kernel's error is never caught in the pool.
"""
import contextlib
import inspect
import io
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro import codecs as ref_codecs  # noqa: E402
from repro.codecs import coder_cache as ref_coder_cache  # noqa: E402
from repro.core import CompressorSession as RefCompressorSession  # noqa: E402
from repro.core import DecompressorSession as RefDecompressorSession  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import numeric as ref_numeric  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import serial as ref_serial  # noqa: E402
from repro.core import stream_io as ref_stream_io  # noqa: E402
from repro.core import strings as ref_strings  # noqa: E402
from repro.core import struct as ref_struct  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro_torch import codecs as port_codecs  # noqa: E402
from repro_torch.codecs import coder_cache  # noqa: E402
from repro_torch.core import engine, stream_io, wire  # noqa: E402
from repro_torch.core.message import SType, from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _empty_caches():
    """Both packages start every test from empty caches."""
    ref_engine.resolve_cache_clear()
    engine.resolve_cache_clear()
    ref_coder_cache.coder_cache_clear()
    coder_cache.coder_cache_clear()
    yield


def _inputs(kind: str, seed: int = 0):
    """(reference stream, port stream) of the same values."""
    rng = np.random.default_rng(seed)
    if kind == "numeric":
        x = rng.integers(0, 40, 12000, dtype=np.int64).cumsum().astype(np.uint32)
        return ref_numeric(x), repro_torch.numeric(x)
    if kind == "wide":
        x = rng.integers(0, 9999, 4001, dtype=np.uint16)
        return ref_numeric(x), repro_torch.numeric(x)
    if kind == "struct":
        # small: its chunks go to tANS, whose plain walk takes a Python step
        # a symbol on the CPU
        raw = rng.integers(0, 16, 12 * 200, dtype=np.uint8).tobytes()
        return ref_struct(raw, 12), repro_torch.struct(raw, 12)
    if kind == "string":
        items = [bytes(rng.integers(97, 123, int(n), dtype=np.uint8))
                 for n in rng.integers(0, 40, 300)]
        return ref_strings(items), repro_torch.strings(items)
    raise KeyError(kind)


def _port_of(ref_s):
    return from_numpy(ref_s.data, SType(int(ref_s.stype)), ref_s.width)


def _same(port_s, ref_s):
    assert port_s.stype == SType(int(ref_s.stype)) and port_s.width == ref_s.width
    assert port_s.content_bytes() == ref_s.content_bytes()
    if ref_s.lengths is not None:
        assert np.array_equal(port_s.lengths, ref_s.lengths)


def _ref_session(plan, **kw):
    return RefCompressorSession(plan, backend="device", **kw)


# ----------------------------------------------------------------- sessions
@pytest.mark.parametrize("n_workers", (1, 4))
@pytest.mark.parametrize("kind,chunk_bytes", [
    ("numeric", 4096), ("wide", 1000), ("struct", 777), ("string", 512), ("string", 64),
])
def test_session_containers_equal_the_references(kind, chunk_bytes, n_workers):
    ref_s, s = _inputs(kind)
    with _ref_session(ref_codecs.generic_profile(), chunk_bytes=chunk_bytes) as ref:
        want = ref.compress(ref_s)
    with repro_torch.CompressorSession(
        repro_torch.generic_profile(), device=CPU, chunk_bytes=chunk_bytes, n_workers=n_workers
    ) as sess:
        frame = sess.compress(s)
        assert sess.stats["chunks"] > 1
    assert frame == want
    with repro_torch.DecompressorSession(device=CPU, n_workers=n_workers) as dec:
        (back,) = dec.decompress(frame)
        (streamed,) = dec.decompress_from(io.BytesIO(frame))
    _same(back, ref_s)
    _same(streamed, ref_s)


@pytest.mark.parametrize("use_cache", (True, False))
def test_cold_and_warm_calls_equal_the_references_with_their_cache_counts(use_cache):
    """One call sequence in both packages: two streams of one shape through a
    selector profile, unchunked and chunked; every frame and the resolve
    caches' hits and misses agree after every call."""
    a = _inputs("numeric", 1)
    b = _inputs("numeric", 2)
    ref_prof, prof = ref_codecs.numeric_profile(), repro_torch.numeric_profile()
    with _ref_session(ref_prof, use_resolve_cache=use_cache) as ref, \
            repro_torch.CompressorSession(prof, device=CPU, use_resolve_cache=use_cache,
                                          n_workers=4) as sess:
        for (ref_s, s), cb in ((a, 0), (a, 0), (b, 0), (a, 8192), (b, 8192)):
            assert sess.compress(s, chunk_bytes=cb) == ref.compress(ref_s, chunk_bytes=cb)
            assert repro_torch.resolve_cache_info() == ref_engine.resolve_cache_info()
    # the trials consult the cache either way; the session's own lookups only with it on
    assert repro_torch.resolve_cache_info()["hits"] > 0
    buf = io.BytesIO()
    with repro_torch.CompressorSession(prof, device=CPU, chunk_bytes=8192) as sess:
        n = sess.compress_to(a[1], buf)
    assert buf.getvalue() == ref_compress(ref_prof, a[0], backend="device", chunk_bytes=8192)
    assert n == len(buf.getvalue())


def test_module_compress_is_a_session_with_the_references_defaults():
    ref_s, s = _inputs("numeric")
    for cb in (None, 4096):
        want = ref_compress(ref_codecs.generic_profile(), ref_s, backend="device", chunk_bytes=cb)
        got = repro_torch.compress(repro_torch.generic_profile(), s, device=CPU,
                                   chunk_bytes=cb, n_workers=3)
        assert got == want
        assert repro_torch.resolve_cache_info() == ref_engine.resolve_cache_info()
        (back,) = repro_torch.decompress(got, device=CPU, n_workers=3)
        _same(back, ref_s)


def test_a_cached_resolution_the_new_values_refuse_is_resolved_afresh():
    """range_pack over a range past 57 bits refuses the cached choice made on
    narrow values of the same shape; both packages resolve afresh."""
    narrow = np.arange(4096, dtype=np.uint64) * 3
    wide = narrow.copy()
    wide[::7] = np.uint64(1) << np.uint64(63)
    prof = ref_codecs.numeric_profile(), repro_torch.numeric_profile()
    for x in (narrow, wide):
        want = ref_compress(prof[0], ref_numeric(x), backend="device")
        assert repro_torch.compress(prof[1], repro_torch.numeric(x), device=CPU) == want
        assert repro_torch.resolve_cache_info() == ref_engine.resolve_cache_info()
    (back,) = repro_torch.decompress(want, device=CPU)
    assert back.content_bytes() == wide.tobytes()


def test_resolve_takes_metas_for_selector_free_plans_as_the_reference_does():
    ref_s, s = _inputs("numeric")
    plan = repro_torch.pipeline("delta", "range_pack")
    meta = engine.stream_meta(s)
    assert meta == engine.StreamMeta(SType.NUMERIC, 4, 12000 .bit_length())
    r = engine.resolve(plan, [meta])
    assert r.codec_names() == ["delta", "range_pack"]
    assert engine.resolve(plan, [s]) is r  # one cached entry for the shape
    with pytest.raises(ValueError, match="concrete streams"):
        engine.resolve(repro_torch.numeric_profile(), [meta])
    with pytest.raises(ValueError, match="concrete streams"):
        ref_engine.resolve(ref_codecs.numeric_profile(), [ref_engine.stream_meta(ref_s)])
    assert engine._CACHE_MAX == ref_engine._CACHE_MAX == 512


@pytest.mark.parametrize("which", ("fused", "lowered", "selector"))
def test_compress_traced_equals_the_references_trace(which):
    if which == "selector":
        ref_s, s = _inputs("numeric")
        plans = ref_codecs.numeric_profile(), repro_torch.numeric_profile()
    else:
        x = np.arange(0, 60000, 15 if which == "fused" else 5, dtype=np.uint32)
        ref_s, s = ref_numeric(x), repro_torch.numeric(x)
        plans = ref_pipeline("delta", "bitpack"), repro_torch.pipeline("delta", "bitpack")
    with _ref_session(plans[0]) as ref:
        want, want_trace, _ = ref.compress_traced(ref_s)
    with repro_torch.CompressorSession(plans[1], device=CPU) as sess:
        frame, trace, seconds = sess.compress_traced(s)
    assert frame == want and trace == want_trace and seconds > 0
    names = [n for n, _ in trace]
    assert ("fused_delta_bitpack" in names) == (which == "fused")


def test_execute_fuse_false_and_its_trace_equal_the_references():
    x = np.arange(0, 60000, 15, dtype=np.uint32)
    ref_r = ref_engine.resolve(ref_pipeline("delta", "bitpack"), [ref_numeric(x)])
    r = engine.resolve(repro_torch.pipeline("delta", "bitpack"), [repro_torch.numeric(x)])
    for fuse in (True, False):
        want_trace, trace = [], []
        want = ref_engine.execute(ref_r, [ref_numeric(x)], backend="device", fuse=fuse,
                                  trace=want_trace)
        assert engine.execute(r, [repro_torch.numeric(x)], fuse=fuse, trace=trace) == want
        assert trace == want_trace
    assert engine.fuse_resolved(r).fused and engine.fuse_resolved(engine.fuse_resolved(r)).fused


# -------------------------------------------------------------- the window
def test_window_bounds_inflight_chunks():
    x = np.arange(100000, dtype=np.uint32)
    plan = repro_torch.pipeline("delta", "range_pack")
    want = ref_compress(ref_pipeline("delta", "range_pack"), ref_numeric(x), backend="device",
                        chunk_bytes=1024)
    with repro_torch.CompressorSession(plan, device=CPU, chunk_bytes=1024, window=3,
                                       n_workers=4) as sess:
        assert sess.compress(repro_torch.numeric(x)) == want
        assert sess.stats["chunks"] > 20
        assert 1 <= sess.stats["max_inflight"] <= 3
    with repro_torch.DecompressorSession(device=CPU, window=2, n_workers=4) as dec:
        (out,) = dec.decompress_from(io.BytesIO(want))
        assert dec.stats["max_inflight"] <= 2
    assert out.content_bytes() == x.tobytes()


def test_prefetch_knob_and_lazy_source_keep_the_frames():
    x = np.arange(120000, dtype=np.uint32)
    plan = repro_torch.pipeline("delta", "range_pack")
    want = ref_compress(ref_pipeline("delta", "range_pack"), ref_numeric(x), backend="device",
                        chunk_bytes=4096)
    for prefetch in (True, False):
        with repro_torch.CompressorSession(plan, device=CPU, chunk_bytes=4096, n_workers=2,
                                           prefetch=prefetch) as sess:
            assert sess.compress(repro_torch.numeric(x)) == want
            st = sess.stats
            assert (st["prefetch_hits"] + st["prefetch_misses"] > 0) == prefetch
    chunks = engine._split_chunks(repro_torch.numeric(x), 4096)
    with repro_torch.CompressorSession(plan, device=CPU, n_workers=2) as sess:
        buf = io.BytesIO()
        sess.compress_chunks(iter(chunks), buf, n_chunks=len(chunks))
        assert buf.getvalue() == want
        assert sess.stats["prefetch_hits"] + sess.stats["prefetch_misses"] >= len(chunks) - 1


def test_a_source_that_fails_mid_draw_raises_promptly():
    x = np.arange(120000, dtype=np.uint32)
    plan = repro_torch.pipeline("delta", "range_pack")
    chunks = engine._split_chunks(repro_torch.numeric(x), 4096)

    class SourceDied(Exception):
        pass

    def source():
        yield from chunks[:3]
        raise SourceDied("lazy source died mid-stream")

    with repro_torch.CompressorSession(plan, device=CPU, chunk_bytes=4096, n_workers=2) as sess:
        t0 = time.perf_counter()
        with pytest.raises(SourceDied, match="died mid-stream"):
            sess.compress_chunks(source(), io.BytesIO(), n_chunks=len(chunks))
        assert time.perf_counter() - t0 < 5.0
        # the pool survives a poisoned source
        want = ref_compress(ref_pipeline("delta", "range_pack"), ref_numeric(x),
                            backend="device", chunk_bytes=4096)
        assert sess.compress(repro_torch.numeric(x)) == want


def test_chunk_errors_in_order_and_no_failover():
    """No host failover: the session takes no ``failover=``, and a kernel's
    error in a pool worker propagates without a fresh resolve."""
    assert "failover" not in inspect.signature(repro_torch.CompressorSession).parameters
    assert "failover" in inspect.signature(RefCompressorSession).parameters
    x = np.arange(60000, dtype=np.uint32)
    before = engine.fresh_resolves
    real = ops.delta_encode

    def broken(t):
        if t.numel() == 1024:
            raise ops.KernelError("delta_encode: injected")
        return real(t)

    ops.delta_encode = broken
    try:
        with repro_torch.CompressorSession(repro_torch.pipeline("delta", "range_pack"),
                                           device=CPU, chunk_bytes=4096, n_workers=4) as sess:
            with pytest.raises(ops.KernelError, match="injected"):
                sess.compress(repro_torch.numeric(x[:1024 * 30 + 1024]))
    finally:
        ops.delta_encode = real
    assert engine.fresh_resolves == before


def test_a_chunk_the_shared_resolution_refuses_is_resolved_afresh_on_the_pool():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 20, 40000, dtype=np.uint64)
    x[30000::5] = np.uint64(1) << np.uint64(63)  # a late chunk range_pack refuses
    before = engine.fresh_resolves
    want = ref_compress(ref_codecs.numeric_profile(), ref_numeric(x), backend="device",
                        chunk_bytes=32768, use_resolve_cache=False)
    got = repro_torch.compress(repro_torch.numeric_profile(), repro_torch.numeric(x), device=CPU,
                               chunk_bytes=32768, n_workers=4, use_resolve_cache=False)
    assert got == want
    assert engine.fresh_resolves > before


# -------------------------------------------------------------- the pool
def test_session_pool_checkout_backpressure_and_poisoning():
    plan = repro_torch.pipeline("delta", "range_pack")
    pool = repro_torch.SessionPool(max_per_key=2)
    pool.register("k", lambda: repro_torch.CompressorSession(plan, device=CPU))
    s = repro_torch.numeric(np.arange(100, dtype=np.uint32))
    with pool.acquire("k") as a, pool.acquire("k") as b:
        assert a is not b
        with pytest.raises(TimeoutError):
            with pool.acquire("k", timeout=0.05):
                pass
        a.compress(s)
    assert pool.stats()["k"]["created"] == 2 and pool.total_in_use() == 0
    with pytest.raises(RuntimeError):
        with pool.acquire("k") as c:
            raise RuntimeError("request died")
    st = pool.stats()["k"]
    assert st["drops"] == 1 and st["created"] == 1 and c not in pool._idle["k"]
    with pytest.raises(KeyError):
        with pool.acquire("nope"):
            pass
    assert pool.keys() == ["k"]
    pool.close()
    assert pool.keys() == [] and pool.total_in_use() == 0
    with pytest.raises(ValueError):
        repro_torch.SessionPool(max_per_key=0)


def test_iter_frames_yields_the_references_chunks_and_salvage_waits():
    ref_s, s = _inputs("struct")
    frame = ref_compress(ref_codecs.generic_profile(), ref_s, backend="device", chunk_bytes=512)
    with RefDecompressorSession() as rdec:
        want = list(rdec.iter_frames(io.BytesIO(frame)))
    with repro_torch.DecompressorSession(device=CPU, n_workers=4) as dec:
        got = list(dec.iter_frames(io.BytesIO(frame)))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            _same(g, w)
        bare = ref_compress(ref_codecs.generic_profile(), ref_s, backend="device")
        (one,) = dec.iter_frames(io.BytesIO(bare))
        _same(one, ref_s)
        streams, report = dec.decompress_salvage(frame)
        with RefDecompressorSession() as rdec:
            ref_streams, ref_report = rdec.decompress_salvage(frame)
        assert report.to_dict() == ref_report.to_dict() and report.intact
        assert [x.content_bytes() for x in streams] == [x.content_bytes() for x in ref_streams]
        bad = bytearray(frame)
        bad[-1] ^= 1  # the container's CRC
        with pytest.raises(wire.FrameError):
            list(dec.iter_frames(io.BytesIO(bytes(bad))))


# ------------------------------------------------------ coder-table cache
def test_frames_are_equal_with_the_coder_cache_disabled_and_tables_are_shared():
    ref_s, s = _inputs("struct", 3)
    plan = repro_torch.generic_profile()
    want = ref_compress(ref_codecs.generic_profile(), ref_s, backend="device", chunk_bytes=512)
    x = repro_torch.serial(np.resize(np.arange(7, dtype=np.uint8), 5000).tobytes())
    lookups = {}
    for cached in (False, True):
        coder_cache.coder_cache_clear()
        with contextlib.ExitStack() as stack:
            if not cached:
                stack.enter_context(coder_cache.coder_cache_disabled())
            # a session with a cache of its own, and the throwaway sessions
            # of compress() and decompress(), which share the process-wide one
            with repro_torch.CompressorSession(plan, device=CPU, chunk_bytes=512, n_workers=1,
                                               table_cache_size=64) as own:
                off = own.compress(s)
            for name in ("huffman", "fse"):
                p = repro_torch.pipeline(name)
                frame = repro_torch.compress(p, x, device=CPU)
                assert frame == ref_compress(
                    ref_pipeline(name), ref_serial(x.content_bytes()), backend="device")
                (back,) = repro_torch.decompress(frame, device=CPU)
                assert back.content_bytes() == x.content_bytes()
        info, shared = own.scratch.table_cache_info(), coder_cache.coder_cache_info()
        lookups[cached] = (info["hits"] + info["misses"], shared["hits"] + shared["misses"],
                           info["size"], shared["size"])
        assert off == want
    # caching off: no cache on the engine path saw a lookup or kept a table;
    # caching on: both did, so the first pass really ran without them
    assert lookups[False] == (0, 0, 0, 0), lookups
    assert min(lookups[True]) > 0, lookups
    engine.resolve_cache_clear()
    ref_engine.resolve_cache_clear()
    with repro_torch.CompressorSession(plan, device=CPU, chunk_bytes=512, n_workers=2) as sess:
        on = sess.compress(s)
    assert on == off == want
    # chunks of one histogram share their tables through the session's
    # scratch (one worker, so that no two chunks build a table at once)
    x = np.resize(np.arange(7, dtype=np.uint8), 7000).tobytes()
    for name in ("huffman", "fse"):
        want = ref_compress(ref_pipeline(name), ref_serial(x), backend="device", chunk_bytes=630)
        for n_workers in (1, 2):
            with repro_torch.CompressorSession(repro_torch.pipeline(name), device=CPU,
                                               chunk_bytes=630, n_workers=n_workers) as sess:
                assert sess.compress(repro_torch.serial(x)) == want
                info = sess.scratch.table_cache_info()
            with repro_torch.DecompressorSession(device=CPU, n_workers=n_workers) as dec:
                (back,) = dec.decompress(want)
                dec_info = dec.scratch.table_cache_info()
            assert back.content_bytes() == x
            if n_workers == 1:  # 11 chunks of 90 of each symbol, then a shorter one
                assert info["hits"] >= 8 and dec_info["hits"] >= 8, (info, dec_info)


def test_the_coder_cache_keys_a_tables_device():
    calls = []
    cache = coder_cache.CoderCache(maxsize=4)
    with coder_cache.scoped(cache):
        assert coder_cache.active_cache() is cache
        from repro_torch.codecs import entropy

        def build():
            calls.append(1)
            return torch.arange(3)

        host = entropy._on_device(("t",), build, torch.device("cpu"))
        again = entropy._on_device(("t",), build, torch.device("cpu"))
        meta = entropy._on_device(("t",), build, torch.device("meta"))
    assert host is again and len(calls) == 1
    assert meta.device.type == "meta" and ("t", "meta") in cache._data
    assert coder_cache.active_cache() is not cache
    for i in range(6):
        cache.get_or_build((i,), lambda: i)
    assert cache.info()["size"] == 4 and ref_coder_cache.CoderCache(4).maxsize == 4


# --------------------------------------------------------------- containers
def test_an_unknown_count_container_is_the_references():
    frames = [ref_compress(ref_pipeline("store"), ref_serial(bytes([i]) * 9), backend="device")
              for i in range(3)]
    want, got = io.BytesIO(), io.BytesIO()
    for out, mod in ((want, ref_wire), (got, wire)):
        with mod.ContainerWriter(out, 4, None) as w:
            for f in frames:
                w.write_chunk(f)
    assert got.getvalue() == want.getvalue()
    assert wire.read_container(got.getvalue())[1] == frames
    assert got.getvalue() != wire.write_container(4, frames)  # the padded count

    class WriteOnly(io.RawIOBase):
        def writable(self):
            return True

    with pytest.raises(ValueError, match="seekable"):
        wire.ContainerWriter(WriteOnly(), 4, None)
    with pytest.raises(ValueError, match="at least one chunk"):
        wire.ContainerWriter(io.BytesIO(), 4, None).close()


# ---------------------------------------------------------------- stream_io
def _file_data(n: int) -> bytes:
    rng = np.random.default_rng(8)
    return b"repeat me " * (n // 20) + bytes(rng.integers(0, 256, n // 2, dtype=np.uint8))


class _NoSeek:
    """A pipe: read() only."""

    def __init__(self, b: bytes):
        self._f = io.BytesIO(b)

    def read(self, n=-1):
        return self._f.read(n)

    def seekable(self):
        return False


@pytest.mark.parametrize("source", ("path", "pipe", "small", "small_pipe"))
def test_compress_file_and_decompress_file_equal_the_references(tmp_path, source):
    data = _file_data(200 if source.startswith("small") else 150000)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    ref_dst, dst = tmp_path / "ref.ozl", tmp_path / "out.ozl"
    pipe = source.endswith("pipe")
    ref_stats = ref_stream_io.compress_file(
        _NoSeek(data) if pipe else src, ref_dst, ref_codecs.text_profile(), backend="device",
        chunk_bytes=16384,
    )
    stats = stream_io.compress_file(
        _NoSeek(data) if pipe else src, dst, repro_torch.text_profile(), device=CPU,
        chunk_bytes=16384, n_workers=4,
    )
    assert dst.read_bytes() == ref_dst.read_bytes()
    assert stats == ref_stats
    assert stats["container"] == (not source.startswith("small"))
    if source == "path":
        assert dst.read_bytes() == ref_compress(ref_codecs.text_profile(), ref_serial(data),
                                                backend="device", chunk_bytes=16384)
    rt, ref_rt = tmp_path / "rt.bin", tmp_path / "ref_rt.bin"
    dstats = stream_io.decompress_file(dst, rt, device=CPU, n_workers=4)
    assert dstats == ref_stream_io.decompress_file(ref_dst, ref_rt)
    assert rt.read_bytes() == data == ref_rt.read_bytes()


def test_a_pipes_container_decodes_as_the_known_size_one(tmp_path):
    data = _file_data(150000)
    known, piped = io.BytesIO(), io.BytesIO()
    stream_io.compress_file(io.BytesIO(data), known, repro_torch.text_profile(), device=CPU,
                            chunk_bytes=16384)
    stream_io.compress_file(_NoSeek(data), piped, repro_torch.text_profile(), device=CPU,
                            chunk_bytes=16384)
    a, b = known.getvalue(), piped.getvalue()
    assert a != b and wire.read_container(a)[1] == wire.read_container(b)[1]
    (back,) = repro_torch.decompress(b, device=CPU)
    assert back.content_bytes() == data


def test_compress_f_to_f_keeps_the_source_and_an_error_leaves_no_output(tmp_path):
    data = _file_data(60000)
    f = tmp_path / "same.bin"
    f.write_bytes(data)
    assert stream_io.same_path(f, tmp_path / "." / "same.bin")
    stream_io.compress_file(f, f, repro_torch.text_profile(), device=CPU, chunk_bytes=16384)
    rt = tmp_path / "rt.bin"
    stream_io.decompress_file(f, rt, device=CPU)
    assert rt.read_bytes() == data

    class Dies:
        def __init__(self):
            self.n = 0

        def read(self, n=-1):
            self.n += 1
            if self.n > 2:
                raise OSError("source died")
            return data[:n]

        def seekable(self):
            return False

    out = tmp_path / "out.ozl"
    with pytest.raises(OSError, match="source died"):
        stream_io.compress_file(Dies(), out, repro_torch.text_profile(), device=CPU,
                                chunk_bytes=4096)
    assert not out.exists()
    out.write_bytes(b"old")
    with pytest.raises(wire.FrameError):
        stream_io.decompress_file(io.BytesIO(b"OZLC\x04garbage"), out, device=CPU)
    assert out.read_bytes() == b"old"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out.ozl", "rt.bin", "same.bin"]


def test_compress_file_reuses_a_session_and_checks_its_plan(tmp_path):
    plan = repro_torch.text_profile()
    with repro_torch.CompressorSession(plan, device=CPU, chunk_bytes=4096) as sess, \
            repro_torch.DecompressorSession(device=CPU) as dec:
        for i in range(3):
            data = (b"payload %d " % i) * 5000
            src, dst, rt = (tmp_path / f"{n}{i}" for n in ("in", "out", "rt"))
            src.write_bytes(data)
            stream_io.compress_file(src, dst, plan, session=sess)
            stream_io.decompress_file(dst, rt, session=dec)
            assert rt.read_bytes() == data
        # compress_file chunks at its own 4 MiB default: each file is a bare frame
        assert sess.stats["calls"] == 3 and dec.stats["chunks"] >= 3
        with pytest.raises(ValueError, match="does not match"):
            stream_io.compress_file(src, tmp_path / "o", repro_torch.numeric_profile(),
                                    session=sess)
    assert [c.content_bytes() for c in stream_io.iter_file_chunks(io.BytesIO(b"abcdefg"), 3)] == [
        b"abc", b"def", b"g"]
    s = repro_torch.numeric(np.arange(10, dtype=np.uint16))
    assert [c.content_bytes() for c in stream_io.iter_stream_chunks(s, 6)] == [
        c.content_bytes() for c in engine._split_chunks(s, 6)] and len(list(
            stream_io.iter_stream_chunks(s, 6))) == 4
    with pytest.raises(ValueError):
        list(stream_io.iter_file_chunks(io.BytesIO(b"x"), 0))


def test_the_packages_export_what_the_reference_exports():
    for name in ("CompressorSession", "DecompressorSession", "SessionPool", "ExecScratch",
                 "resolve_cache_info", "resolve_cache_clear", "StreamMeta", "stream_meta"):
        assert hasattr(engine, name) and hasattr(ref_engine, name)
    for name in ("coder_cache_info", "coder_cache_clear", "coder_cache_disabled"):
        assert hasattr(port_codecs, name) and hasattr(ref_coder_cache, name)
    assert repro_torch.CompressorSession is engine.CompressorSession


def test_launch_counts_add_up_across_pool_threads():
    """The kernels' launch counters are bumped under a lock: a pool of
    threads counting at once loses no launch."""
    from concurrent.futures import ThreadPoolExecutor

    import sys

    ops.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        with ThreadPoolExecutor(16) as pool:
            list(pool.map(lambda _: [ops._count(ops.delta_encode) for _ in range(5000)],
                          range(16), timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert ops.launch_counts()["delta_encode"] == 80000
    ops.reset_launches()
    assert set(ops.launch_counts().values()) == {0}
