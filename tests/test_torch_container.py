"""Chunked compression and multi-chunk containers: the port against the reference.

The ``OZLC`` record's writer and readers agree with ``repro.core.wire`` byte
for byte and fail closed on the same malformed records; ``_split_chunks``
cuts every stream type at the reference's boundaries (as views, with no
copy); ``compress(..., chunk_bytes=N, device="cpu")`` writes the
reference's ``backend="device"`` container (``use_resolve_cache=False``),
including where a later chunk refuses the first chunk's resolution and is
resolved afresh; each package decodes the other's containers.  Also
``interpret_numeric`` and the ``generic_auto`` selector, which the
reference's default ``compress`` path (the generic profile at 4 MiB chunks)
runs.  Tolerance 0 throughout: frames and decoded bytes are compared exactly.
"""
import io
import struct as pystruct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.codecs import profiles as ref_profiles  # noqa: E402
from repro.core import CompressionCtx as RefCtx  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro.core.graph import pipeline as ref_pipeline  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro_torch import CompressionCtx  # noqa: E402
from repro_torch.core import engine, wire  # noqa: E402
from repro_torch.core.message import Stream, SType, from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _pair(arr, stype, width, lengths=None):
    """The same bytes as a reference stream and as a port (CPU) stream."""
    ref = RefStream(arr, RefSType(int(stype)), width, lengths).validate()
    if stype == SType.STRING:
        return ref, Stream(torch.from_numpy(arr.copy()), SType.STRING, 1, lengths).validate()
    return ref, from_numpy(arr, stype, width)


def _frames(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [
        repro_torch.compress(
            repro_torch.pipeline("store"),
            repro_torch.serial(rng.integers(0, 256, 100 + 37 * i, dtype=np.uint8)),
            device="cpu", use_resolve_cache=False,
        )
        for i in range(n)
    ]


# ---------------------------------------------------------------------- wire
def test_container_writer_and_readers_match_the_reference():
    frames = _frames(4)
    blob = wire.write_container(4, frames)
    assert blob == ref_wire.write_container(4, frames)
    assert wire.is_container(blob) and ref_wire.is_container(blob)
    buf = io.BytesIO()
    with wire.ContainerWriter(buf, 4, n_chunks=len(frames)) as w:
        for f in frames:
            w.write_chunk(f)
    assert buf.getvalue() == blob and w.bytes_written == len(blob)
    version, got = wire.read_container(blob)
    assert (version, [bytes(c) for c in got]) == ref_wire.read_container(blob)
    assert list(wire.iter_container_frames(io.BytesIO(blob))) == list(
        ref_wire.iter_container_frames(io.BytesIO(blob))
    )


class _WriteOnly(io.RawIOBase):
    def writable(self):
        return True


def test_container_writer_refuses_what_the_reference_refuses():
    frames = _frames(2)
    with pytest.raises(ValueError):
        wire.ContainerWriter(io.BytesIO(), 3, n_chunks=1)
    with pytest.raises(ValueError):
        wire.ContainerWriter(io.BytesIO(), 4, n_chunks=0)
    unknown = wire.ContainerWriter(io.BytesIO(), 4)  # count backpatched at close
    with pytest.raises(ValueError, match="at least one chunk"):
        unknown.close()
    with pytest.raises(ValueError, match="seekable"):
        wire.ContainerWriter(_WriteOnly(), 4)
    with pytest.raises(ValueError, match="seekable"):
        ref_wire.ContainerWriter(_WriteOnly(), 4)
    w = wire.ContainerWriter(io.BytesIO(), 4, n_chunks=1)
    with pytest.raises(ValueError):
        w.write_chunk(wire.write_container(4, frames))  # no nesting
    w.write_chunk(frames[0])
    with pytest.raises(ValueError):
        w.write_chunk(frames[1])  # more than promised
    # salvage never raises on a record: an empty one yields nothing and says why
    rep, ref_rep = wire.SalvageReport(), ref_wire.SalvageReport()
    assert list(wire.iter_container_frames(io.BytesIO(b""), salvage=True, report=rep)) == []
    assert list(ref_wire.iter_container_frames(io.BytesIO(b""), salvage=True, report=ref_rep)) == []
    assert rep.to_dict() == ref_rep.to_dict() and not rep.intact


def _sealed(body: bytes) -> bytes:
    return body + pystruct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def _chunks_body(version, frames, count=None):
    out = bytearray(b"OZLC")
    out.append(version)
    wire.write_varint(out, len(frames) if count is None else count)
    for f in frames:
        wire.write_varint(out, len(f))
        out += f
    return bytes(out)


def _malformed(case):
    frames = _frames(3)
    good = wire.write_container(4, frames)
    if case == "bad_magic":
        return b"OZLX" + good[4:]
    if case == "version_3":
        return _sealed(_chunks_body(3, frames))
    if case == "too_many_chunks":
        return _sealed(_chunks_body(4, [], count=1_000_001))
    if case == "empty":
        return _sealed(_chunks_body(4, []))
    if case == "truncated_chunk":
        return _sealed(_chunks_body(4, frames)[:-5])
    if case == "truncated_trailer":
        return good[:-2]
    if case == "nested":
        return _sealed(_chunks_body(4, [frames[0], good]))
    if case == "not_a_frame":
        return _sealed(_chunks_body(4, [frames[0], b"XXXX" + frames[1][4:]]))
    if case == "crc_mismatch":  # one payload byte of the third chunk flipped
        blob = bytearray(good)
        blob[len(good) - 4 - 20] ^= 0x40
        return bytes(blob)
    if case == "trailing_garbage":
        return _sealed(good[:-4] + b"\x00")
    raise AssertionError(case)


MALFORMED = ("bad_magic", "version_3", "too_many_chunks", "empty", "truncated_chunk",
             "truncated_trailer", "nested", "not_a_frame", "crc_mismatch", "trailing_garbage")


@pytest.mark.parametrize("reader", ("decompress", "iter_container_frames"))
@pytest.mark.parametrize("package", ("port", "reference"))
@pytest.mark.parametrize("case", MALFORMED)
def test_malformed_container_fails_closed_in_both_packages(case, package, reader):
    blob = _malformed(case)
    if package == "port":
        err = wire.FrameError
        if reader == "decompress":
            run = lambda: repro_torch.decompress(blob, device="cpu")  # noqa: E731
        else:
            run = lambda: list(wire.iter_container_frames(io.BytesIO(blob)))  # noqa: E731
    else:
        err = ref_wire.FrameError
        if reader == "decompress":
            run = lambda: ref_decompress(blob)  # noqa: E731
        else:
            run = lambda: list(ref_wire.iter_container_frames(io.BytesIO(blob)))  # noqa: E731
    with pytest.raises(err):
        run()


def test_iter_container_frames_accepts_an_empty_container_when_asked():
    blob = _sealed(_chunks_body(4, []))
    assert list(wire.iter_container_frames(io.BytesIO(blob), allow_empty=True)) == []
    assert list(ref_wire.iter_container_frames(io.BytesIO(blob), allow_empty=True)) == []


# ----------------------------------------------------------- chunk boundaries
def _boundary_stream(kind):
    rng = np.random.default_rng(7)
    if kind.startswith("numeric"):
        w = int(kind[7:])
        arr = rng.integers(0, 1 << (8 * w - 1), 3001, dtype=np.int64).astype(f"<u{w}")
        return _pair(arr, SType.NUMERIC, w), w
    if kind.startswith("struct"):
        w = int(kind[6:])
        return _pair(rng.integers(0, 256, 2999 * w, dtype=np.uint8), SType.STRUCT, w), w
    if kind == "serial":
        return _pair(rng.integers(0, 256, 10007, dtype=np.uint8), SType.SERIAL, 1), 1
    lengths = rng.integers(0, 40, 900).astype(np.uint32)
    data = rng.integers(0, 256, int(lengths.sum()), dtype=np.uint8)
    return _pair(data, SType.STRING, 1, lengths), 1


BOUNDARY_KINDS = ("numeric1", "numeric2", "numeric4", "numeric8", "struct3", "struct8",
                  "serial", "string")
BOUNDARY_SIZES = ("1", "width-1", "width", "4096", "4099", "size")


@pytest.mark.parametrize("size", BOUNDARY_SIZES)
@pytest.mark.parametrize("kind", BOUNDARY_KINDS)
def test_split_chunks_cuts_where_the_reference_cuts(kind, size):
    (ref_s, s), w = _boundary_stream(kind)
    cb = {"1": 1, "width-1": w - 1, "width": w, "4096": 4096, "4099": 4099,
          "size": s.nbytes}[size]
    if cb < 1:
        with pytest.raises(ValueError):
            ref_engine._split_chunks(ref_s, cb)
        with pytest.raises(ValueError):
            engine._split_chunks(s, cb)
        return
    want = ref_engine._split_chunks(ref_s, cb)
    got = engine._split_chunks(s, cb)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert (int(g.stype), g.width) == (int(r.stype), r.width)
        assert g.content_bytes() == r.content_bytes()
        if s.stype == SType.STRING:
            assert np.array_equal(g.lengths, r.lengths)
        # a view of the input's storage, never a copy
        assert g.data.untyped_storage().data_ptr() == s.data.untyped_storage().data_ptr()


# --------------------------------------------------------------------- frames
def _frame_case(case):
    """(port plan, reference plan, (reference stream, port stream))."""
    rng = np.random.default_rng(11)
    n = 6000
    ramp = (np.cumsum(rng.integers(900, 1100, n)) + 10**12).astype(np.uint64)
    plan, kind = case.split(":")
    if kind == "u32":
        data = _pair(ramp.astype(np.uint32), SType.NUMERIC, 4)
    elif kind == "u64":
        data = _pair(ramp, SType.NUMERIC, 8)
    elif kind == "f32":
        data = _pair(rng.normal(0, 0.02, n).astype(np.float32), SType.NUMERIC, 4)
    elif kind.startswith("struct"):
        w = int(kind[6:])
        raw = np.resize(ramp.view(np.uint8), n * w // 2 // w * w)
        data = _pair(raw, SType.STRUCT, w)
    else:  # serial: int4 codes one per byte, as chip_smoke's column G
        data = _pair(np.clip(np.rint(rng.normal(7.5, 2.5, 20000)), 0, 15).astype(np.uint8),
                     SType.SERIAL, 1)
    plans = {
        "numeric": (repro_torch.numeric_profile(), ref_profiles.numeric_profile()),
        "generic": (repro_torch.generic_profile(), ref_profiles.generic_profile()),
        "delta+bitpack": (repro_torch.pipeline("delta", "bitpack"),
                          ref_pipeline("delta", "bitpack")),
        "float32": (repro_torch.float32_profile(), ref_profiles.float32_profile()),
    }
    return (*plans[plan], data)


FRAME_CASES = (
    "numeric:u32", "numeric:u64", "generic:u64", "generic:struct2", "generic:struct4",
    "generic:struct8", "generic:struct3", "generic:struct5", "generic:struct16",
    "generic:serial", "delta+bitpack:u32", "float32:f32",
)


@pytest.mark.parametrize("chunk_bytes", (4096, 4096 + 3))
@pytest.mark.parametrize("case", FRAME_CASES)
def test_chunked_frame_is_the_references_and_decodes_across(case, chunk_bytes):
    plan, ref_plan, (ref_s, s) = _frame_case(case)
    frame = repro_torch.compress(plan, s, device="cpu", chunk_bytes=chunk_bytes, use_resolve_cache=False)
    want = ref_compress(ref_plan, ref_s, backend="device", chunk_bytes=chunk_bytes,
                        use_resolve_cache=False)
    assert frame[:4] == b"OZLC"
    assert frame == want
    (out,) = repro_torch.decompress(want, device="cpu")
    assert (out.stype, out.width) == (s.stype, s.width)
    assert out.content_bytes() == ref_s.content_bytes()
    (ref_out,) = ref_decompress(frame)
    assert ref_out.content_bytes() == ref_s.content_bytes()


def test_only_the_first_chunk_of_offsets_fuses():
    """String offsets from 0 through ``delta -> bitpack`` at 4 KiB + 4 chunks:
    the fused codec takes x[-1] = 0 on every chunk, so a later chunk's first
    delta is its whole first offset, too wide for a dynamic fused width (at
    most 16 bits); those chunks lower to delta + bitpack, as in the
    reference."""
    rng = np.random.default_rng(2)
    offsets = np.concatenate([[0], np.cumsum(rng.integers(0, 256, 5999))]).astype(np.uint32)
    ref_s, s = _pair(offsets, SType.NUMERIC, 4)
    frame = repro_torch.compress(repro_torch.pipeline("delta", "bitpack"), s, device="cpu",
                                 chunk_bytes=4096 + 4, use_resolve_cache=False)
    assert frame == ref_compress(ref_pipeline("delta", "bitpack"), ref_s, backend="device",
                                 chunk_bytes=4096 + 4, use_resolve_cache=False)
    _version, chunks = wire.read_container(frame)
    assert len(chunks) == -(-s.n_elts // ((4096 + 4) // 4))
    ids = [[n.codec_id for n in wire.read_frame(c)[2]] for c in chunks]
    assert ids == [[26]] + [[3, 6]] * (len(chunks) - 1)  # fused_delta_bitpack; delta, bitpack


@pytest.mark.parametrize("offset", range(4))
def test_trained_plan_chunked_from_every_byte_offset(offset):
    """The golden ``trained_era5_flux`` plan (``interpret_numeric(4) ->
    transpose -> lzma_backend``) chunked, on SERIAL input that starts 0-3
    bytes into its buffer: where the chunk views start off the int32
    alignment, ``interpret_numeric`` clones them before viewing."""
    from _golden import GOLDEN_DIR

    from repro.core.serialize import deserialize_plan, plan_to_dict

    ref_plan, meta = deserialize_plan((GOLDEN_DIR / "trained_era5_flux.ozp").read_bytes())
    plan, _ = repro_torch.plan_from_dict(plan_to_dict(ref_plan, meta["name"]))
    raw = np.frombuffer((GOLDEN_DIR / "trained_era5_flux.in").read_bytes(), np.uint8)
    buf = np.concatenate([np.zeros(offset, np.uint8), raw])
    s = Stream(torch.from_numpy(buf)[offset:], SType.SERIAL, 1)
    assert s.data.storage_offset() == offset
    frame = repro_torch.compress(plan, s, device="cpu", chunk_bytes=1024, use_resolve_cache=False)
    assert frame == ref_compress(ref_plan, RefStream(raw, RefSType.SERIAL, 1),
                                 backend="device", chunk_bytes=1024, use_resolve_cache=False)
    (out,) = repro_torch.decompress(frame, device="cpu")
    assert out.content_bytes() == raw.tobytes()


# --------------------------------------------------------------------- errors
def test_chunked_path_refuses_what_the_reference_refuses():
    col = np.arange(5000, dtype=np.uint32)
    ref_s, s = _pair(col, SType.NUMERIC, 4)
    plan, ref_plan = repro_torch.numeric_profile(), ref_profiles.numeric_profile()
    two = repro_torch.GraphBuilder(2)
    two.add("store", two.input(0))
    two.add("store", two.input(1))
    with pytest.raises(ValueError, match="exactly one input"):
        repro_torch.compress(two.build("two"), [s, s], device="cpu", chunk_bytes=4096, use_resolve_cache=False)
    with pytest.raises(ValueError):
        repro_torch.compress(plan, s, CompressionCtx(format_version=3), device="cpu",
                             chunk_bytes=4096, use_resolve_cache=False)
    with pytest.raises(ValueError):
        ref_compress(ref_plan, ref_s, ctx=RefCtx(format_version=3), chunk_bytes=4096)
    with pytest.raises(ValueError):
        repro_torch.compress(plan, s, device="cpu", chunk_bytes=-1)
    # chunk_bytes=0 and a split into one chunk write a plain frame, as in the reference
    for cb in (0, s.nbytes, s.nbytes * 2):
        frame = repro_torch.compress(plan, s, device="cpu", chunk_bytes=cb, use_resolve_cache=False)
        assert frame[:4] == b"OZLJ"
        assert frame == ref_compress(ref_plan, ref_s, backend="device", chunk_bytes=cb,
                                     use_resolve_cache=False)


def test_container_of_multi_input_chunks_fails_closed():
    two = repro_torch.GraphBuilder(2)
    two.add("store", two.input(0))
    two.add("store", two.input(1))
    s = repro_torch.serial(b"abc")
    chunk = repro_torch.compress(two.build("two"), [s, s], device="cpu", use_resolve_cache=False)
    blob = wire.write_container(4, [chunk, chunk])
    with pytest.raises(wire.FrameError, match="single-input"):
        repro_torch.decompress(blob, device="cpu")
    with pytest.raises(ref_wire.FrameError, match="single-input"):
        ref_decompress(blob)


def test_chunks_of_different_types_fail_closed():
    a = repro_torch.compress(repro_torch.pipeline("store"), repro_torch.serial(b"abcd"),
                             device="cpu", use_resolve_cache=False)
    b = repro_torch.compress(repro_torch.pipeline("store"),
                             repro_torch.numeric(np.arange(3, dtype=np.uint8)), device="cpu", use_resolve_cache=False)
    blob = wire.write_container(4, [a, b])
    with pytest.raises(wire.FrameError, match="disagree"):
        repro_torch.decompress(blob, device="cpu")
    with pytest.raises(ref_wire.FrameError, match="disagree"):
        ref_decompress(blob)


# ---------------------------------------------------- per-chunk fresh resolve
def _refusing_column():
    """u64 whose first 4 KiB chunk spans a small range (range_pack wins there)
    and whose last chunk spans 64 bits, which range_pack refuses."""
    rng = np.random.default_rng(5)
    small = (10**12 + rng.integers(0, 1000, 1024)).astype(np.uint64)
    wide = rng.integers(0, 1 << 63, 512, dtype=np.uint64) * 2 + 1
    return np.concatenate([small, wide])


def test_a_chunk_that_refuses_the_first_resolution_is_resolved_afresh(monkeypatch):
    col = _refusing_column()
    ref_s, s = _pair(col, SType.NUMERIC, 8)
    first = repro_torch.core.resolve(repro_torch.numeric_profile(), [Stream(s.data[:512],
                                     SType.NUMERIC, 8)], CompressionCtx())
    assert "range_pack" in first.codec_names()

    ref_calls = []
    real = ref_engine.resolve
    monkeypatch.setattr(ref_engine, "resolve",
                        lambda *a, **k: ref_calls.append(1) or real(*a, **k))
    want = ref_compress(ref_profiles.numeric_profile(), ref_s, backend="device",
                        chunk_bytes=4096, use_resolve_cache=False)
    before = engine.fresh_resolves
    frame = repro_torch.compress(repro_torch.numeric_profile(), s, device="cpu",
                                 chunk_bytes=4096, use_resolve_cache=False)
    assert engine.fresh_resolves - before == len(ref_calls) - 1 == 1
    assert frame == want
    (out,) = repro_torch.decompress(frame, device="cpu")
    assert out.content_bytes() == col.tobytes()


def test_the_retry_does_not_hide_a_kernel_error(monkeypatch):
    """A wrapper's precondition error (``ops.KernelError``) on a later chunk,
    or in a selector trial, propagates instead of being re-resolved."""
    s = repro_torch.numeric(np.arange(4096, dtype=np.uint32))
    real, calls = ops.delta_encode, []

    def flaky(x):
        calls.append(1)
        if len(calls) == 2:
            raise ops.KernelError("delta_encode: tensor must be contiguous")
        return real(x)

    monkeypatch.setattr(ops, "delta_encode", flaky)
    with pytest.raises(ops.KernelError):
        repro_torch.compress(repro_torch.pipeline("delta", "range_pack"), s, device="cpu",
                             chunk_bytes=4096, use_resolve_cache=False)

    def broken(x):
        raise ops.KernelError("delta_encode: tensor must be contiguous")

    monkeypatch.setattr(ops, "delta_encode", broken)
    with pytest.raises(ops.KernelError):
        repro_torch.compress(repro_torch.numeric_profile(), s, device="cpu", use_resolve_cache=False)


# --------------------------------------------- interpret_numeric, generic_auto
@pytest.mark.parametrize("offset", range(8))
def test_interpret_numeric_on_a_view_at_every_offset(offset):
    rng = np.random.default_rng(offset)
    raw = rng.integers(0, 256, 8 * 300 + 16, dtype=np.uint8)
    view = raw[offset: offset + 8 * 300]
    ref_plan = ref_pipeline(("interpret_numeric", {"width": 8}), "delta", "transpose", "huffman")
    plan = repro_torch.pipeline(("interpret_numeric", {"width": 8}), "delta", "transpose",
                                "huffman")
    s = Stream(torch.from_numpy(raw)[offset: offset + 8 * 300], SType.SERIAL, 1)
    frame = repro_torch.compress(plan, s, device="cpu", use_resolve_cache=False)
    assert frame == ref_compress(ref_plan, RefStream(view, RefSType.SERIAL, 1),
                                 backend="device", use_resolve_cache=False)
    (out,) = repro_torch.decompress(frame, device="cpu")
    assert out.content_bytes() == view.tobytes()


@pytest.mark.parametrize("case", ("string", "width3", "ragged"))
def test_interpret_numeric_refuses_where_the_reference_refuses(case):
    from repro.core.codec import get_codec as ref_get_codec
    from repro_torch.core.codec import get_codec

    if case == "string":
        lengths = np.array([2, 2], np.uint32)
        ref_s, s = _pair(np.arange(4, dtype=np.uint8), SType.STRING, 1, lengths)
        params = {}
    else:
        ref_s, s = _pair(np.arange(10, dtype=np.uint8), SType.SERIAL, 1)
        params = {"width": 3} if case == "width3" else {"width": 4}
    with pytest.raises(ValueError):
        ref_get_codec("interpret_numeric").run_encode([ref_s], params)
    with pytest.raises(ValueError):
        get_codec("interpret_numeric").run_encode([s], params)


@pytest.mark.parametrize("level", (1, 5, 6))
def test_text_profile_writes_the_reference_frame(level):
    data = b"the quick brown fox jumps over the lazy dog\n" * 200
    frame = repro_torch.compress(repro_torch.text_profile(level), repro_torch.serial(data),
                                 device="cpu", chunk_bytes=2048, use_resolve_cache=False)
    assert frame == ref_compress(ref_profiles.text_profile(level),
                                 RefStream(np.frombuffer(data, np.uint8), RefSType.SERIAL, 1),
                                 backend="device", chunk_bytes=2048, use_resolve_cache=False)
