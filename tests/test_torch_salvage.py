"""Salvage and verify: the port's recovery decoder against the reference's.

Mirrors every case of ``tests/test_salvage.py`` on the port: on the same
damaged bytes the port's ``SalvageReport.to_dict()`` equals the reference's,
and so do the recovered chunks' bytes; ``verify_container`` and
``iter_container_frames(salvage=True, report=)`` too, over seeded damage of
every kind (payload flips, destroyed length varints, header and trailer
damage, truncations).  An unknown-count container that ``compress_file``
wrote from a pipe salvages as the reference's does.  A ``KernelError`` (or
any error that is not a ``ValueError``) raised while a CRC-valid chunk
decodes propagates out of ``decompress_salvage`` instead of being reported as
damage.  All on the CPU, tolerance 0.
"""
import io
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.cli import main as ref_cli  # noqa: E402
from repro.codecs.profiles import resolve_profile_spec as ref_spec  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import stream_io as ref_stream_io  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro.core.engine import DecompressorSession as RefSession  # noqa: E402
from repro.core.message import numeric as ref_numeric  # noqa: E402
from repro.core.message import serial as ref_serial  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.core import stream_io, wire  # noqa: E402
from repro_torch.core.engine import DecompressorSession  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CPU = "cpu"
# 64 chunks as in tests/test_salvage.py, of 256 bytes: the generic profile
# then codes each chunk with zlib, where 2048-byte chunks choose tANS, whose
# plain walk on the CPU would take minutes for the container
CHUNK = 256
N_CHUNKS = 64


def _payload() -> bytes:
    rng = np.random.default_rng(42)
    base = rng.integers(0, 8, size=N_CHUNKS * CHUNK, dtype=np.uint8)
    return (base + np.arange(N_CHUNKS * CHUNK, dtype=np.uint64) // CHUNK % 8).astype(
        np.uint8
    ).tobytes()


def _clear():
    ref_engine.resolve_cache_clear()
    repro_torch.resolve_cache_clear()


def _chunk_spans(blob: bytes):
    """[(frame_start, frame_end)] for each chunk, and each length varint's pos."""
    n, pos = wire.read_varint(blob, 5)
    spans, lens = [], []
    for _ in range(n):
        lens.append(pos)
        ln, pos = wire.read_varint(blob, pos)
        spans.append((pos, pos + ln))
        pos += ln
    return spans, lens


@pytest.fixture(scope="module")
def intact():
    payload = _payload()
    _clear()
    want = ref_compress(ref_spec("generic"), ref_serial(payload), chunk_bytes=CHUNK,
                        backend="device")
    _clear()
    blob = repro_torch.compress(repro_torch.resolve_profile_spec("generic"),
                                repro_torch.serial(payload), device=CPU, chunk_bytes=CHUNK)
    assert blob == want
    return payload, blob


def _flip(blob: bytes, chunks, mask: int = 0xFF) -> bytes:
    spans, _ = _chunk_spans(blob)
    bad = bytearray(blob)
    for i in chunks:
        lo, hi = spans[i]
        bad[(lo + hi) // 2] ^= mask
    return bytes(bad)


def _both_salvage(data: bytes):
    """Salvage in both packages, reports and bytes equal -> the port's
    (streams, report)."""
    with DecompressorSession(device=CPU) as sess:
        streams, report = sess.decompress_salvage(data)
    with RefSession() as rsess:
        ref_streams, ref_report = rsess.decompress_salvage(data)
    assert report.to_dict() == ref_report.to_dict()
    assert report.summary() == ref_report.summary()
    assert [s.content_bytes() for s in streams] == [s.content_bytes() for s in ref_streams]
    return streams, report


# ------------------------------------------------------ test_salvage.py's cases
def test_salvage_recovers_61_of_64_chunks_byte_exact(intact):
    payload, blob = intact
    bad = _flip(blob, (7, 8, 40))
    with pytest.raises(ValueError):
        repro_torch.decompress(bad, device=CPU)
    streams, report = _both_salvage(bad)
    assert report.n_chunks == N_CHUNKS
    assert len(streams) == len(report.recovered) == N_CHUNKS - 3
    assert report.recovered_unplaced == 0
    assert report.damaged == [(7, 8), (40, 40)]
    assert not report.trailer_ok and not report.intact
    for s, idx in zip(streams, report.recovered):
        assert s.content_bytes() == payload[idx * CHUNK: (idx + 1) * CHUNK]
        assert s.device == torch.device(CPU)


def test_destroyed_length_varint_resyncs_all_chunks(intact):
    payload, blob = intact
    _, lens = _chunk_spans(blob)
    bad = bytearray(blob)
    bad[lens[20]] ^= 0x80
    with pytest.raises(ValueError):
        repro_torch.decompress(bytes(bad), device=CPU)
    streams, report = _both_salvage(bytes(bad))
    assert len(streams) == N_CHUNKS and report.recovered == list(range(N_CHUNKS))
    for i, s in enumerate(streams):
        assert s.content_bytes() == payload[i * CHUNK: (i + 1) * CHUNK]


def test_truncated_tail_recovers_prefix(intact):
    payload, blob = intact
    spans, _ = _chunk_spans(blob)
    streams, report = _both_salvage(blob[: (spans[-1][0] + spans[-1][1]) // 2])
    assert report.recovered == list(range(N_CHUNKS - 1))
    assert any(lo == N_CHUNKS - 1 for lo, _hi in report.damaged)
    for i, s in enumerate(streams):
        assert s.content_bytes() == payload[i * CHUNK: (i + 1) * CHUNK]


def test_intact_container_salvages_clean(intact):
    payload, blob = intact
    streams, report = _both_salvage(blob)
    assert report.intact and report.trailer_ok
    assert b"".join(s.content_bytes() for s in streams) == payload


def test_salvage_bare_frame_paths():
    data = b"hello " * 400
    _clear()
    frame = repro_torch.compress(repro_torch.resolve_profile_spec("generic"),
                                 repro_torch.serial(data), device=CPU)
    _clear()
    assert frame == ref_compress(ref_spec("generic"), ref_serial(data), backend="device")
    streams, report = _both_salvage(frame)
    assert report.intact and len(streams) == 1
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 0xFF
    streams, report = _both_salvage(bytes(bad))
    assert streams == [] and report.damaged == [(0, 0)] and not report.intact


def test_verify_container_reports_damage_without_decoding(intact):
    _payload_, blob = intact
    assert wire.verify_container(io.BytesIO(blob)).intact
    bad = _flip(blob, (3,), 0x01)
    report = wire.verify_container(io.BytesIO(bad))
    assert report.to_dict() == ref_wire.verify_container(io.BytesIO(bad)).to_dict()
    assert not report.intact and (3, 3) in report.damaged and report.trailer_ok is False


def test_salvage_container_matches_session_report(intact):
    _payload_, blob = intact
    spans, _ = _chunk_spans(blob)
    bad = bytearray(blob)
    bad[sum(spans[11]) // 2] ^= 0x10
    frames, report = wire.salvage_container(bytes(bad))
    ref_frames, ref_report = ref_wire.salvage_container(bytes(bad))
    assert report.to_dict() == ref_report.to_dict() and frames == ref_frames
    assert report.damaged == [(11, 11)] and len(frames) == N_CHUNKS - 1


def test_cli_salvage_and_verify(tmp_path, intact, capsys):
    payload, blob = intact
    bad = _flip(blob, (7, 8, 40))
    good_f, bad_f = tmp_path / "good.ozl", tmp_path / "bad.ozl"
    good_f.write_bytes(blob)
    bad_f.write_bytes(bad)
    assert cli.main(["inspect", str(good_f), "--verify"]) == 0
    assert cli.main(["inspect", str(bad_f), "--verify"]) == 1
    out = capsys.readouterr().out
    assert "61/64 recovered" in out and "7..8, 40" in out
    dst = tmp_path / "out.bin"
    assert cli.main(["decompress", str(bad_f), "-o", str(dst), "--device", CPU]) == 2
    assert not dst.exists()
    assert cli.main(["decompress", str(bad_f), "-o", str(dst), "--salvage",
                     "--device", CPU]) == 1
    assert dst.read_bytes() == b"".join(
        payload[i * CHUNK: (i + 1) * CHUNK] for i in range(N_CHUNKS) if i not in (7, 8, 40)
    )
    dst2 = tmp_path / "out2.bin"
    assert cli.main(["decompress", str(good_f), "-o", str(dst2), "--salvage",
                     "--device", CPU]) == 0
    assert dst2.read_bytes() == payload
    # the reference's CLI writes the same file
    ref_dst = tmp_path / "ref.bin"
    assert ref_cli(["decompress", str(bad_f), "-o", str(ref_dst), "--salvage"]) == 1
    assert ref_dst.read_bytes() == dst.read_bytes()


# ------------------------------------------------------ seeded damage, both ways
def _damage(blob: bytes, seed: int) -> bytes:
    """One of eight kinds of damage, placed by ``seed``."""
    rng = np.random.default_rng(seed)
    spans, lens = _chunk_spans(blob)
    bad = bytearray(blob)
    kind = seed % 8
    if kind == 0:  # payload flips in a few chunks
        for i in rng.choice(len(spans), int(rng.integers(1, 6)), replace=False):
            lo, hi = spans[i]
            bad[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
    elif kind == 1:  # length varints destroyed
        for i in rng.choice(len(lens), int(rng.integers(1, 4)), replace=False):
            bad[lens[i]] ^= int(rng.choice([0x80, 0x40, 0xFF]))
    elif kind == 2:  # the header's count varint
        bad[5] ^= int(rng.choice([0x80, 0x7F, 0x01]))
    elif kind == 3:  # magic, version or trailer bytes
        pos = int(rng.choice([0, 2, 4, len(bad) - 1, len(bad) - 3]))
        bad[pos] ^= 0x55
    elif kind == 4:  # a truncation anywhere
        return bytes(bad[: int(rng.integers(0, len(bad)))])
    elif kind == 5:  # a frame magic inside a chunk destroyed, and a length too
        lo, _hi = spans[int(rng.integers(0, len(spans)))]
        bad[lo] ^= 0x20
        bad[lens[int(rng.integers(0, len(lens)))]] ^= 0x80
    elif kind == 6:  # bytes cut out of the middle: two gaps
        a = int(rng.integers(20, len(bad) // 2))
        b = int(rng.integers(len(bad) // 2, len(bad) - 20))
        del bad[b: b + int(rng.integers(1, 50))]
        del bad[a: a + int(rng.integers(1, 50))]
    else:  # random bytes anywhere
        for _ in range(int(rng.integers(1, 20))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
    return bytes(bad)


@pytest.mark.parametrize("seed", range(40))
def test_seeded_damage_scans_as_the_reference(intact, seed):
    _payload_, blob = intact
    bad = _damage(blob, seed)
    frames, report = wire.salvage_container(bad)
    ref_frames, ref_report = ref_wire.salvage_container(bad)
    assert report.to_dict() == ref_report.to_dict() and frames == ref_frames
    assert (wire.verify_container(io.BytesIO(bad)).to_dict()
            == ref_wire.verify_container(io.BytesIO(bad)).to_dict())
    rep, ref_rep = wire.SalvageReport(), ref_wire.SalvageReport()
    got = list(wire.iter_container_frames(io.BytesIO(bad), salvage=True, report=rep))
    want = list(ref_wire.iter_container_frames(io.BytesIO(bad), salvage=True, report=ref_rep))
    assert got == want and rep.to_dict() == ref_rep.to_dict()


@pytest.mark.parametrize("seed", range(0, 40, 5))
def test_seeded_damage_decodes_as_the_reference(intact, seed):
    _payload_, blob = intact
    _both_salvage(_damage(blob, seed))


def test_iter_container_frames_salvage_without_a_report(intact):
    _payload_, blob = intact
    bad = _flip(blob, (2,))
    assert list(wire.iter_container_frames(io.BytesIO(bad), salvage=True)) == list(
        ref_wire.iter_container_frames(io.BytesIO(bad), salvage=True))


def test_verify_bare_frames_and_short_records():
    frame = repro_torch.compress(repro_torch.pipeline("zlib_backend"),
                                 repro_torch.serial(b"abc" * 100), device=CPU)
    for data in (frame, frame[:-1] + bytes([frame[-1] ^ 1]), b"", b"OZL", b"junk!",
                 b"OZLC\x04", b"OZLC\x02\x01", b"OZLC\x04\xff\xff\xff\xff\xff\xff"):
        got = wire.verify_container(io.BytesIO(data)).to_dict()
        assert got == ref_wire.verify_container(io.BytesIO(data)).to_dict()
        frames, report = wire.salvage_container(data)
        ref_frames, ref_report = ref_wire.salvage_container(data)
        assert report.to_dict() == ref_report.to_dict() and frames == ref_frames


# -------------------------------------------------- unknown-count containers
def _through_pipe(fn, data: bytes):
    r, w = os.pipe()

    def feed():
        with os.fdopen(w, "wb") as f:
            f.write(data)

    t = threading.Thread(target=feed)
    t.start()
    try:
        with os.fdopen(r, "rb") as f:
            return fn(f)
    finally:
        t.join()


def test_unknown_count_container_from_a_pipe_salvages_as_the_reference(tmp_path):
    payload = _payload()[: 20 * CHUNK + 5]
    dst = tmp_path / "pipe.ozl"
    ref_dst = tmp_path / "ref_pipe.ozl"
    _clear()
    stats = _through_pipe(lambda f: stream_io.compress_file(
        f, dst, repro_torch.resolve_profile_spec("generic"), device=CPU, chunk_bytes=CHUNK),
        payload)
    _clear()
    _through_pipe(lambda f: ref_stream_io.compress_file(
        f, ref_dst, ref_spec("generic"), backend="device", chunk_bytes=CHUNK), payload)
    blob = dst.read_bytes()
    assert blob == ref_dst.read_bytes() and stats["chunks"] == 21
    assert blob[5] & 0x80  # the padded, backpatched count
    spans = []
    pos = 10  # header + the 5-byte padded count
    for _ in range(21):
        ln, pos = wire.read_varint(blob, pos)
        spans.append((pos, pos + ln))
        pos += ln
    bad = bytearray(blob)
    for i in (0, 9, 20):
        lo, hi = spans[i]
        bad[(lo + hi) // 2] ^= 0xFF
    streams, report = _both_salvage(bytes(bad))
    assert report.n_chunks == 21 and report.damaged == [(0, 0), (9, 9), (20, 20)]
    for s, idx in zip(streams, report.recovered):
        assert s.content_bytes() == payload[idx * CHUNK: (idx + 1) * CHUNK]
    bad[7] ^= 0x01  # the padded count itself
    _both_salvage(bytes(bad))


def test_decompress_file_salvage_stats_are_the_references(tmp_path, intact):
    payload, blob = intact
    src = tmp_path / "bad.ozl"
    src.write_bytes(_flip(blob, (0, 63)))
    out, ref_out = tmp_path / "out.bin", tmp_path / "ref.bin"
    stats = stream_io.decompress_file(src, out, device=CPU, salvage=True)
    ref_stats = ref_stream_io.decompress_file(src, ref_out, salvage=True)
    assert stats == ref_stats
    assert out.read_bytes() == ref_out.read_bytes() == payload[CHUNK: 63 * CHUNK]


# ------------------------------------------------ a kernel error is not damage
def _delta_container():
    col = np.arange(10 * 1024, dtype=np.uint32) * 3
    plan = ("delta", "transpose", "zlib_backend")
    _clear()
    blob = repro_torch.compress(repro_torch.pipeline(*plan), repro_torch.numeric(col),
                                device=CPU, chunk_bytes=4 << 10)
    _clear()
    assert blob == ref_compress(ref_pipeline(*plan), ref_numeric(col), backend="device",
                                chunk_bytes=4 << 10)
    return col, blob


@pytest.mark.parametrize("error", [ops.KernelError("delta_decode: injected"),
                                   RuntimeError("CUDA error: an illegal memory access")])
def test_a_kernel_error_in_a_crc_valid_chunk_propagates(monkeypatch, error):
    col, blob = _delta_container()
    bad = _flip(blob, (0,))  # one chunk damaged, the rest CRC-valid
    real, calls = ops.delta_decode, []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise error
        return real(*args, **kw)

    monkeypatch.setattr(ops, "delta_decode", flaky)
    with DecompressorSession(device=CPU, n_workers=1) as sess:
        with pytest.raises(type(error)):
            sess.decompress_salvage(bad)
    assert len(calls) >= 3  # the window may have started later chunks
    # the bare-frame path lets it through too
    frame = repro_torch.compress(repro_torch.pipeline("delta", "transpose", "zlib_backend"),
                                 repro_torch.numeric(col[:1000]), device=CPU)

    def broken(*args, **kw):
        raise error

    monkeypatch.setattr(ops, "delta_decode", broken)
    with DecompressorSession(device=CPU) as sess:
        with pytest.raises(type(error)):
            sess.decompress_salvage(frame)


def test_a_codec_refusal_in_a_crc_valid_chunk_is_damage(monkeypatch):
    """A ``ValueError`` from a CRC-valid chunk's decode moves it from
    recovered to damaged, as the reference reports it."""
    col, blob = _delta_container()
    real, calls = ops.delta_decode, []

    def refusing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("delta: injected refusal")
        return real(*args, **kw)

    monkeypatch.setattr(ops, "delta_decode", refusing)
    with DecompressorSession(device=CPU, n_workers=1) as sess:
        streams, report = sess.decompress_salvage(blob)
    assert report.damaged == [(1, 1)] and 1 not in report.recovered
    assert report.notes == ["1 recovered chunk(s) failed to decode"]
    assert len(streams) == len(report.recovered) == 9
