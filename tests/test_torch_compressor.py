"""The ``Compressor`` facade: the port's against the reference's
``Compressor(backend="device")``.

Frames and containers are equal (with ``chunk_bytes=0`` forcing one frame
over a chunking default), ``serialize()`` bytes are equal, each package reads
the other's blob with its ``format_version`` and ``level``, and
``roundtrip_check``, ``session()`` and ``resolve()`` behave as the
reference's.  ``set_checkpoint_plan`` takes ``Compressor.deserialize(blob)
.plan`` of a trained plan file and writes the reference's leaf frame.  Both
packages' resolve caches are emptied before each side.  All on the CPU,
tolerance 0 (bytes equal).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.codecs.profiles import resolve_profile_spec as ref_spec  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.engine import Compressor as RefCompressor  # noqa: E402
from repro.core.message import numeric as ref_numeric  # noqa: E402
from repro.core.message import serial as ref_serial  # noqa: E402
from repro.core.message import strings as ref_strings  # noqa: E402
from repro.distributed import checkpoint as rck  # noqa: E402
from repro_torch import Compressor  # noqa: E402
from repro_torch.distributed import checkpoint as tck  # noqa: E402

CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]
TRAINED = REPO / "results" / "trained"


def _clear():
    ref_engine.resolve_cache_clear()
    repro_torch.resolve_cache_clear()


def _text(n: int = 6000) -> bytes:
    rng = np.random.default_rng(7)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"\xc3\xa9t\xc3\xa9", b"42"]
    return b" ".join(words[i] for i in rng.integers(0, len(words), n))


def _ints(n: int = 5000) -> np.ndarray:
    rng = np.random.default_rng(3)
    return np.cumsum(rng.integers(0, 50, n)).astype(np.int64)


CASES = {
    "generic bytes": ("generic", lambda: _text(), "serial"),
    "numeric ints": ("numeric", lambda: _ints(), "numeric"),
    "text bytes": ("text", lambda: _text(2000), "serial"),
    "float32 weights": ("float32", lambda: np.random.default_rng(1).normal(0, 0.02, 1500)
                        .astype(np.float32), "numeric"),
}


def _pair(kind, data):
    if kind == "serial":
        return repro_torch.serial(data), ref_serial(data)
    return repro_torch.numeric(data), ref_numeric(data)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("chunk_bytes", [None, 2048])
def test_compress_equals_the_reference(case, chunk_bytes):
    spec, make, kind = CASES[case]
    port_in, ref_in = _pair(kind, make())
    comp = Compressor(repro_torch.resolve_profile_spec(spec), device=CPU, chunk_bytes=chunk_bytes)
    ref = RefCompressor(ref_spec(spec), backend="device", chunk_bytes=chunk_bytes)
    _clear()
    want = ref.compress(ref_in)
    _clear()
    got = comp.compress(port_in)
    assert got == want
    if chunk_bytes:
        assert got[:4] == b"OZLC"
        # chunk_bytes=0 forces one frame over the chunking default
        _clear()
        want0 = ref.compress(ref_in, chunk_bytes=0)
        _clear()
        got0 = comp.compress(port_in, chunk_bytes=0)
        assert got0 == want0 and got0[:4] == b"OZLJ"
    (out,) = Compressor.decompress(got, CPU)
    assert out.content_bytes() == port_in.content_bytes()


@pytest.mark.parametrize("fv,level", [(4, 5), (3, 1), (4, 9), (2, 7)])
def test_serialize_is_the_references_and_each_reads_the_other(fv, level):
    plan, ref_plan = repro_torch.numeric_profile(), ref_spec("numeric")
    comp = Compressor(plan, format_version=fv, level=level, name="cols", device=CPU)
    ref = RefCompressor(ref_plan, format_version=fv, level=level, name="cols")
    blob = comp.serialize()
    assert blob == ref.serialize()
    back = Compressor.deserialize(ref.serialize(), device=CPU)
    assert (back.format_version, back.level, back.name) == (fv, level, "cols")
    assert back.plan.nodes == comp.plan.nodes and back.device == CPU
    ref_back = RefCompressor.deserialize(blob)
    assert (ref_back.format_version, ref_back.level, ref_back.name) == (fv, level, "cols")
    # the knobs ride into the frames
    col = _ints(800)
    _clear()
    want = ref_back.compress(ref_numeric(col), backend="device")
    _clear()
    assert back.compress(repro_torch.numeric(col)) == want


def test_deserialize_defaults_to_the_card_and_a_bad_version_refuses():
    blob = Compressor(repro_torch.generic_profile(), device=CPU).serialize()
    assert Compressor.deserialize(blob).device == "cuda"
    with pytest.raises(ValueError):
        Compressor(repro_torch.generic_profile(), format_version=9, device=CPU)


def test_roundtrip_check_on_bytes_streams_and_strings():
    comp = Compressor(repro_torch.generic_profile(), device=CPU)
    assert comp.roundtrip_check(_text(500))
    assert comp.roundtrip_check(repro_torch.numeric(_ints(300)))
    assert comp.roundtrip_check([repro_torch.strings([b"ab", b"", b"c\xff", b"ab"] * 40)])
    ref = RefCompressor(ref_spec("generic"))
    assert ref.roundtrip_check([ref_strings([b"ab", b"", b"c\xff", b"ab"] * 40)])


def test_roundtrip_check_sees_a_wrong_decode(monkeypatch):
    from repro_torch.core import engine

    comp = Compressor(repro_torch.pipeline("zlib_backend"), device=CPU)
    real = engine.decompress
    monkeypatch.setattr(engine, "decompress",
                        lambda frame, device: [repro_torch.serial(b"x")] + real(frame, device))
    assert not comp.roundtrip_check(b"abc" * 50)


def test_session_and_resolve_use_the_compressors_settings():
    data = _text(800)
    comp = Compressor(repro_torch.generic_profile(), level=3, device=CPU, chunk_bytes=1024)
    ref = RefCompressor(ref_spec("generic"), level=3, backend="device", chunk_bytes=1024)
    _clear()
    want = ref.session().compress(ref_serial(data))
    _clear()
    with comp.session() as session:
        assert session.device == torch.device(CPU) and session.chunk_bytes == 1024
        assert session.ctx.level == 3
        assert session.compress(repro_torch.serial(data)) == want
    with comp.session(chunk_bytes=0, n_workers=1) as session:
        assert session.compress(repro_torch.serial(data))[:4] == b"OZLJ"
    _clear()
    ref_names = ref.resolve([ref_serial(data)]).codec_names()
    _clear()
    assert comp.resolve([repro_torch.serial(data)]).codec_names() == ref_names


# -------------------------------------------------------- trained plan files
def _leaf(n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(11)
    return np.cumsum(rng.normal(0, 1, n)).astype(np.float32)


@pytest.mark.parametrize("name", ["era5_wind_0.ozp", "era5_snow_0.ozp", "era5_flux_3.ozp"])
def test_set_checkpoint_plan_takes_a_deserialized_trained_plan(name):
    blob = (TRAINED / name).read_bytes()
    comp = Compressor.deserialize(blob, device=CPU)
    leaf = _leaf()
    try:
        rck.set_checkpoint_plan("float32", RefCompressor.deserialize(blob).plan)
        tck.set_checkpoint_plan("float32", comp.plan)
        _clear()
        want = rck.compress_leaf(leaf)
        _clear()
        got = tck.compress_leaf(torch.from_numpy(leaf.copy()), device=CPU)
        assert got == want
        back = tck.decompress_leaf(got, leaf.shape, "float32", device=CPU)
        assert back.numpy().tobytes() == leaf.tobytes()
    finally:
        rck.set_checkpoint_plan("float32", None)
        tck.set_checkpoint_plan("float32", None)


def test_a_trained_csv_plan_file_compresses_as_the_reference():
    import chip_smoke

    blob = (TRAINED / "psam_h_3.ozp").read_bytes()
    csv = chip_smoke.make_psam_csv(400, 4)
    comp = Compressor.deserialize(blob, device=CPU)
    _clear()
    want = RefCompressor.deserialize(blob).compress(ref_serial(csv), backend="device",
                                                    chunk_bytes=0)
    _clear()
    got = comp.compress(repro_torch.serial(csv), chunk_bytes=0)
    assert got == want
    assert comp.roundtrip_check(csv)
