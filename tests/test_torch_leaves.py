"""The ``lzma_backend`` and ``bz2_backend`` host leaves, and the selectors and
float profiles at levels 7-9 that reach them, held against the reference on
the CPU.

Both leaves run stdlib ``lzma`` / ``bz2`` on the host in both packages (they
had no TPU kernel), so the port's header and payload must equal the
reference encoder's byte for byte, each package must decode the other's
output, and a STRING stream is refused with ``ValueError``.  From level 7
``entropy_auto`` (and with it ``bytes_auto``) adds an ``lzma_backend``
candidate, so the ``float32`` / ``bfloat16`` / ``float64`` profiles at levels
7, 8 and 9 must write the reference's frame, with its host backend and with
``backend="device"``.  Inputs are made with numpy from fixed seeds;
tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.codecs import profiles as ref_profiles  # noqa: E402
from repro.core import CompressionCtx as RefCtx  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core.graph import GraphBuilder as RefGraphBuilder  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro_torch.core.codec import get_codec, get_codec_by_id  # noqa: E402
from repro_torch.core.message import Stream, SType, from_numpy  # noqa: E402
from repro_torch.core.wire import read_frame  # noqa: E402

LEAVES = {"lzma_backend": "preset", "bz2_backend": "level"}
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _stream(kind, seed=0):
    """(numpy data, stype, width): numeric walks of every width, float32 and
    float64 weights as their bit patterns, and skewed bytes."""
    rng = np.random.default_rng(seed)
    if kind in ("u8", "u16", "u32", "u64"):
        width = int(kind[1:]) // 8
        x = np.cumsum(rng.integers(0, 9, 20_000)).astype(UNSIGNED[width])
        return x, SType.NUMERIC, width
    if kind == "f32":
        return rng.normal(0.0, 0.02, 8192).astype(np.float32).view(np.uint32), SType.NUMERIC, 4
    if kind == "f64":
        return rng.normal(0.0, 0.02, 4096).view(np.uint64), SType.NUMERIC, 8
    if kind == "struct3":
        return rng.integers(0, 4, 3 * 700).astype(np.uint8), SType.STRUCT, 3
    return (rng.zipf(1.3, 30_000) % 251).astype(np.uint8), SType.SERIAL, 1


KINDS = ["u8", "u16", "u32", "u64", "f32", "f64", "struct3", "bytes"]


@pytest.mark.parametrize("setting", [None, 1], ids=["default", "one"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("codec", sorted(LEAVES))
def test_leaf_matches_reference_and_decodes_both_ways(codec, kind, setting):
    x, stype, width = _stream(kind)
    params = {} if setting is None else {LEAVES[codec]: setting}
    (out,), header = get_codec(codec).run_encode([from_numpy(x, stype, width)], params)
    (ref_out,), ref_header = ref_get_codec(codec).run_encode(
        [RefStream(x, RefSType(int(stype)), width)], dict(params)
    )
    assert header == ref_header
    assert (int(out.stype), out.width) == (int(ref_out.stype), ref_out.width)
    assert (out.stype, out.width) == (SType.SERIAL, 1)
    assert out.content_bytes() == ref_out.data.tobytes()
    (back,) = get_codec(codec).run_decode([out], header)
    assert (back.stype, back.width) == (stype, width)
    assert back.content_bytes() == x.tobytes()
    theirs = RefStream(np.frombuffer(out.content_bytes(), np.uint8), RefSType.SERIAL, 1)
    (ref_back,) = ref_get_codec(codec).run_decode([theirs], header)
    assert ref_back.data.tobytes() == x.tobytes()
    ours = from_numpy(ref_out.data, SType.SERIAL, 1)
    (port_back,) = get_codec(codec).run_decode([ours], ref_header)
    assert port_back.content_bytes() == x.tobytes()


@pytest.mark.parametrize("codec", sorted(LEAVES))
def test_leaf_refuses_a_string_stream(codec):
    lengths = np.array([3, 0, 5], np.uint32)
    data = np.frombuffer(b"abcdefgh", np.uint8)
    port = Stream(torch.from_numpy(data.copy()), SType.STRING, 1, lengths)
    with pytest.raises(ValueError):
        get_codec(codec).run_encode([port], {})
    with pytest.raises(ValueError):
        ref_get_codec(codec).run_encode([RefStream(data, RefSType.STRING, 1, lengths)], {})


@pytest.mark.parametrize("codec", sorted(LEAVES))
def test_leaf_plan_frame_equals_reference(codec):
    x, _stype, _width = _stream("u32", seed=4)
    frame = repro_torch.compress(repro_torch.pipeline(codec), repro_torch.numeric(x), device="cpu", use_resolve_cache=False)
    ref_plan = RefGraphBuilder(1)
    ref_plan.add(codec, ref_plan.input(0))
    ref_in = [RefStream(x, RefSType.NUMERIC, 4)]
    assert frame == ref_compress(ref_plan.build(codec), ref_in, use_resolve_cache=False)
    (out,) = repro_torch.decompress(frame, device="cpu")
    assert out.content_bytes() == x.tobytes()
    (theirs,) = ref_decompress(frame)
    assert theirs.data.tobytes() == x.tobytes()


# ------------------------------------------------------- selectors at 7-9
def _codecs(frame):
    return [get_codec_by_id(node.codec_id).name for node in read_frame(frame)[2]]


@pytest.mark.parametrize("level", [7, 8, 9])
@pytest.mark.parametrize("selector", ["entropy_auto", "bytes_auto"])
def test_selector_commits_to_lzma_where_the_reference_does(selector, level):
    # a repeated 4 KiB block of random bytes: only an LZ backend sees the copies
    x = np.tile(np.random.default_rng(level).integers(0, 256, 4096).astype(np.uint8), 12)
    g = repro_torch.GraphBuilder(1)
    g.select(selector, g.input(0))
    frame = repro_torch.compress(
        g.build("s"), repro_torch.serial(x.tobytes()), repro_torch.CompressionCtx(level=level),
        device="cpu", use_resolve_cache=False,
    )
    rg = RefGraphBuilder(1)
    rg.select(selector, rg.input(0))
    ref_in = [RefStream(x, RefSType.SERIAL, 1)]
    assert frame == ref_compress(
        rg.build("s"), ref_in, ctx=RefCtx(level=level), use_resolve_cache=False
    )
    assert _codecs(frame) == ["lzma_backend"]
    (out,) = repro_torch.decompress(frame, device="cpu")
    assert out.content_bytes() == x.tobytes()


# ------------------------------------------------- float profiles at 7-9
PROFILES = {
    "bfloat16": (repro_torch.bfloat16_profile, ref_profiles.bfloat16_profile, 2),
    "float32": (repro_torch.float32_profile, ref_profiles.float32_profile, 4),
    "float64": (repro_torch.float64_profile, ref_profiles.float64_profile, 8),
}


def _weights(profile, kind):
    """normal(0, 0.02) weights as bit patterns (16 Ki values), or a block of
    them repeated three times whose exponent plane repeats every 40,000
    bytes: past DEFLATE's 32 KiB window, inside the 64 KiB trial sample, so
    the selectors commit to lzma."""
    rng = np.random.default_rng(len(profile) * 10 + len(kind))
    if kind == "tiled":
        w = np.tile(rng.normal(0.0, 0.02, 20_000 if profile == "float64" else 40_000), 3)
    else:
        w = rng.normal(0.0, 0.02, 1 << 14)
    if profile == "bfloat16":
        return torch.from_numpy(w).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return w.astype(np.float32).view(np.uint32) if profile == "float32" else w.view(np.uint64)


@pytest.mark.parametrize("level", [7, 8, 9])
@pytest.mark.parametrize("kind", ["weights", "tiled"])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_float_profile_above_level_6_writes_the_reference_frame(profile, kind, level):
    port_plan, ref_plan, width = PROFILES[profile]
    u = _weights(profile, kind)
    frame = repro_torch.compress(
        port_plan(), repro_torch.numeric(u), repro_torch.CompressionCtx(level=level), device="cpu", use_resolve_cache=False
    )
    ref_in = [RefStream(u, RefSType.NUMERIC, width)]
    assert frame == ref_compress(
        ref_plan(), ref_in, ctx=RefCtx(level=level), use_resolve_cache=False
    )
    assert frame == ref_compress(
        ref_plan(), ref_in, ctx=RefCtx(level=level), backend="device", use_resolve_cache=False
    )
    if kind == "tiled":
        assert "lzma_backend" in _codecs(frame)
    (ours,) = repro_torch.decompress(frame, device="cpu")
    assert (int(ours.stype), ours.width) == (int(SType.NUMERIC), width)
    assert ours.content_bytes() == u.tobytes()
    (theirs,) = ref_decompress(frame)
    assert theirs.data.tobytes() == u.tobytes()


def test_one_float32_value_at_level_7_writes_the_reference_frame():
    u = np.array([0.015625], np.float32).view(np.uint32)
    frame = repro_torch.compress(
        repro_torch.float32_profile(), repro_torch.numeric(u), repro_torch.CompressionCtx(level=7),
        device="cpu", use_resolve_cache=False,
    )
    assert frame == ref_compress(
        ref_profiles.float32_profile(), [RefStream(u, RefSType.NUMERIC, 4)], ctx=RefCtx(level=7),
        use_resolve_cache=False,
    )
    assert len(frame) == 52
