"""The port's ``lz77`` codec and ``bytes_auto`` selector, held against the
reference on the CPU.

``lz77`` is a host numpy codec in both packages (it had no TPU kernel); the
port keeps the reference's parse, so its four output streams and its header
must equal the reference encoder's byte for byte, its decoder must invert
them, and malformed token streams must be refused with ``ValueError``.
``bytes_auto`` — the entropy menu plus the ``lz77`` graph from level 4 up —
must commit to the reference's choice and write its frame.  Inputs are made
with numpy from fixed seeds; tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import CompressionCtx as RefCtx  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core.graph import GraphBuilder as RefGraphBuilder  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro_torch.core.codec import get_codec  # noqa: E402
from repro_torch.core.message import Stream, SType, from_numpy  # noqa: E402


def _data(kind, seed=0):
    """Byte streams: text-like, random, overlapping copies, and edge sizes."""
    rng = np.random.default_rng(seed)
    if kind == "text":
        words = [b"graph", b"codec", b"stream", b"frame", b"openzl", b"wire", b"the", b"of"]
        return np.frombuffer(b" ".join(words[i] for i in rng.integers(0, 8, 20000)), np.uint8)
    if kind == "random":
        return rng.integers(0, 256, 50_000).astype(np.uint8)
    if kind == "period_3":  # matches whose offset is shorter than their length
        return np.tile(np.array([7, 1, 9], np.uint8), 40_000)
    if kind == "one_byte":
        return np.full(70_000, 42, np.uint8)
    if kind == "mixed":  # random runs, copies of earlier runs, and literals
        parts, pool = [], [rng.integers(0, 256, 300).astype(np.uint8)]
        for _ in range(400):
            r = rng.random()
            if r < 0.4:
                parts.append(pool[rng.integers(0, len(pool))][: rng.integers(4, 300)])
            else:
                fresh = rng.integers(0, 256, rng.integers(1, 200)).astype(np.uint8)
                pool.append(fresh)
                parts.append(fresh)
        return np.concatenate(parts)
    if kind == "large_text":  # past one walk window (2 MiB) and one chain block
        return np.tile(_data("text", seed + 1), 24)[: (5 << 19) + 17]
    return {"empty": np.zeros(0, np.uint8), "three": np.array([1, 2, 3], np.uint8)}[kind]


KINDS = ["text", "random", "period_3", "one_byte", "mixed", "large_text", "empty", "three"]


def _encode_both(x, stype=SType.SERIAL, width=1):
    ref_outs, ref_header = ref_get_codec("lz77").run_encode([RefStream(x, RefSType(int(stype)), width)], {})
    outs, header = get_codec("lz77").run_encode([from_numpy(x, stype, width)], {})
    return (outs, header), (ref_outs, ref_header)


@pytest.mark.parametrize("kind", KINDS)
def test_lz77_matches_reference_and_roundtrips(kind):
    x = _data(kind)
    (outs, header), (ref_outs, ref_header) = _encode_both(x)
    assert header == ref_header
    assert len(outs) == len(ref_outs) == 4
    for p, r in zip(outs, ref_outs):
        assert (int(p.stype), p.width) == (int(r.stype), r.width)
        assert p.content_bytes() == r.content_bytes()
    (back,) = get_codec("lz77").run_decode(outs, header)
    assert back.stype == SType.SERIAL and back.content_bytes() == x.tobytes()


def test_lz77_keeps_a_numeric_streams_type_and_width():
    x = np.repeat(np.arange(500, dtype=np.uint32), 7)
    (outs, header), (ref_outs, ref_header) = _encode_both(x.view(np.uint8), SType.NUMERIC, 4)
    assert header == ref_header
    assert [o.content_bytes() for o in outs] == [o.content_bytes() for o in ref_outs]
    (back,) = get_codec("lz77").run_decode(outs, header)
    assert (back.stype, back.width, back.data.dtype) == (SType.NUMERIC, 4, torch.int32)
    assert back.content_bytes() == x.tobytes()


def _corrupt(outs, case):
    lit, runs, mls, offs = outs
    u32 = lambda a: Stream(torch.from_numpy(np.array(a, np.uint32).view(np.int32)), SType.NUMERIC, 4)  # noqa: E731
    if case == "runs_past_literals":
        return [lit, u32(runs.numpy() + 1), mls, offs]
    if case == "lengths_past_n":
        return [lit, runs, u32(mls.numpy() * 2), offs]
    if case == "offset_zero":
        o = offs.numpy().copy()
        o[0] = 0
        return [lit, runs, mls, u32(o)]
    o = offs.numpy().copy()  # a copy from before the stream's start
    o[0] = 1 << 30
    return [lit, runs, mls, u32(o)]


@pytest.mark.parametrize("case", ["runs_past_literals", "lengths_past_n", "offset_zero", "offset_past_start"])
def test_lz77_decoder_refuses_corrupt_token_streams(case):
    (outs, header), (_ref_outs, _ref_header) = _encode_both(_data("text"))
    bad = _corrupt(outs, case)
    with pytest.raises(ValueError):
        get_codec("lz77").run_decode(bad, header)
    ref_bad = [RefStream(s.numpy(), RefSType(int(s.stype)), s.width) for s in bad]
    with pytest.raises(ValueError):
        ref_get_codec("lz77").run_decode(ref_bad, header)


# ----------------------------------------------------------------- bytes_auto
def _bytes_auto(builder):
    g = builder(1)
    g.select("bytes_auto", g.input(0))
    return g.build("bytes")


@pytest.mark.parametrize("level", [3, 4, 5])
@pytest.mark.parametrize("kind", ["text", "random", "one_byte", "mixed", "signs", "three"])
def test_bytes_auto_commits_to_the_reference_choice(kind, level):
    if kind == "signs":  # a packed sign plane: balanced bits
        x = np.packbits(np.random.default_rng(7).integers(0, 2, 1 << 17).astype(np.uint8))
    else:
        x = _data(kind, seed=3)
    frame = repro_torch.compress(
        _bytes_auto(repro_torch.GraphBuilder), repro_torch.serial(x.tobytes()),
        repro_torch.CompressionCtx(level=level), device="cpu", use_resolve_cache=False,
    )
    ref_in = [RefStream(x, RefSType.SERIAL, 1)]
    ref_plan = _bytes_auto(RefGraphBuilder)
    assert frame == ref_compress(ref_plan, ref_in, ctx=RefCtx(level=level), use_resolve_cache=False)
    assert frame == ref_compress(
        ref_plan, ref_in, ctx=RefCtx(level=level), backend="device", use_resolve_cache=False
    )
    (out,) = repro_torch.decompress(frame, device="cpu")
    assert out.content_bytes() == x.tobytes()
    (theirs,) = ref_decompress(frame)
    assert theirs.content_bytes() == x.tobytes()
