"""The bit-packing family of the port against the reference, on the CPU.

The four plain versions behind K5, K6, K11 and K12 (``repro_torch.kernels``)
are held against the reference's wrappers run through their Pallas kernels
in interpret mode and against its jnp oracles; the ``bitpack`` and
``fused_delta_bitpack`` codecs against the reference's host codecs and
device twins; and whole frames of ``delta+bitpack``, ``bitpack`` and
``fused_delta_bitpack`` plans against ``repro.core.compress(...,
backend="device")``, which fuses the pair and lowers it where the data
refuses.  Every comparison is byte for byte (tolerance 0); inputs are made
with numpy from fixed seeds.  The CUDA kernels themselves are held against
the same plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.codecs.numeric import _pack_bits as ref_pack_bits  # noqa: E402
from repro.codecs.numeric import fused_bits_for as ref_fused_bits_for  # noqa: E402
from repro.core import CompressionCtx as RefCtx  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core.codec import get_backend_codec  # noqa: E402
from repro.core.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core.engine import fuse_resolved as ref_fuse_resolved  # noqa: E402
from repro.core.engine import resolve as ref_resolve  # noqa: E402
from repro.core.graph import GraphBuilder as RefGraphBuilder  # noqa: E402
from repro.core.graph import pipeline as ref_pipeline  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro.core.message import numeric as ref_numeric  # noqa: E402
from repro.core.wire import read_frame as ref_read_frame  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.codecs.numeric import fused_bits_for  # noqa: E402
from repro_torch.codecs._util import HeaderWriter  # noqa: E402
from repro_torch.core.codec import get_codec  # noqa: E402
from repro_torch.core.engine import fuse_resolved, resolve  # noqa: E402
from repro_torch.core.message import SType, from_numpy  # noqa: E402
from repro_torch.core.wire import read_frame  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

BITS = (1, 2, 4, 8, 16, 32)
SIZES = (0, 1, 31, 32, 1000, 8192)
WIDTHS = (1, 2, 4)
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
CARRIER = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}
COLUMN_BYTES = 1 << 18


def _values(bits, n, width, seed):
    """n values below 2^bits that fit the stream width, unsigned."""
    rng = np.random.default_rng(seed)
    hi = 1 << min(bits, 8 * width)
    return rng.integers(0, hi, n, dtype=np.uint64).astype(UNSIGNED[width])


def _tensor(x):
    """The port's carrier of an unsigned numpy array, on the CPU."""
    return torch.from_numpy(x.view(CARRIER[x.dtype.itemsize]).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


# ------------------------------------------------- K5 / K6 plain versions
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", BITS)
def test_bitpack_plain_matches_pallas_and_oracle(bits, n, width):
    x = _values(bits, n, width, seed=bits * 100 + n + width)
    per = 32 // bits
    words = ops.bitpack(_tensor(x), bits)
    assert words.dtype == torch.int32 and words.numel() == -(-n // per)
    x32 = jnp.asarray(x.astype(np.uint32))
    pallas = np.asarray(jops.bitpack(x32, bits))  # interpret mode on the CPU
    np.testing.assert_array_equal(_u32(words), pallas)
    oracle = np.asarray(jref.bitpack_encode(jnp.asarray(np.pad(x.astype(np.uint32), (0, (-n) % per))), bits))
    np.testing.assert_array_equal(_u32(words), oracle)
    back = ops.bitunpack(words, bits, n, width)
    assert back.dtype == _tensor(x).dtype
    np.testing.assert_array_equal(back.numpy().view(UNSIGNED[width]), x)
    unpacked = np.asarray(jops.bitunpack(jnp.asarray(pallas), bits, n))
    np.testing.assert_array_equal(back.numpy().view(UNSIGNED[width]), unpacked.astype(UNSIGNED[width]))


@pytest.mark.parametrize("bits", BITS)
def test_bitunpack_plain_cuts_every_word_to_the_output_width(bits):
    """Any word pattern: each value is (word >> k*bits) & mask, cut to the width."""
    n = 777
    m = -(-n // (32 // bits))
    w = np.random.default_rng(bits).integers(0, 1 << 32, m, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jref.bitpack_decode(jnp.asarray(w), bits))[:n]
    for width in WIDTHS:
        got = ops.bitunpack(torch.from_numpy(w.view(np.int32)), bits, n, width)
        np.testing.assert_array_equal(got.numpy().view(UNSIGNED[width]), want.astype(UNSIGNED[width]))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("bits", BITS)
def test_bitunpack_plain_from_words_inside_their_allocation(bits, offset):
    """Words 1-3 words into their tensor (a payload view into a frame, which
    the card's kernel reads through its shifted path), at every output width
    on chip_smoke.py's ragged sizes."""
    rng = np.random.default_rng(bits * 10 + offset)
    for n in (1, 31, 33, 1000, 4097, 100_003):
        m = -(-n // (32 // bits))
        buf = rng.integers(0, 1 << 32, m + 3, dtype=np.uint64).astype(np.uint32)
        words = torch.from_numpy(buf.view(np.int32))[offset: offset + m]
        assert words.storage_offset() == offset
        want = np.asarray(jref.bitpack_decode(jnp.asarray(buf[offset: offset + m]), bits))[:n]
        for width in WIDTHS:
            got = ops.bitunpack(words, bits, n, width)
            np.testing.assert_array_equal(got.numpy().view(UNSIGNED[width]), want.astype(UNSIGNED[width]))


# --------------------------------------------- K11 / K12 plain versions
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", BITS)
def test_fused_delta_bitpack_plain_matches_pallas_and_oracle(bits, n, width):
    """Random values: the u32 deltas wrap and are masked to ``bits``."""
    rng = np.random.default_rng(bits * 1000 + n + width)
    x = rng.integers(0, 1 << (8 * width), n, dtype=np.uint64).astype(UNSIGNED[width])
    per = 32 // bits
    words = ops.fused_delta_bitpack(_tensor(x), bits)
    x32 = x.astype(np.uint32)
    pallas = np.asarray(jops.fused_delta_bitpack(jnp.asarray(x32), bits))
    np.testing.assert_array_equal(_u32(words), pallas)
    padded = np.pad(x32, (0, (-n) % per), mode="edge" if n else "constant")
    oracle = np.asarray(jref.fused_delta_bitpack_encode(jnp.asarray(padded), bits))
    np.testing.assert_array_equal(_u32(words), oracle)
    back = ops.fused_delta_bitpack_decode(words, bits, n, width)
    want = np.asarray(jops.fused_delta_bitpack_decode(jnp.asarray(pallas), bits, n))
    np.testing.assert_array_equal(back.numpy().view(UNSIGNED[width]), want.astype(UNSIGNED[width]))
    if bits == 32:  # nothing masked: the decode inverts the encode
        np.testing.assert_array_equal(back.numpy().view(UNSIGNED[width]), x)


@pytest.mark.parametrize("bits", (4, 8, 16))
def test_fused_plain_equals_delta_then_bitpack(bits):
    x = np.cumsum(np.random.default_rng(bits).integers(0, 1 << bits, 7000)).astype(np.uint32)
    fused = ops.fused_delta_bitpack(_tensor(x), bits)
    d = ops.delta_encode(_tensor(x))
    np.testing.assert_array_equal(fused.numpy(), ops.bitpack(d, bits).numpy())


@pytest.mark.parametrize("bad", ["bits", "dtype", "short"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    x = torch.arange(10, dtype=torch.int32)
    if bad == "bits":
        for fn in (ops.bitpack, ops.fused_delta_bitpack):
            with pytest.raises(ValueError):
                fn(x, 3)
        with pytest.raises(ValueError):
            ops.bitunpack(x, 12, 5)
    elif bad == "dtype":
        for fn in (ops.bitpack, ops.fused_delta_bitpack):
            with pytest.raises(TypeError):
                fn(x.to(torch.int64), 8)
    else:
        for fn in (ops.bitunpack, ops.fused_delta_bitpack_decode):
            with pytest.raises(ValueError):
                fn(x[:2], 8, 9)


# ----------------------------------------------------------------- codecs
def _codec_cases():
    rng = np.random.default_rng(7)
    cases = []
    for width in (1, 2, 4, 8):
        dt = UNSIGNED[width]
        small = rng.integers(0, 200, 3001).astype(dt)
        ramp = np.cumsum(rng.integers(0, 16, 3001)).astype(dt)
        cases += [
            (f"small_u{8 * width}", small, {}),
            (f"small_u{8 * width}_bits8", small, {"bits": 8}),
            (f"small_u{8 * width}_bits12", small, {"bits": 12}),
            (f"small_u{8 * width}_bits4_too_narrow", small, {"bits": 4}),
            (f"ramp_u{8 * width}", ramp, {}),
            (f"ramp_u{8 * width}_bits16", ramp, {"bits": 16}),
            (f"full_u{8 * width}", rng.integers(0, np.iinfo(dt).max, 999, dtype=dt, endpoint=True), {}),
            (f"empty_u{8 * width}", np.zeros(0, dt), {}),
            (f"one_u{8 * width}", np.array([1], dt), {}),
        ]
    cases += [
        ("u32_3bit", rng.integers(0, 8, 1001).astype(np.uint32), {}),
        ("u32_bits32", rng.integers(0, 1 << 32, 1001, dtype=np.uint64).astype(np.uint32), {"bits": 32}),
        ("u64_57bit", rng.integers(0, 1 << 57, 333, dtype=np.uint64), {}),
        ("u64_61bit", rng.integers(0, 1 << 61, 333, dtype=np.uint64), {}),
        ("u8_ragged_4bit", rng.integers(0, 16, 4097).astype(np.uint8), {}),
    ]
    return cases


CODEC_CASES = _codec_cases()


@pytest.mark.parametrize("codec", ["bitpack", "fused_delta_bitpack"])
@pytest.mark.parametrize("case", CODEC_CASES, ids=[c[0] for c in CODEC_CASES])
def test_codec_matches_reference_host_and_device_twin(codec, case):
    _name, x, params = case
    s = RefStream(x, RefSType.NUMERIC, x.dtype.itemsize)
    port = get_codec(codec)
    try:
        ref_outs, ref_header = ref_get_codec(codec).run_encode([s], dict(params))
    except ValueError:
        with pytest.raises(ValueError):
            port.run_encode([from_numpy(x, SType.NUMERIC, x.dtype.itemsize)], dict(params))
        return
    outs, header = port.run_encode([from_numpy(x, SType.NUMERIC, x.dtype.itemsize)], dict(params))
    assert header == ref_header
    assert [(int(o.stype), o.width, o.content_bytes()) for o in outs] == [
        (int(o.stype), o.width, o.content_bytes()) for o in ref_outs
    ]
    twin = get_backend_codec("device", codec)
    twin_params = dict(params)
    if twin.applies([s], twin_params):
        twin_outs, twin_header = twin.encode([s], twin_params)
        assert header == twin_header
        assert outs[0].content_bytes() == twin_outs[0].content_bytes()
    (back,) = port.run_decode(outs, header)
    assert back.content_bytes() == x.tobytes() and back.width == x.dtype.itemsize
    (ref_back,) = ref_get_codec(codec).run_decode(ref_outs, header)
    assert ref_back.content_bytes() == x.tobytes()


@pytest.mark.parametrize("bits", [0, 3, 12, 33])
def test_fused_decoder_takes_any_bits_as_the_reference_does(bits):
    """Widths outside the choices decode through the bit reader, then K2."""
    d = np.random.default_rng(bits).integers(0, 1 << bits, 2049, dtype=np.uint64) if bits else np.zeros(2049, np.uint64)
    payload = ref_pack_bits(d, bits) if bits else np.zeros(0, np.uint8)
    header = HeaderWriter().u8(bits).u8(2).varint(d.size).done()
    (ref_out,) = ref_get_codec("fused_delta_bitpack").run_decode(
        [RefStream(payload, RefSType.SERIAL, 1)], header
    )
    (out,) = get_codec("fused_delta_bitpack").run_decode(
        [from_numpy(payload, SType.SERIAL, 1)], header
    )
    assert out.width == 2 and out.content_bytes() == ref_out.content_bytes()


@pytest.mark.parametrize("codec,bits,width", [
    ("bitpack", 4, 1), ("bitpack", 12, 4), ("fused_delta_bitpack", 8, 4),
    ("fused_delta_bitpack", 3, 4),
])
def test_short_payload_raises_before_any_kernel(codec, bits, width):
    n = 1000
    header = HeaderWriter().u8(bits).u8(width).varint(n).done()
    payload = np.zeros((n * bits + 7) // 8 - 1, np.uint8)
    with pytest.raises(ValueError, match="shorter"):
        get_codec(codec).run_decode([from_numpy(payload, SType.SERIAL, 1)], header)


@pytest.mark.parametrize("kind", ["offsets", "int4", "zipf", "decreasing_u8", "constant"])
@pytest.mark.parametrize("explicit", [0, 8, 12])
def test_fused_bits_for_matches_reference(kind, explicit):
    x = _column(kind)
    got = fused_bits_for(from_numpy(x, SType.NUMERIC, x.dtype.itemsize), explicit)
    assert got == ref_fused_bits_for(ref_numeric(x), explicit)


# ----------------------------------------------------------------- frames
def _column(kind):
    rng = np.random.default_rng(
        {"offsets": 11, "int4": 12, "zipf": 13, "timestamps": 14, "constant": 15,
         "decreasing_u8": 16}[kind]
    )
    if kind == "offsets":  # an Arrow/Parquet offsets buffer: 0, then running lengths
        lengths = np.minimum(rng.zipf(1.6, COLUMN_BYTES // 4 - 1), 255)
        return np.concatenate([[0], np.cumsum(lengths)]).astype(np.uint32)
    if kind == "int4":  # int4 weight codes, one per byte
        return np.clip(np.rint(rng.normal(7.5, 2.5, COLUMN_BYTES)), 0, 15).astype(np.uint8)
    if kind == "zipf":  # ids drawn from a random id space: wrapped u32 deltas
        ids = rng.integers(0, 1 << 32, 1 << 12, dtype=np.uint64).astype(np.uint32)
        return ids[np.minimum(rng.zipf(1.15, COLUMN_BYTES // 4), ids.size) - 1]
    if kind == "timestamps":
        gaps = rng.integers(900_000, 1_100_000, COLUMN_BYTES // 8)
        return (1_700_000_000_000_000_000 + np.cumsum(gaps)).astype(np.int64)
    if kind == "decreasing_u8":
        return np.arange(COLUMN_BYTES, 0, -1).astype(np.uint8)
    return np.full(COLUMN_BYTES // 4, 0xC0FFEE, np.uint32)


PLANS = {
    "delta+bitpack": ("delta", "bitpack"),
    "bitpack": ("bitpack",),
    "fused_bits8": (("fused_delta_bitpack", {"bits": 8}),),
}
KINDS = ("offsets", "int4", "zipf", "timestamps", "constant")


def _frames(plan_spec, col, fv=4):
    """(port frame, reference frame): a frame, or the ValueError each raised."""
    out = []
    for run in (
        lambda: repro_torch.compress(
            repro_torch.pipeline(*plan_spec), repro_torch.numeric(col),
            repro_torch.CompressionCtx(format_version=fv), device="cpu", use_resolve_cache=False,
        ),
        lambda: ref_compress(
            ref_pipeline(*plan_spec), ref_numeric(col), ctx=RefCtx(format_version=fv),
            backend="device", use_resolve_cache=False,
        ),
    ):
        try:
            out.append(run())
        except ValueError as err:
            out.append(err)
    return out


def _codecs(frame):
    return [n.codec_id for n in read_frame(frame)[2]]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_port_frame_equals_reference_device_frame(kind, plan_name):
    col = _column(kind)
    frame, ref_frame = _frames(PLANS[plan_name], col)
    if isinstance(ref_frame, ValueError):
        assert isinstance(frame, ValueError), f"the reference raised {ref_frame}"
        return
    assert frame == ref_frame
    (ours,) = repro_torch.decompress(ref_frame, device="cpu")
    assert ours.content_bytes() == col.tobytes()
    (theirs,) = ref_decompress(frame)
    assert theirs.content_bytes() == col.tobytes()


@pytest.mark.parametrize("kind,codecs", [
    ("offsets", [26]),  # fused at 8 bits
    ("int4", [3, 6]),  # codes go down as often as up: u32 deltas wrap
    ("zipf", [3, 6]),  # wrapped u32 deltas refuse fusion: lowered
    ("decreasing_u8", [3, 6]),  # u32 deltas wrap to ~2^32, u8 deltas fit 8 bits
])
def test_delta_bitpack_fuses_or_lowers_as_the_reference_does(kind, codecs):
    col = _column(kind)
    frame, ref_frame = _frames(("delta", "bitpack"), col)
    assert [n.codec_id for n in ref_read_frame(ref_frame)[2]] == codecs
    assert _codecs(frame) == codecs
    assert frame == ref_frame


def test_string_offsets_fuse_at_8_bits_and_int4_codes_pack_at_4():
    frame, _ = _frames(("delta", "bitpack"), _column("offsets"))
    (node,) = read_frame(frame)[2]
    assert node.codec_id == 26 and node.header[0] == 8
    frame, _ = _frames(("bitpack",), _column("int4"))
    (node,) = read_frame(frame)[2]
    assert node.codec_id == 6 and node.header[0] == 4


def test_int64_timestamps_raise_in_both_packages():
    """The fused codec refuses width 8; the lowered bitpack then meets
    d[0] = x[0], which needs 61 bits, more than 57."""
    frame, ref_frame = _frames(("delta", "bitpack"), _column("timestamps"))
    assert isinstance(ref_frame, ValueError) and isinstance(frame, ValueError)
    assert "57" in str(frame)


def test_values_wider_than_an_explicit_bits_raise_in_both_packages():
    col = np.arange(300, dtype=np.uint32)
    frame, ref_frame = _frames((("bitpack", {"bits": 8}),), col)
    assert isinstance(ref_frame, ValueError) and isinstance(frame, ValueError)


def test_format_v3_leaves_the_pair_unfused():
    col = _column("offsets")
    frame, ref_frame = _frames(("delta", "bitpack"), col, fv=3)
    assert frame == ref_frame and _codecs(frame) == [3, 6]
    r = resolve(repro_torch.pipeline("delta", "bitpack"), [repro_torch.numeric(col)],
                repro_torch.CompressionCtx(format_version=3))
    assert fuse_resolved(r) is r


@pytest.mark.parametrize("bits,codecs", [(12, [3, 6]), (16, [26])])
def test_explicit_bits_decide_whether_the_pair_fuses(bits, codecs):
    col = _column("offsets")
    frame, ref_frame = _frames(("delta", ("bitpack", {"bits": bits})), col)
    assert frame == ref_frame and _codecs(frame) == codecs


def _tokenized_plan(builder):
    """tokenize -> delta(indices) -> bitpack -> huffman, then delta(alphabet):
    steps after the pair read and write edges past the lowering's interior edge."""
    g = builder(1)
    alphabet, indices = g.add("tokenize", g.input(0))
    packed = g.add("bitpack", g.add("delta", indices))
    g.add("huffman", packed)
    g.add("delta", alphabet)
    return g.build("tokenize_fuse_mid")


def test_steps_after_a_lowered_pair_keep_the_wire_edge_ids():
    col = _column("zipf")[:20000]
    plan = _tokenized_plan(repro_torch.GraphBuilder)
    ref_plan = _tokenized_plan(RefGraphBuilder)
    frame = repro_torch.compress(plan, repro_torch.numeric(col), device="cpu", use_resolve_cache=False)
    ref_frame = ref_compress(ref_plan, ref_numeric(col), backend="device", use_resolve_cache=False)
    nodes = read_frame(frame)[2]
    assert [n.codec_id for n in nodes] == [9, 3, 6, 14, 3]  # the pair lowered
    assert [n.inputs for n in nodes] == [(0,), (2,), (3,), (4,), (1,)]
    assert frame == ref_frame
    (ours,) = repro_torch.decompress(ref_frame, device="cpu")
    assert ours.content_bytes() == col.tobytes()
    (theirs,) = ref_decompress(frame)
    assert theirs.content_bytes() == col.tobytes()


def test_fusion_pass_rewrites_as_the_reference_does():
    col = _column("offsets")[:5000]
    plan = _tokenized_plan(repro_torch.GraphBuilder)
    ref_plan = _tokenized_plan(RefGraphBuilder)
    ours = fuse_resolved(resolve(plan, [repro_torch.numeric(col)]))
    theirs = ref_fuse_resolved(ref_resolve(ref_plan, [ref_numeric(col)], use_cache=False))
    assert theirs.fused and "fused_delta_bitpack" in ours.codec_names()
    assert [(s.name, s.codec_id, s.inputs, s.n_out, s.param_dict()) for s in ours.steps] == [
        (s.name, s.codec_id, s.inputs, s.n_out, s.param_dict()) for s in theirs.steps
    ]
    assert fuse_resolved(ours) is ours
