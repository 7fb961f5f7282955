"""The float checkpoint slice, held against the reference on the CPU.

K7 (float split), K8 (float merge) and K13 (histogram) are pinned through
their plain PyTorch versions (``repro_torch.kernels.ref``, the version every
wrapper takes for a CPU tensor) against ``repro.kernels.ops`` with
``use_pallas=False`` and in Pallas interpret mode, and against the host
codec ``repro.codecs.floats`` for all four formats.  The ``float_split``
codec and the ``float32`` / ``bfloat16`` / ``float64`` profiles must give
the reference's frames byte for byte, with its host backend and with
``backend="device"``, and decode back to the input's bits.  Inputs are
random bit patterns and normal(0, 0.02) weights made with numpy from fixed
seeds, plus NaN payloads, infinities, -0.0 and subnormals; tolerance 0.
The CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.codecs import floats as ref_floats  # noqa: E402
from repro.codecs import profiles as ref_profiles  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core.codec import get_backend_codec  # noqa: E402
from repro.core.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core.graph import GraphBuilder as RefGraphBuilder  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.codec import get_codec  # noqa: E402
from repro_torch.core.message import Stream, SType, from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

from _torch_huffman_cap import prefix_converges_whole_refuses  # noqa: E402

UNSIGNED = {2: np.uint16, 4: np.uint32, 8: np.uint64}
SIGNED = {2: np.int16, 4: np.int32, 8: np.int64}
TORCH_SIGNED = {2: torch.int16, 4: torch.int32, 8: torch.int64}
# NaN with a payload, -NaN, +inf, -inf, -0.0, the smallest subnormal and its
# negative, the largest finite value, and all ones (a NaN), per format
SPECIALS = {
    0: [0x7FC1, 0xFFC0, 0x7F80, 0xFF80, 0x8000, 0x0001, 0x8001, 0x7F7F, 0xFFFF],
    1: [0x7E01, 0xFE00, 0x7C00, 0xFC00, 0x8000, 0x0001, 0x8001, 0x7BFF, 0xFFFF],
    2: [0x7FC00001, 0xFFC00000, 0x7F800000, 0xFF800000, 0x80000000, 0x00000001,
        0x80000001, 0x7F7FFFFF, 0xFFFFFFFF],
    3: [0x7FF8000000000001, 0xFFF8000000000000, 0x7FF0000000000000, 0xFFF0000000000000,
        1 << 63, 1, (1 << 63) | 1, 0x7FEFFFFFFFFFFFFF, (1 << 64) - 1],
}
LENGTHS = [0, 1, 7, 8, 9, 2047, 2049, 5003]  # not multiples of 8 or of 2048


def _bits(fmt, n, seed):
    """n random bit patterns of ``fmt`` (unsigned), specials first."""
    w = ref.FLOAT_FORMATS[fmt][0]
    rng = np.random.default_rng(seed)
    u = rng.integers(0, np.iinfo(UNSIGNED[w]).max, n, dtype=UNSIGNED[w], endpoint=True)
    k = min(n, len(SPECIALS[fmt]))
    u[:k] = np.array(SPECIALS[fmt], dtype=UNSIGNED[w])[:k]
    return u


def _carrier(u):
    return torch.from_numpy(u.view(SIGNED[u.dtype.itemsize]).copy())


def _unsigned(t):
    return t.numpy().view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[t.element_size()])


def _packbits(sign):
    return np.packbits(np.concatenate([sign, np.zeros((-sign.size) % 8, sign.dtype)]).astype(np.uint8))


# --------------------------------------------------------- K7 / K8 float32
@pytest.mark.parametrize("n", LENGTHS)
def test_float_split_plain_matches_reference_kernel(n):
    u = _bits(2, n, seed=n)
    sign, exp, man = ops.float_split(_carrier(u), 2)
    js, je, jm = jops.float_split(jnp.asarray(u), 8, 23, use_pallas=False)
    np.testing.assert_array_equal(sign.numpy(), _packbits(np.asarray(js)))
    np.testing.assert_array_equal(exp.numpy(), np.asarray(je).astype(np.uint8))
    np.testing.assert_array_equal(_unsigned(man), np.asarray(jm))
    back = ops.float_merge(sign, exp, man, 2)
    want = jops.float_merge(js, je, jm, 8, 23, use_pallas=False)
    np.testing.assert_array_equal(_unsigned(back), np.asarray(want))
    np.testing.assert_array_equal(_unsigned(back), u)


def test_float_split_and_merge_plain_match_pallas_interpret():
    u = _bits(2, 5003, seed=3)
    sign, exp, man = ops.float_split(_carrier(u), 2)
    js, je, jm = jops.float_split(jnp.asarray(u), 8, 23, use_pallas=True)
    np.testing.assert_array_equal(sign.numpy(), _packbits(np.asarray(js)))
    np.testing.assert_array_equal(exp.numpy(), np.asarray(je).astype(np.uint8))
    np.testing.assert_array_equal(_unsigned(man), np.asarray(jm))
    want = jops.float_merge(js, je, jm, 8, 23, use_pallas=True)
    np.testing.assert_array_equal(_unsigned(ops.float_merge(sign, exp, man, 2)), np.asarray(want))


# --------------------------------------------- K7 / K8, all four formats
@pytest.mark.parametrize("n", [0, 1, 9, 2049, 5003])
@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
def test_float_planes_match_the_host_codec(fmt, n):
    u = _bits(fmt, n, seed=10 * fmt + n)
    width = u.dtype.itemsize
    ref_outs, ref_header = ref_floats._float_split_enc([RefStream(u, RefSType.NUMERIC, width)], {"fmt": fmt})
    planes = ops.float_split(_carrier(u), fmt)
    for got, want in zip(planes, ref_outs):
        assert got.element_size() == want.data.dtype.itemsize
        assert got.numpy().tobytes() == want.data.tobytes()
    (want_u,) = ref_floats._float_split_dec(ref_outs, ref_header)
    back = ops.float_merge(*planes, fmt)
    assert back.dtype == TORCH_SIGNED[width]
    assert back.numpy().tobytes() == want_u.data.tobytes() == u.tobytes()


def test_float_merge_does_not_mask_its_planes():
    """Exponent and mantissa bits past their fields reach the value, as in the
    reference's decoder (the value is only cut to its width)."""
    sign = torch.tensor([0b10100000], dtype=torch.uint8)
    exp = torch.tensor([0x1FF, 3, 0x7FF], dtype=torch.int16)
    man = torch.tensor([-1, 1 << 52, 5], dtype=torch.int64)
    ref_outs = [RefStream(a, t, w) for a, t, w in (
        (sign.numpy(), RefSType.SERIAL, 1), (_unsigned(exp), RefSType.NUMERIC, 2),
        (_unsigned(man), RefSType.NUMERIC, 8))]
    header = ref_floats.HeaderWriter().u8(3).varint(3).done()
    (want,) = ref_floats._float_split_dec(ref_outs, header)
    assert ops.float_merge(sign, exp, man, 3).numpy().tobytes() == want.data.tobytes()


# -------------------------------------------------------------- K13 histogram
def _stream(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        return (rng.zipf(1.2, n) % 256).astype(np.uint8)
    if kind == "one":
        return np.zeros(n, np.uint8)
    return rng.integers(0, 256, n).astype(np.uint8)


def test_histogram_plain_matches_pallas_interpret():
    x = _stream("uniform", 5003, seed=4)  # far below 2^24 per bin
    got = ops.histogram(torch.from_numpy(x))
    want = jops.histogram(jnp.asarray(x), use_pallas=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("n", [0, 1, 4097, 100_003])
@pytest.mark.parametrize("kind", ["skewed", "uniform", "one"])
def test_histogram_plain_matches_histogram_exact(kind, n):
    x = _stream(kind, n, seed=n)
    got = ops.histogram(torch.from_numpy(x))
    assert got.dtype == torch.int64 and got.shape == (256,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.histogram_exact(jnp.asarray(x))))
    assert int(got.sum()) == n


# ------------------------------------------------------- float_split codec
def _ref_stream(u):
    return RefStream(u, RefSType.NUMERIC, u.dtype.itemsize)


@pytest.mark.parametrize("fmt", [0, 1, 2, 3])
def test_float_split_codec_matches_reference_and_roundtrips(fmt):
    spec, ref_spec = get_codec("float_split"), ref_get_codec("float_split")
    twin = get_backend_codec("device", "float_split")
    for n in (0, 1, 2049, 5003):
        u = _bits(fmt, n, seed=fmt + n)
        params = {"fmt": fmt}
        ref_outs, ref_header = ref_spec.run_encode([_ref_stream(u)], params)
        outs, header = spec.run_encode([from_numpy(u, SType.NUMERIC, u.dtype.itemsize)], params)
        assert header == ref_header
        for p, r in zip(outs, ref_outs):
            assert (int(p.stype), p.width) == (int(r.stype), r.width)
            assert p.content_bytes() == r.content_bytes()
        if twin.applies([_ref_stream(u)], dict(params)):
            twin_outs, twin_header = twin.encode([_ref_stream(u)], dict(params))
            assert twin_header == header
            assert [o.content_bytes() for o in outs] == [o.data.tobytes() for o in twin_outs]
        (back,) = spec.run_decode(outs, header)
        assert (int(back.stype), back.width) == (int(SType.NUMERIC), u.dtype.itemsize)
        assert back.content_bytes() == u.tobytes()


@pytest.mark.parametrize("case", ["short_signs", "short_mantissa", "wide_exponent", "bad_fmt"])
def test_float_split_decoder_fails_closed(case):
    u = _bits(2, 100, seed=1)
    spec = get_codec("float_split")
    outs, header = spec.run_encode([from_numpy(u, SType.NUMERIC, 4)], {})
    if case == "short_signs":
        outs[0] = Stream(outs[0].data[:-1].clone(), SType.SERIAL, 1)
    elif case == "short_mantissa":
        outs[2] = Stream(outs[2].data[:-1].clone(), SType.NUMERIC, 4)
    elif case == "wide_exponent":
        outs[1] = Stream(outs[1].data.to(torch.int16), SType.NUMERIC, 2)
    else:
        header = bytes([7]) + header[1:]
    with pytest.raises(ValueError):
        spec.run_decode(outs, header)


def test_float_split_refuses_a_width_that_is_not_the_formats():
    with pytest.raises(ValueError):
        get_codec("float_split").run_encode(
            [from_numpy(np.arange(4, dtype=np.uint32), SType.NUMERIC, 4)], {"fmt": 0}
        )


# ----------------------------------------------------------- float profiles
PROFILES = {
    "bfloat16": (repro_torch.bfloat16_profile, ref_profiles.bfloat16_profile, torch.bfloat16, 1 << 19),
    "float32": (repro_torch.float32_profile, ref_profiles.float32_profile, torch.float32, 1 << 16),
    "float64": (repro_torch.float64_profile, ref_profiles.float64_profile, torch.float64, 1 << 15),
}
FMT = {"bfloat16": 0, "float32": 2, "float64": 3}


def _weights(profile, kind):
    """normal(0, 0.02) weights (1 MiB bf16, 256 KiB f32 and f64), or 64 KiB
    of them with NaN payloads, infinities, -0.0 and subnormals spread in."""
    _port, _ref, dtype, n = PROFILES[profile]
    rng = np.random.default_rng(len(profile) + len(kind))
    if kind == "special":
        n = (1 << 16) // torch.finfo(dtype).bits * 8
    w = torch.from_numpy(rng.normal(0.0, 0.02, n)).to(dtype)
    u = w.view(TORCH_SIGNED[w.element_size()]).numpy().view(UNSIGNED[w.element_size()]).copy()
    if kind == "special":
        at = rng.integers(0, n, 64 * len(SPECIALS[FMT[profile]]))
        u[at] = np.resize(np.array(SPECIALS[FMT[profile]], u.dtype), at.size)
    return u


@pytest.mark.parametrize("kind", ["weights", "special"])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_float_profile_frame_equals_reference(profile, kind):
    port_plan, ref_plan, _dtype, _n = PROFILES[profile]
    u = _weights(profile, kind)
    frame = repro_torch.compress(port_plan(), repro_torch.numeric(u), device="cpu", use_resolve_cache=False)
    assert frame == ref_compress(ref_plan(), [_ref_stream(u)], use_resolve_cache=False)
    assert frame == ref_compress(
        ref_plan(), [_ref_stream(u)], backend="device", use_resolve_cache=False
    )
    (ours,) = repro_torch.decompress(frame, device="cpu")
    assert (int(ours.stype), ours.width) == (int(SType.NUMERIC), u.dtype.itemsize)
    assert ours.content_bytes() == u.tobytes()
    (theirs,) = ref_decompress(frame)
    assert theirs.content_bytes() == u.tobytes()


def test_a_bf16_weight_tensor_becomes_a_numeric_2_stream_in_place():
    w = torch.from_numpy(np.random.default_rng(5).normal(0, 0.02, 4096)).to(torch.bfloat16)
    s = repro_torch.numeric(w)
    assert (s.stype, s.width, s.data.dtype) == (SType.NUMERIC, 2, torch.int16)
    assert s.data.data_ptr() == w.data_ptr()  # a view: no copy, no host trip
    frame = repro_torch.compress(repro_torch.bfloat16_profile(), s, device="cpu", use_resolve_cache=False)
    (out,) = repro_torch.decompress(frame, device="cpu")
    assert torch.equal(out.data.view(torch.bfloat16), w)


# ------------------------------------------- Huffman's length cap (a fault)
def _fibonacci_bytes():
    """22 symbols with Fibonacci counts (46,367 bytes): a Huffman tree 21 deep,
    which the 15-bit cap's count flattening never brings under 16."""
    f = [1, 1]
    while len(f) < 22:
        f.append(f[-1] + f[-2])
    return np.repeat(np.arange(22, dtype=np.uint8) * 3, f)


def test_huffman_refuses_counts_whose_length_cap_does_not_converge():
    """In a trial the port refuses what the reference's encoder raises on;
    outside one it writes package-merge lengths that both packages decode."""
    from repro_torch.core.codec import trial
    from repro_torch.core.graph import pipeline

    x = _fibonacci_bytes()
    with pytest.raises(AssertionError):  # the reference's encoder
        ref_get_codec("huffman").run_encode([RefStream(x, RefSType.SERIAL, 1)], {})
    with trial(), pytest.raises(ValueError):
        get_codec("huffman").run_encode([from_numpy(x, SType.SERIAL, 1)], {})
    frame = repro_torch.compress(pipeline("huffman"), repro_torch.serial(x.tobytes()), device="cpu",
                                 use_resolve_cache=False)
    assert repro_torch.decompress(frame, device="cpu")[0].content_bytes() == x.tobytes()
    assert np.asarray(ref_decompress(frame)[0].data).tobytes() == x.tobytes()
    # so the trial selectors skip Huffman on both sides and agree
    g = repro_torch.GraphBuilder(1)
    g.select("entropy_auto", g.input(0))
    rg = RefGraphBuilder(1)
    rg.select("entropy_auto", rg.input(0))
    frame = repro_torch.compress(g.build("e"), repro_torch.serial(x.tobytes()), device="cpu", use_resolve_cache=False)
    assert frame == ref_compress(rg.build("e"), [RefStream(x, RefSType.SERIAL, 1)], use_resolve_cache=False)


def _kraft_and_cost(lens, counts):
    present = lens > 0
    kraft = np.sum(2.0 ** -lens[present].astype(np.float64))
    return kraft, int(np.sum(counts.astype(np.int64) * lens))


@pytest.mark.parametrize("seed", range(6))
def test_package_merge_lengths_are_optimal_under_the_cap(seed):
    """Package-merge's lengths form a complete code of at most 15 bits whose
    cost lies between plain Huffman's (no cap) and the count flattening's."""
    from repro_torch.codecs import entropy as TE

    rng = np.random.default_rng(seed)
    n_sym = int(rng.integers(2, 257))
    counts = np.zeros(256, np.int64)
    syms = rng.choice(256, n_sym, replace=False)
    counts[syms] = (rng.pareto(0.5 + seed / 4, n_sym) * 10).astype(np.int64) + 1
    pm = TE._package_merge_lengths(counts, np.nonzero(counts)[0])
    kraft, cost = _kraft_and_cost(pm, counts)
    assert kraft == 1.0 and pm.max() <= TE.MAX_CODE_LEN and (pm[counts > 0] > 0).all()
    flat = TE._huffman_code_lengths(counts)  # converges on these counts
    heap = sorted(counts[counts > 0].tolist())
    huffman_cost = 0  # the sum of merged weights is the tree's cost
    while len(heap) > 1:
        a, b = heap.pop(0), heap.pop(0)
        huffman_cost += a + b
        heap.append(a + b)
        heap.sort()
    assert huffman_cost <= cost <= _kraft_and_cost(flat, counts)[1]


def test_outside_a_trial_a_prefix_chosen_huffman_encodes_the_whole_input():
    """The trial picks Huffman on the first 64 KiB, whose counts the cap's
    flattening meets; the whole stream's counts defeat it.  The reference's
    compress raises; the port's writes the pick with package-merge lengths,
    a frame both packages decode."""
    from repro_torch.core import engine

    x = prefix_converges_whole_refuses()
    g = repro_torch.GraphBuilder(1)
    g.select("entropy_auto", g.input(0))
    plan = g.build("e")
    rg = RefGraphBuilder(1)
    rg.select("entropy_auto", rg.input(0))
    with pytest.raises(AssertionError, match="length cap"):
        ref_compress(rg.build("e"), [RefStream(x, RefSType.SERIAL, 1)], use_resolve_cache=False)
    s = repro_torch.serial(x.tobytes())
    assert "huffman" in engine.resolve(plan, [s], use_cache=False).codec_names()
    frame = repro_torch.compress(plan, s, device="cpu", use_resolve_cache=False)
    assert len(frame) < x.size // 2
    (back,) = repro_torch.decompress(frame, device="cpu")
    assert back.content_bytes() == x.tobytes()
    (ref_back,) = ref_decompress(frame)
    assert np.asarray(ref_back.data).tobytes() == x.tobytes()


def test_inside_a_trial_the_refusal_still_rejects_the_candidate():
    """A pipeline whose nested selector's pick refuses its whole input is,
    as a trial candidate, inapplicable, as the reference's trials find it."""
    from repro_torch.codecs import selectors
    from repro_torch.core.codec import trial

    x = prefix_converges_whole_refuses()
    g = repro_torch.GraphBuilder(1)
    g.select("entropy_auto", g.input(0))
    with trial(), pytest.raises(ValueError, match="length cap"):
        repro_torch.compress(g.build("e"), repro_torch.serial(x.tobytes()), device="cpu",
                             use_resolve_cache=False)
    ctx = repro_torch.CompressionCtx()
    assert selectors._trial_size(g.build("e"), repro_torch.serial(x.tobytes()), ctx) == 1 << 62


# ------------------------------------------------------------------ wrappers
def test_float_wrappers_count_no_launch_on_the_cpu():
    ops.reset_launches()
    planes = ops.float_split(torch.arange(10, dtype=torch.int32), 2)
    ops.float_merge(*planes, 2)
    ops.histogram(torch.zeros(9, dtype=torch.uint8))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_float_wrappers_refuse_bad_shapes_formats_and_devices():
    with pytest.raises(TypeError):  # float32 values, not their bit patterns
        ops.float_split(torch.zeros(8, dtype=torch.float32), 2)
    with pytest.raises(TypeError):  # int16 carrier for the float32 format
        ops.float_split(torch.zeros(8, dtype=torch.int16), 2)
    with pytest.raises(ValueError):
        ops.float_split(torch.zeros(8, dtype=torch.int32), 9)
    with pytest.raises(ValueError):  # 9 values need two sign bytes
        ops.float_merge(
            torch.zeros(1, dtype=torch.uint8), torch.zeros(9, dtype=torch.uint8),
            torch.zeros(9, dtype=torch.int32), 2,
        )
    with pytest.raises(ValueError):
        ops.histogram(torch.zeros((2, 2), dtype=torch.uint8))
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ops.KernelError, match="cuda or cpu"):
        ops.float_split(meta, 2)
