"""The structural codecs, STRING streams and the record profiles: the port
against the reference.

``dup``, ``constant``, ``split_n``, ``concat``, ``field_split``,
``string_split``, ``rle``, ``transpose_split`` and STRING ``tokenize``
encode to the reference's output streams and headers (``run_encode``
against ``repro.core.codec.get_codec``; ``transpose_split`` also against its
``"device"`` twin), refuse where the reference refuses, and decode back to
their input.  Whole frames of each codec, of ``sao_profile()``,
``struct_profile(...)`` and of ``generic_profile()`` on STRING streams
(unchunked and in containers) equal ``repro.core.compress(...,
backend="device", use_resolve_cache=False)``.  STRING lengths cross the
wire as the reference writes them, and malformed ones fail closed.  A
codec with no output streams (``constant``) is handed the decode device.
All on the CPU, tolerance 0.
"""
import dataclasses
import struct as pystruct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.codecs import profiles as ref_profiles  # noqa: E402
from repro.codecs.selectors import _sample as ref_sample  # noqa: E402
from repro.core import CompressionCtx as RefCtx  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro.core.codec import get_backend_codec  # noqa: E402
from repro.core.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core.graph import GraphBuilder as RefGraphBuilder  # noqa: E402
from repro.core.graph import pipeline as ref_pipeline  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro_torch import CompressionCtx, GraphBuilder  # noqa: E402
from repro_torch.codecs.selectors import _sample  # noqa: E402
from repro_torch.core import codec as codec_registry  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.core.codec import get_codec  # noqa: E402
from repro_torch.core.message import Stream, SType, from_numpy  # noqa: E402

SIZES = (0, 1, 7, 4097)
FIXED_TYPES = (  # (stype, width)
    (SType.NUMERIC, 1), (SType.NUMERIC, 2), (SType.NUMERIC, 4), (SType.NUMERIC, 8),
    (SType.STRUCT, 3), (SType.STRUCT, 6), (SType.STRUCT, 28), (SType.SERIAL, 1),
)
KINDS = ("random", "constant", "runs")
FIXED_CODECS = ("dup", "constant", "split_n", "concat", "field_split", "string_split",
                "rle", "transpose_split")
WORDS = [b"alpha", b"beta", b"", b"gamma", b"x" * 40, b"\x00\xff", b"beta "]


def _ids(cases):
    return [f"{int(st)}x{w}" for st, w in cases]


# ------------------------------------------------------------------ streams
def _fixed(stype, width, n, kind, seed):
    """n elements of (stype, width) as one array of their bytes."""
    rng = np.random.default_rng(seed)
    nb = n * width
    if kind == "random":
        raw = rng.integers(0, 256, nb, dtype=np.uint8)
    elif kind == "constant":
        raw = np.tile(rng.integers(0, 256, width, dtype=np.uint8), n)
    else:  # runs of equal records, lengths 1 to 40
        rec = rng.integers(0, 4, (max(n, 1), width), dtype=np.uint8)
        runs = np.repeat(np.arange(rec.shape[0]), rng.integers(1, 40, rec.shape[0]))[:n]
        raw = rec[runs].reshape(-1)
    return raw


def _pair(raw, stype, width, lengths=None):
    """The same bytes as a reference stream and as a port (CPU) stream."""
    stype = SType(int(stype))
    if stype == SType.STRING:
        ref = RefStream(raw, RefSType.STRING, 1, lengths).validate()
        return ref, Stream(torch.from_numpy(raw.copy()), SType.STRING, 1, lengths).validate()
    if stype == SType.NUMERIC:
        dt = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[width]
        ref = RefStream(raw.view(dt), RefSType.NUMERIC, width).validate()
    else:
        ref = RefStream(raw, RefSType(int(stype)), width).validate()
    return ref, from_numpy(raw, stype, width)


def _strings(items):
    raw = np.frombuffer(b"".join(items), np.uint8).copy()
    lengths = np.asarray([len(x) for x in items], np.uint32)
    return _pair(raw, SType.STRING, 1, lengths)


def _string_cases():
    rng = np.random.default_rng(7)
    return {
        "none": [],
        "one_empty": [b""],
        "seven": [b"", b"ab", b"", b"ab", b"c", b"", b"\x00"],
        "dup_rich": [WORDS[i] for i in rng.integers(0, len(WORDS), 4097)],
        "all_unique": [b"%d" % i for i in range(4097)],
        "all_empty": [b""] * 100,
    }


def _same(port_outs, ref_outs):
    assert len(port_outs) == len(ref_outs)
    for p, r in zip(port_outs, ref_outs):
        assert (int(p.stype), p.width) == (int(r.stype), r.width)
        assert p.content_bytes() == r.content_bytes()
        if r.stype == RefSType.STRING:
            assert np.array_equal(p.lengths, r.lengths) and p.lengths.dtype == np.uint32


def _same_stream(port, ref):
    _same([port], [ref])


def _codec_name(codec_id):
    return codec_registry.get_codec_by_id(codec_id).name


def _params(codec, s: RefStream):
    if codec == "split_n":
        return {"sizes": [s.n_elts // 3, -1]}
    if codec == "field_split":
        w = s.width if s.stype == RefSType.STRUCT else 3
        return {"widths": {1: [1], 3: [1, 2], 6: [2, 4], 28: [8, 8, 2, 2, 4, 4]}[w]}
    return {}


def _check_codec(codec, ref_s, s, params, inputs=None):
    """Encode with both packages (or both refuse), then decode the port's
    outputs back to the input on the CPU."""
    ref_ins, ins = inputs or ([ref_s], [s])
    spec, ref = get_codec(codec), ref_get_codec(codec)
    try:
        ref_outs, ref_header = ref.run_encode(ref_ins, params)
    except ValueError:
        with pytest.raises(ValueError):
            spec.run_encode(ins, params)
        return False
    outs, header = spec.run_encode(ins, params)
    assert header == ref_header
    _same(outs, ref_outs)
    back = spec.run_decode(outs, header, "cpu")
    assert len(back) == len(ins)
    for b, r in zip(back, ref_ins):
        assert b.data.device.type == "cpu"
        _same_stream(b, r)
    return True


# ------------------------------------------------------------------- codecs
@pytest.mark.parametrize("codec", FIXED_CODECS)
@pytest.mark.parametrize("stype,width", FIXED_TYPES, ids=_ids(FIXED_TYPES))
def test_codec_matches_reference_on_fixed_width_streams(codec, stype, width):
    encoded = 0
    for n in SIZES:
        for k, kind in enumerate(KINDS):
            ref_s, s = _pair(_fixed(stype, width, n, kind, 31 * n + k), stype, width)
            params = _params(codec, ref_s)
            inputs = None
            if codec == "concat":  # two inputs of one type, then one
                ref_b, b = _pair(_fixed(stype, width, n // 2 + 1, kind, n + 5), stype, width)
                inputs = ([ref_s, ref_b], [s, b])
                encoded += _check_codec(codec, ref_s, s, params)
            encoded += _check_codec(codec, ref_s, s, params, inputs)
    if codec == "string_split" or (codec == "field_split" and stype == SType.NUMERIC) or (
        codec == "transpose_split" and stype == SType.SERIAL
    ):
        assert encoded == 0  # refused throughout, as in the reference
    else:
        assert encoded > 0


@pytest.mark.parametrize("case", sorted(_string_cases()))
@pytest.mark.parametrize("codec", ("dup", "concat", "string_split", "tokenize", "constant",
                                   "split_n", "rle", "transpose_split", "field_split"))
def test_codec_matches_reference_on_string_streams(codec, case):
    items = _string_cases()[case]
    ref_s, s = _strings(items)
    params = {"split_n": {"sizes": [1, -1]}, "field_split": {"widths": [1]}}.get(codec, {})
    inputs = None
    if codec == "concat":
        ref_b, b = _strings(items[::-1] + [b"tail"])
        inputs = ([ref_s, ref_b, ref_s], [s, b, s])
    encoded = _check_codec(codec, ref_s, s, params, inputs)
    # a STRING stream reaching a fixed-width codec is refused with ValueError
    assert encoded == (codec in ("dup", "concat", "string_split", "tokenize"))


def test_transpose_split_matches_the_reference_device_twin():
    twin = get_backend_codec("device", "transpose_split")
    for stype, width in ((SType.NUMERIC, 8), (SType.NUMERIC, 2), (SType.STRUCT, 3)):
        ref_s, s = _pair(_fixed(stype, width, 4097, "random", width), stype, width)
        assert twin.applies([ref_s], {})
        twin_outs, twin_header = twin.encode([ref_s], {})
        outs, header = get_codec("transpose_split").run_encode([s], {})
        assert header == twin_header
        _same(outs, twin_outs)


def test_transpose_split_outputs_are_the_rows_of_one_shuffle():
    _ref_s, s = _pair(_fixed(SType.NUMERIC, 8, 1000, "random", 1), SType.NUMERIC, 8)
    outs, _h = get_codec("transpose_split").run_encode([s], {})
    base = outs[0].data.untyped_storage().data_ptr()
    for j, o in enumerate(outs):  # no copy past K3's (w, n) result
        assert o.data.is_contiguous()
        assert o.data.untyped_storage().data_ptr() == base
        assert o.data.storage_offset() == j * 1000


def test_field_split_columns_are_contiguous_copies_from_an_odd_offset():
    raw = np.random.default_rng(3).integers(0, 256, 28 + 28 * 50, dtype=np.uint8)
    body = from_numpy(raw, SType.SERIAL, 1)
    view = Stream(body.data[28:], SType.SERIAL, 1)  # split_n's body: a view at byte 28
    outs, _h = get_codec("field_split").run_encode([view], {"widths": [8, 8, 2, 2, 4, 4]})
    for o in outs:
        assert o.data.is_contiguous() and o.data.storage_offset() == 0
        assert o.data.untyped_storage().data_ptr() != body.data.untyped_storage().data_ptr()
    rec = raw[28:].reshape(50, 28)
    assert outs[2].content_bytes() == rec[:, 16:18].tobytes()


@pytest.mark.parametrize("case", (
    "constant_not_constant", "split_n_bad_sizes", "split_n_negative", "concat_mixed",
    "concat_none", "field_split_ragged", "field_split_wrong_widths", "field_split_numeric",
    "string_split_serial", "transpose_split_serial",
))
def test_refuses_where_the_reference_refuses(case):
    ref_s, s = _pair(np.arange(10, dtype=np.uint8), SType.SERIAL, 1)
    ref_n, n = _pair(np.arange(12, dtype=np.uint8), SType.NUMERIC, 4)
    codec, ins, ref_ins, params = {
        "constant_not_constant": ("constant", [s], [ref_s], {}),
        "split_n_bad_sizes": ("split_n", [s], [ref_s], {"sizes": [3, 3]}),
        "split_n_negative": ("split_n", [s], [ref_s], {"sizes": [12, -1]}),
        "concat_mixed": ("concat", [s, n], [ref_s, ref_n], {}),
        "concat_none": ("concat", [], [], {}),
        "field_split_ragged": ("field_split", [s], [ref_s], {"widths": [1, 2]}),
        "field_split_wrong_widths": ("field_split", [Stream(s.data, SType.STRUCT, 5)],
                                     [RefStream(ref_s.data, RefSType.STRUCT, 5)],
                                     {"widths": [2, 2]}),
        "field_split_numeric": ("field_split", [n], [ref_n], {"widths": [4]}),
        "string_split_serial": ("string_split", [s], [ref_s], {}),
        "transpose_split_serial": ("transpose_split", [s], [ref_s], {}),
    }[case]
    with pytest.raises(ValueError):
        ref_get_codec(codec).run_encode(ref_ins, params)
    with pytest.raises(ValueError):
        get_codec(codec).run_encode(ins, params)


def test_tokenize_orders_string_alphabet_by_first_occurrence():
    ref_s, s = _strings([b"b", b"a", b"", b"b", b"a", b"ab", b""])
    (alpha, idx), header = get_codec("tokenize").run_encode([s], {})
    assert header == b"\x01\x04"
    assert alpha.to_strings() == [b"b", b"a", b"", b"ab"]
    assert idx.numpy().tolist() == [0, 1, 2, 0, 1, 3, 2] and idx.data.dtype == torch.int32


def test_string_tokenize_fails_closed_on_an_index_past_the_alphabet():
    _ref_s, s = _strings([b"x", b"yy", b"x"])
    (alpha, idx), header = get_codec("tokenize").run_encode([s], {})
    bad = Stream(torch.tensor([0, 2, 1], dtype=torch.int32), SType.NUMERIC, 4)
    with pytest.raises(ValueError, match="past the alphabet"):
        get_codec("tokenize").run_decode([alpha, bad], header)


def test_rle_compares_records_not_carrier_values():
    # u16 values 0x0100 and 0x0001 differ; as u8 records [0, 1] and [1, 0] too
    ref_s, s = _pair(np.array([0, 1, 0, 1, 1, 0], np.uint8), SType.NUMERIC, 2)
    assert _check_codec("rle", ref_s, s, {})
    outs, _h = get_codec("rle").run_encode([s], {})
    assert outs[1].numpy().tolist() == [2, 1]


# -------------------------------------------------------- the decode device
def test_constant_decodes_onto_the_device_decompress_was_given(monkeypatch):
    spec = get_codec("constant")
    seen = []

    def spy(outs, header, device):
        seen.append(device)
        return spec.decode(outs, header, device=device)

    monkeypatch.setitem(codec_registry._BY_ID, spec.codec_id,
                        dataclasses.replace(spec, decode=spy))
    g = GraphBuilder(1)
    g.add("constant", g.input(0), n_out=0)
    frame = repro_torch.compress(g.build("c"), repro_torch.numeric(np.full(777, 42, np.uint32)),
                                 device="cpu", use_resolve_cache=False)
    (out,) = repro_torch.decompress(frame, device="cpu")
    assert seen == [torch.device("cpu")]
    assert out.data.device == torch.device("cpu") and out.data.dtype == torch.int32
    assert out.numpy().tolist() == [42] * 777


def test_a_decoder_that_wants_the_device_refuses_to_guess_it():
    spec = get_codec("constant")
    assert spec.wants_device
    _outs, header = spec.run_encode([repro_torch.numeric(np.zeros(3, np.uint8))], {})
    with pytest.raises(TypeError, match="decode device"):
        spec.run_decode([], header)
    (back,) = spec.run_decode([], header, "cpu")
    assert back.data.device.type == "cpu" and back.numpy().tolist() == [0, 0, 0]


# ------------------------------------------------------------------- frames
def _both(build):
    """One graph, built in each package: (reference plan, port plan)."""
    return build(RefGraphBuilder), build(GraphBuilder)


def _fanout(codec, n_out, select=None, **params):
    def build(GB):
        g = GB(1)
        outs = g.add(codec, g.input(0), n_out=n_out, **params)
        for o in ([outs] if isinstance(outs, int) else outs or []):
            if select:
                g.select(select, o)
        return g.build(f"unit_{codec}")
    return build


def _frames_equal(ref_plan, plan, ref_s, s, level=5, chunk_bytes=None, fv=None):
    ctx_args = (fv, level) if fv else ()
    ref_ctx = RefCtx(*ctx_args) if fv else RefCtx(level=level)
    ctx = CompressionCtx(*ctx_args) if fv else CompressionCtx(level=level)
    want = ref_compress(ref_plan, [ref_s], ctx=ref_ctx, backend="device",
                        chunk_bytes=chunk_bytes, use_resolve_cache=False)
    frame = repro_torch.compress(plan, [s], ctx, device="cpu", chunk_bytes=chunk_bytes, use_resolve_cache=False)
    assert frame == want
    (back,) = repro_torch.decompress(frame, device="cpu")
    assert back.data.device.type == "cpu"
    _same_stream(back, ref_s)
    (ref_back,) = ref_decompress(frame)
    _same_stream(back, ref_back)
    return frame


FRAME_CASES = {
    "dup": (_fanout("dup", 2, "entropy_auto"), SType.SERIAL, 1),
    "constant": (_fanout("constant", 0), SType.NUMERIC, 4),
    "split_n": (_fanout("split_n", 3, "numeric_auto", sizes=[5, 100, -1]), SType.NUMERIC, 2),
    "field_split": (_fanout("field_split", 3, "generic_auto", widths=[1, 2, 3]), SType.STRUCT, 6),
    "rle": (_fanout("rle", 2, "generic_auto"), SType.NUMERIC, 8),
    "transpose_split": (_fanout("transpose_split", 4, "entropy_auto"), SType.NUMERIC, 4),
    "transpose_split_struct": (_fanout("transpose_split", 3, "entropy_auto"), SType.STRUCT, 3),
}


@pytest.mark.parametrize("name,kind", [
    (name, kind) for name in sorted(FRAME_CASES) for kind in ("constant", "runs")
    if name != "constant" or kind == "constant"
])
def test_codec_frames_match_the_reference(name, kind):
    build, stype, width = FRAME_CASES[name]
    ref_s, s = _pair(_fixed(stype, width, 3001, kind, 11), stype, width)
    _frames_equal(*_both(build), ref_s, s)


def test_concat_frame_matches_the_reference():
    def build(GB):
        g = GB(1)
        a, b = g.add("split_n", g.input(0), n_out=2, sizes=[700, -1])
        c = g.add("concat", a, b)
        g.select("bytes_auto", c)
        return g.build("unit_concat")

    ref_s, s = _pair(_fixed(SType.SERIAL, 1, 4097, "runs", 2), SType.SERIAL, 1)
    _frames_equal(*_both(build), ref_s, s)


@pytest.mark.parametrize("case", sorted(_string_cases()))
@pytest.mark.parametrize("chunk_bytes", (None, 256))
def test_generic_profile_on_strings_matches_the_reference(case, chunk_bytes):
    ref_s, s = _strings(_string_cases()[case])
    frame = _frames_equal(ref_profiles.generic_profile(), repro_torch.generic_profile(),
                          ref_s, s, chunk_bytes=chunk_bytes, fv=4)
    if chunk_bytes and ref_s.data.size > 2 * chunk_bytes:
        assert wire.is_container(frame)


def test_string_tokenize_frame_matches_the_reference():
    def build(GB):
        g = GB(1)
        alpha, idx = g.add("tokenize", g.input(0))
        g.select("generic_auto", alpha)
        g.select("numeric_auto", idx)
        return g.build("string_dict")

    for case in ("dup_rich", "all_unique", "seven"):
        ref_s, s = _strings(_string_cases()[case])
        _frames_equal(*_both(build), ref_s, s)


def test_string_sample_matches_the_reference():
    rng = np.random.default_rng(5)
    items = [b"w" * int(x) for x in rng.integers(0, 300, 2000)]
    ref_s, s = _strings(items)
    want, got = ref_sample(ref_s), _sample(s)
    _same_stream(got, want)
    assert got.data.numel() < s.data.numel()


# ---------------------------------------------------------------- profiles
@pytest.fixture(scope="module")
def sao_file():
    import chip_smoke

    return chip_smoke.make_sao(2000, 0)


def test_chip_smoke_make_sao_is_the_benchmarks_recipe(sao_file):
    from benchmarks.datasets import make_sao

    assert sao_file == make_sao(2000, 0)


def test_sao_profile_writes_the_reference_frame(sao_file):
    raw = np.frombuffer(sao_file, np.uint8).copy()
    ref_s, s = _pair(raw, SType.SERIAL, 1)
    frame = _frames_equal(ref_profiles.sao_profile(), repro_torch.sao_profile(), ref_s, s, fv=4)
    names = [_codec_name(n.codec_id) for n in wire.read_frame(frame)[2]]
    assert names[:4] == ["split_n", "field_split", "interpret_numeric", "delta"]
    assert names.count("transpose_split") == 2 and names.count("tokenize") == 4


@pytest.mark.parametrize("widths", ([8, 8, 2, 2, 4, 4], [4, 4], [28], [3, 25]))
def test_struct_profile_writes_the_reference_frame(sao_file, widths):
    raw = np.frombuffer(sao_file[28:], np.uint8).copy()
    if sum(widths) != 28:
        raw = raw[: raw.size // sum(widths) * sum(widths)]
    ref_s, s = _pair(raw, SType.STRUCT, sum(widths))
    _frames_equal(ref_profiles.struct_profile(widths), repro_torch.struct_profile(widths),
                  ref_s, s, fv=4)


def test_profiles_are_the_reference_graphs():
    from repro.core.serialize import plan_to_dict

    for ref_plan, plan in ((ref_profiles.sao_profile(), repro_torch.sao_profile()),
                           (ref_profiles.struct_profile([4, 4]), repro_torch.struct_profile([4, 4]))):
        plan_dict = plan_to_dict(ref_plan, ref_plan.name)
        assert repro_torch.plan_from_dict(plan_dict)[0].nodes == plan.nodes
    assert repro_torch.SAO_FIELDS == ref_profiles.SAO_FIELDS
    assert repro_torch.SAO_HEADER_BYTES == ref_profiles.SAO_HEADER_BYTES


# -------------------------------------------------------------------- wire
@pytest.mark.parametrize("nbytes", (1, 2, 3, 4, 5))
def test_string_lengths_cross_the_wire_as_the_reference_writes_them(nbytes):
    lo, hi = (0 if nbytes == 1 else 1 << 7 * (nbytes - 1)), min(1 << 7 * nbytes, 1 << 32)
    rng = np.random.default_rng(nbytes)
    lens = np.concatenate([[lo, hi - 1], rng.integers(lo, hi, 300)]).astype(np.uint32)
    lens = np.concatenate([lens, rng.integers(0, 200, 300).astype(np.uint32)])
    out = bytearray()
    for ln in lens.tolist():
        ref_wire.write_varint(out, ln)
    assert wire.write_varints(lens) == bytes(out)
    back, pos = wire.read_string_lengths(bytes(out) + b"\x81\x01", 0, len(out) + 2, lens.size)
    assert pos == len(out) and back.dtype == np.uint32 and np.array_equal(back, lens)


def test_stored_string_stream_frame_matches_the_reference():
    items = [b"a" * 3, b"", b"b" * 200, b"c" * 20000, b"", b"d"]
    ref_s, s = _strings(items)
    frame = _frames_equal(ref_pipeline("store"), repro_torch.pipeline("store"), ref_s, s)
    assert ref_wire.read_frame(frame)[3][1].lengths.tolist() == [len(x) for x in items]


def _frame_with_lengths(length_bytes: bytes, n_str: int, payload: bytes) -> bytes:
    """A one-node-free frame storing one STRING stream, CRC recomputed."""
    body = bytearray(b"OZLJ\x01")
    body += b"\x01\x00\x01\x00\x03\x01"  # 1 input, 0 nodes, 1 stored: edge 0, STRING, width 1
    ref_wire.write_varint(body, n_str)
    body += length_bytes
    ref_wire.write_varint(body, len(payload))
    body += payload
    return bytes(body) + pystruct.pack("<I", zlib.crc32(bytes(body)) & 0xFFFFFFFF)


def test_a_hand_made_string_frame_reads_in_both_packages():
    frame = _frame_with_lengths(b"\x02\x80\x01\x00", 3, b"ab" + b"z" * 128)
    (out,) = repro_torch.decompress(frame, device="cpu")
    (ref_out,) = ref_decompress(frame)
    _same_stream(out, ref_out)


@pytest.mark.parametrize("case", ("truncated", "too_many", "overlong", "past_u32"))
def test_malformed_string_lengths_fail_closed(case):
    length_bytes, n_str = {
        "truncated": (b"\x02\x80", 2),          # the second varint runs into the payload length
        "too_many": (b"\x01\x01", 5000),        # far more strings than bytes left
        "overlong": (b"\x80" * 11 + b"\x00", 1),
        "past_u32": (b"\x80\x80\x80\x80\x10", 1),  # 2^32
    }[case]
    frame = _frame_with_lengths(length_bytes, n_str, b"ab")
    with pytest.raises(wire.FrameError):
        repro_torch.decompress(frame, device="cpu")
    with pytest.raises(Exception):
        ref_decompress(frame)
