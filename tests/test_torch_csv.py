"""The CSV frontend: the port against the reference.

``csv_split`` and ``parse_numeric`` encode to the reference's output streams
and headers (``run_encode`` against ``repro.core.codec.get_codec``) over
each exactness trap of a byte-exact split and parse (CRLF, lone carriage
returns, separators with a border, multi-byte separators, empty fields and
lines, no trailing newline, every int64 boundary, 19- to 21-byte digit
strings), refuse where the reference refuses, and decode back to their
input; each package decodes the other's streams.  Whole frames of
``csv_profile`` at levels 1-9 on small census files and on chip_smoke's
edge corpus equal ``repro.core.compress(..., backend="device",
use_resolve_cache=False)``.  chip_smoke's census recipes are
``benchmarks/datasets.py``'s, byte for byte.  All on the CPU, tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import repro_torch  # noqa: E402
from repro.codecs import profiles as ref_profiles  # noqa: E402
from repro.codecs.parse import _canonical_int  # noqa: E402
from repro.core import CompressionCtx as RefCtx  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro_torch import CompressionCtx  # noqa: E402
from repro_torch.codecs import parse  # noqa: E402
from repro_torch.core.codec import get_codec  # noqa: E402
from repro_torch.core.message import Stream, SType, serial  # noqa: E402

# (file, separator): every trap of the split; the refused ones included
SPLIT_TRAPS = {
    "empty": (b"", ","),
    "one_newline": (b"\n", ","),
    "two_newlines": (b"\n\n", ","),
    "three_newlines": (b"\n\n\n", ","),
    "no_trailing_newline": (b"a,b\nc,d", ","),
    "one_field": (b"x", ","),
    "crlf": (b"a,b\r\nc,d\r\n", ","),
    "crlf_empty_lines": (b"\r\n\r\n", ","),
    "crlf_one_line": (b"\r\n", ","),
    "crlf_lone_cr_in_field": (b"a\rb,c\r\nd,\re\r\n", ","),
    "crlf_last_line_without_newline": (b"a,b\r\nc,d\r", ","),
    "crlf_one_line_without_cr": (b"a,b\r\nc,d\n", ","),
    "cr_first_line_only": (b"a,b\r\nc,d\n", ","),
    "colons": (b":::::\n1::2:::3\n::::\n::7::\n", "::"),
    "colons_ragged": (b":::::\n::::::\n", "::"),
    "aba": (b"ababa\n1aba2\n-7aba\nabab\n", "aba"),
    "aba_runs": (b"abababa\nxabaabay\n", "aba"),
    "aaa": (b"aaaaaaa\naaaaaab\nxaayaazaa\n", "aa"),
    "pipes": (b"a||b|||c\n||||\n", "||"),
    "section_sign": ("1§2\n-3§x\n§\n".encode(), "§"),
    "comma_space": (b"a, b\n, \n", ", "),
    "int_separator": (b"1;2\n3;4\n", 59),
    "bytes_separator": (b"1\t2\n3\t4\n", b"\t"),
    "empty_fields": (b",,\n1,,2\n,,\n", ","),
    "ragged": (b"a,b\nc\n", ","),
    "nul_bytes": (b"\x00,\xff\n\x80,\x00\n", ","),
}
BAD_SEPARATORS = ("", "\n", "\r", "a\rb", b"", b"\n,", 10)
# parse_numeric's boundary corpus: chip_smoke's and more
INT_CORPUS = chip_smoke.INT64_EDGES + (
    b"1", b"9", b"10", b"-1", b"-9", b"-10", b"007", b"-007", b"0x10", b"1e5", b"1.0",
    b"\xef\xbc\x91", b"9" * 19, b"-" + b"9" * 18, b"-" + b"9" * 19, b"1" + b"0" * 18,
    b"-1" + b"0" * 18, b"922337203685477580", b"9223372036854775806",
    b"-9223372036854775807", b"-9223372036854775810", b"09223372036854775807",
    b"--1", b"1-", b"-a", b"a" * 25, b" ", b"\t1",
)


def _ref_serial(raw: bytes):
    return RefStream(np.frombuffer(raw, np.uint8).copy(), RefSType.SERIAL, 1)


def _strings(items):
    raw = np.frombuffer(b"".join(items), np.uint8).copy()
    lengths = np.asarray([len(x) for x in items], np.uint32)
    ref = RefStream(raw, RefSType.STRING, 1, lengths).validate()
    return ref, Stream(torch.from_numpy(raw.copy()), SType.STRING, 1, lengths).validate()


def _to_ref(s: Stream) -> RefStream:
    """A port stream as a reference stream (the reference's unsigned view)."""
    arr = s.numpy()
    return RefStream(arr, RefSType(int(s.stype)), s.width, s.lengths).validate()


def _same(port_outs, ref_outs):
    assert len(port_outs) == len(ref_outs)
    for p, r in zip(port_outs, ref_outs):
        assert (int(p.stype), p.width) == (int(r.stype), r.width)
        assert p.content_bytes() == r.data.tobytes()
        if r.stype == RefSType.STRING:
            assert np.array_equal(p.lengths, r.lengths) and p.lengths.dtype == np.uint32


def _check(codec, ref_ins, ins, params):
    """Encode with both packages (or both refuse), then decode: the port's
    streams by the port and by the reference, the reference's by the port.
    Returns the port's outputs, or None where both refused."""
    spec, ref = get_codec(codec), ref_get_codec(codec)
    try:
        ref_outs, ref_header = ref.run_encode(ref_ins, params)
    except ValueError:
        with pytest.raises(ValueError):
            spec.run_encode(ins, params)
        return None
    outs, header = spec.run_encode(ins, params)
    assert header == ref_header
    _same(outs, ref_outs)
    back = spec.run_decode(outs, header, "cpu")
    _same(back, ref_ins)
    assert all(b.data.device.type == "cpu" for b in back)
    _same(ref.run_decode([_to_ref(o) for o in outs], header), ref_ins)
    ported_ref_outs = []
    for o in ref_outs:  # the reference's streams as the port's, byte for byte
        t = torch.tensor(list(o.data.tobytes()), dtype=torch.uint8)
        if o.stype == RefSType.NUMERIC:
            t = t.view({1: torch.uint8, 8: torch.int64}[o.width])
        ported_ref_outs.append(Stream(t, SType(int(o.stype)), o.width, o.lengths))
    _same(spec.run_decode(ported_ref_outs, header, "cpu"), ref_ins)
    return outs


def _split(raw: bytes, sep):
    return _check("csv_split", [_ref_serial(raw)], [serial(raw)], {"sep": sep})


def _parse(items):
    ref_s, s = _strings(items)
    return _check("parse_numeric", [ref_s], [s], {})


# --------------------------------------------------------------- csv_split
@pytest.mark.parametrize("name", sorted(SPLIT_TRAPS))
def test_csv_split_matches_the_reference_on_each_trap(name):
    raw, sep = SPLIT_TRAPS[name]
    outs = _split(raw, sep)
    refused = name in ("empty", "one_newline", "colons_ragged", "ragged")
    assert (outs is None) == refused


def test_csv_split_takes_crlf_only_when_every_line_ends_in_cr():
    spec = get_codec("csv_split")
    for raw, crlf in ((b"a\r\nb\r\n", True), (b"a\r\nb\r", False), (b"a\r\nb\n", False),
                      (b"\r\n", True), (b"a\rb\n", False)):
        _outs, header = spec.run_encode([serial(raw)], {"sep": ","})
        assert (header[4:5] == b"\x01") == crlf


@pytest.mark.parametrize("sep", BAD_SEPARATORS)
def test_csv_split_refuses_a_bad_separator(sep):
    assert _split(b"a,b\n", sep) is None


def test_csv_split_refuses_a_string_stream():
    ref_s, s = _strings([b"a,b"])
    assert _check("csv_split", [ref_s], [s], {"sep": ","}) is None


@pytest.mark.parametrize("sep", (b"aba", b"aa", b"abab", b"::", b"aab", b"aaa"))
def test_separator_matches_are_pythons_left_to_right_matches(sep):
    rng = np.random.default_rng(len(sep))
    for n in (0, 1, 2, 5, 64, 3001):
        for alphabet in (b"ab", b"a", b":a"):
            body = bytes(rng.choice(list(alphabet), n).astype(np.uint8))
            want, pos = [], body.find(sep)
            while pos >= 0:
                want.append(pos)
                pos = body.find(sep, pos + len(sep))
            got = parse._separators(torch.tensor(list(body), dtype=torch.uint8), sep)
            assert got.tolist() == want


def _random_csv(rng, n_cols, n_rows, sep: bytes, eol: bytes) -> bytes:
    """Rectangular rows of random fields: ints of every shape, words and
    empty fields, over bytes that hold no separator byte."""
    pool = [b"", b"0", b"-0", b"007", b"12", b"-5", b"9223372036854775807",
            b"-9223372036854775808", b"9223372036854775808", b"abc", b"1e3", b" 7", b"\r"]
    banned = set(sep)
    pool = [f for f in pool if not banned & set(f)]
    rows = []
    for _ in range(n_rows):
        fields = []
        for _c in range(n_cols):
            if rng.random() < 0.5:
                fields.append(b"%d" % int(rng.integers(-10**6, 10**6)))
            else:
                fields.append(pool[int(rng.integers(len(pool)))])
        rows.append(sep.join(fields))
    return eol.join(rows) + (eol if n_rows % 3 else b"")


@pytest.mark.parametrize("n_cols", range(1, 10))
def test_csv_split_matches_the_reference_on_random_files(n_cols):
    rng = np.random.default_rng(n_cols)
    for n_rows, sep, eol in ((0, b",", b"\n"), (1, b",", b"\n"), (2, b"::", b"\r\n"),
                             (37, b"aba", b"\n"), (500, b"\t", b"\r\n"),
                             (5000, b",", b"\n")):
        raw = _random_csv(rng, n_cols, n_rows, sep, eol)
        outs = _split(raw, sep)
        if n_rows == 0:
            assert outs is None
        else:
            assert len(outs) == n_cols and all(o.n_elts == n_rows for o in outs)


def test_csv_split_decode_fails_closed():
    spec = get_codec("csv_split")
    outs, header = spec.run_encode([serial(b"1,2\n3,4\n")], {"sep": ","})
    for bad in (outs[:1], outs + outs[:1], [outs[0], Stream(outs[1].data, SType.SERIAL, 1)]):
        with pytest.raises(ValueError):
            spec.run_decode(bad, header, "cpu")
    short = repro_torch.strings([b"1"])
    with pytest.raises(ValueError):
        spec.run_decode([outs[0], short], header, "cpu")
    with pytest.raises(ValueError):
        spec.run_decode(outs, header + b"\x00\x00", "cpu")  # a byte past the flags


def test_csv_split_decodes_a_header_of_no_rows_as_the_reference_does():
    spec, ref = get_codec("csv_split"), ref_get_codec("csv_split")
    for trailing in (0, 1):
        header = bytes([ord(","), trailing, 1, 0])
        (want,) = ref.run_decode([RefStream(np.zeros(0, np.uint8), RefSType.STRING, 1,
                                            np.zeros(0, np.uint32))], header)
        (got,) = spec.run_decode([repro_torch.strings([])], header, "cpu")
        assert got.content_bytes() == want.data.tobytes()


# ----------------------------------------------------------- parse_numeric
def test_parse_numeric_matches_the_reference_on_the_boundary_corpus():
    outs = _parse(list(INT_CORPUS))
    assert outs[1].n_elts == sum(_canonical_int(x) is not None for x in INT_CORPUS)


@pytest.mark.parametrize("items", ([], [b""], [b"0"], [b"-"], [b"x" * 40], [b"5"] * 9),
                         ids=("none", "empty", "zero", "minus", "long", "nine"))
def test_parse_numeric_matches_the_reference_on_small_streams(items):
    _parse(items)


@pytest.mark.parametrize("seed", range(4))
def test_parse_numeric_matches_the_reference_on_random_ints_and_near_ints(seed):
    rng = np.random.default_rng(seed)
    n = 100_000
    vals = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64, endpoint=True)
    small = rng.integers(-1000, 1000, n)
    kind = rng.integers(0, 8, n)
    items = []
    for k, v, s in zip(kind.tolist(), vals.tolist(), small.tolist()):
        if k < 3:
            items.append(b"%d" % v)
        elif k == 3:
            items.append(b"%d" % s)
        elif k == 4:  # zero-padded, signed with "+", or spaced: exceptions
            items.append((b"0%d", b"+%d", b" %d", b"%d ")[s % 4] % abs(s))
        elif k == 5:  # one past int64, either way
            items.append(b"%d" % ((1 << 63) + abs(s)) if s % 2 else b"%d" % (-(1 << 63) - 1 - abs(s)))
        elif k == 6:  # 19 to 21 digits
            items.append(b"%d" % (abs(v) * 10 ** (s % 3)))
        else:
            items.append(b"")
    outs = _parse(items)
    assert 0 < outs[1].n_elts < n


def test_parse_numeric_decode_fails_closed():
    spec = get_codec("parse_numeric")
    _ref, s = _strings([b"1", b"x", b"2"])
    (bitmap, vals, exc), header = spec.run_encode([s], {})
    cases = (
        [bitmap, Stream(vals.data[:1], SType.NUMERIC, 8), exc],  # a value too few
        [bitmap, Stream(torch.cat([vals.data, vals.data]), SType.NUMERIC, 8), exc],
        [bitmap, vals, repro_torch.strings([])],  # an exception too few
        [bitmap, vals, repro_torch.strings([b"x", b"y"])],
        [Stream(bitmap.data[:0], SType.SERIAL, 1), vals, exc],  # a bitmap too short
        [bitmap, Stream(vals.data.view(torch.uint8)[:9], SType.SERIAL, 1), exc],
    )
    for outs in cases:
        with pytest.raises(ValueError):
            spec.run_decode(outs, header, "cpu")


# ---------------------------------------------------------------- frames
def _frames_equal(ref_plan, plan, raw: bytes, level=5):
    want = ref_compress(ref_plan, [_ref_serial(raw)], ctx=RefCtx(level=level),
                        backend="device", use_resolve_cache=False)
    frame = repro_torch.compress(plan, serial(raw), CompressionCtx(level=level), device="cpu", use_resolve_cache=False)
    assert frame == want
    (back,) = repro_torch.decompress(frame, device="cpu")
    assert back.content_bytes() == raw and back.stype == SType.SERIAL
    (ref_back,) = ref_decompress(frame)
    assert ref_back.data.tobytes() == raw
    return frame


@pytest.fixture(scope="module")
def census():
    return {"ppmf": (chip_smoke.make_ppmf_csv(400, 3), 8),
            "psam": (chip_smoke.make_psam_csv(300, 4), 7)}


@pytest.mark.parametrize("level", (1, 3, 5, 7, 9))
@pytest.mark.parametrize("name", ("ppmf", "psam"))
def test_csv_profile_writes_the_reference_frame(census, name, level):
    raw, n_cols = census[name]
    _frames_equal(ref_profiles.csv_profile(n_cols), repro_torch.csv_profile(n_cols), raw, level)


@pytest.mark.parametrize("level", (1, 3, 5, 7, 9))
@pytest.mark.parametrize("case", chip_smoke.CSV_EDGES, ids=[c[0] for c in chip_smoke.CSV_EDGES])
def test_csv_profile_writes_the_reference_frame_on_the_edge_corpus(case, level):
    _label, raw, n_cols, sep = case
    _frames_equal(ref_profiles.csv_profile(n_cols, sep), repro_torch.csv_profile(n_cols, sep),
                  raw, level)


def test_csv_profile_on_a_file_of_other_width_raises_as_the_reference_does():
    raw = b"1,2,3\n4,5,6\n"
    with pytest.raises(AssertionError):
        ref_compress(ref_profiles.csv_profile(2), [_ref_serial(raw)], backend="device",
                     use_resolve_cache=False)
    with pytest.raises(AssertionError):
        repro_torch.compress(repro_torch.csv_profile(2), serial(raw), device="cpu", use_resolve_cache=False)


@pytest.mark.parametrize("args", ((0,), (-1,), (2, ""), (2, "\n"), (2, "a\rb")))
def test_csv_profile_validates_as_the_reference_does(args):
    with pytest.raises(ValueError) as ref_err:
        ref_profiles.csv_profile(*args)
    with pytest.raises(ValueError) as err:
        repro_torch.csv_profile(*args)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("args", ((1,), (3,), (8, "::"), (2, "§")))
def test_csv_profile_is_the_reference_graph(args):
    ref, plan = ref_profiles.csv_profile(*args), repro_torch.csv_profile(*args)
    assert plan.name == ref.name and plan.n_inputs == ref.n_inputs
    assert [(n.kind, n.name, n.inputs, n.n_out, n.param_dict()) for n in plan.nodes] == [
        (n.kind, n.name, n.inputs, n.n_out, n.param_dict()) for n in ref.nodes
    ]


def test_csv_profile_is_exported_beside_the_other_profiles():
    assert repro_torch.csv_profile is repro_torch.codecs.csv_profile


# ------------------------------------------------------ chip_smoke's data
@pytest.mark.parametrize("rows_seed", ((None, None), (1000, 7), (1, 0)))
def test_chip_smoke_census_recipes_are_the_benchmarks_recipes(rows_seed):
    from benchmarks import datasets

    n_rows, seed = rows_seed
    args = () if n_rows is None else (n_rows, seed)
    assert chip_smoke.make_ppmf_csv(*args) == datasets.make_ppmf_csv(*args)
    assert chip_smoke.make_psam_csv(*args) == datasets.make_psam_csv(*args)
