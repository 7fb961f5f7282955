"""The graph frontend and the profile-spec catalogue: the port against the
reference.

``edge_list``, ``edge_list_bin`` and ``adj_gap`` encode to the reference's
output streams and headers (``run_encode`` against
``repro.core.codec.get_codec``) over each trap of the u64 arithmetic and the
text parse (ids at and above 2^63, negative ids, ``-0``, leading zeros, CRLF,
two separators on a line, ties under ``auto``, separators ``"::"`` and
``"\\r"``, unsorted, duplicate and decreasing lists, a hub, a chain of
reference runs), refuse where the reference refuses, and decode back to
their input; each package decodes the other's streams, and each decoder
fails closed on malformed streams.  ``adj_gap``'s reference choice (refs,
copy bits, gaps) equals the reference's on random graphs of 0-20,000 edges
at windows 0, 1, 3 and 8.  Whole frames of ``graph_profile()`` and
``graph_bin_profile(2/4/8)`` at levels 1-9 and of chip_smoke's edge corpus
equal ``repro.core.compress(..., backend="device", use_resolve_cache=False)``.
``named_profiles`` and ``resolve_profile_spec`` give the reference's plans
and messages.  chip_smoke's edge recipe is ``benchmarks/engine_bench.py``'s,
byte for byte.  All on the CPU, tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import repro_torch  # noqa: E402
from repro.codecs import graph as ref_graph  # noqa: E402
from repro.codecs import profiles as ref_profiles  # noqa: E402
from repro.core import CompressionCtx as RefCtx  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core.engine import resolve_cache_clear  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro_torch import CompressionCtx  # noqa: E402
from repro_torch.codecs import graph  # noqa: E402
from repro_torch.core.codec import get_codec  # noqa: E402
from repro_torch.core.message import Stream, SType, from_numpy, serial  # noqa: E402

UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
TOP = 1 << 63
# every u64 boundary of zigzag, varint length and unsigned order
U64_EDGES = [0, 1, 2, 3, 126, 127, 128, 129, 255, 256, 16383, 16384] + [
    v for k in range(3, 10) for v in ((1 << (7 * k)) - 1, 1 << (7 * k))
] + [TOP - 2, TOP - 1, TOP, TOP + 1, (1 << 64) - 2, (1 << 64) - 1]

# (file, separator): the text parse's traps, each under one separator
EDGE_TRAPS = {
    "empty": (b"", "auto"),
    "newline": (b"\n", "auto"),
    "two_newlines": (b"\n\n", "auto"),
    "one_edge_no_newline": (b"1\t2", "auto"),
    "crlf": (b"1\t2\r\n3\t4\r\n", "auto"),
    "crlf_tab": (b"1\t2\r\n3\t4\r\n", "\t"),
    "cr_separator": (b"1\r2\n3\r4\r\n5\r\r6\n", "\r"),
    "cr_separator_bytes": (b"1\r2\n3\r4\n", b"\r"),
    "colons": (b"1::2\n3:::4\n5::::6\n::\n7::8::9\n", "::"),
    "aba": (b"1aba2\n3ababa4\n5abaaba6\n", "aba"),
    "bytes_separator": (b"1\t2\n3\t4\n", b"\t"),
    "int_separator": (b"1\x00\x002\n3\x004\n", 2),  # bytes(2): two NUL bytes
    "two_separators": (b"1\t2\t3\n1 2 3\n4\t5\n1\t\t2\n", "auto"),
    "tab_space_tie": (b"1\t2\n3 4\n", "auto"),
    "space_wins": (b"1 2\n3 4\n5\t6\n", "auto"),
    "comma_and_semicolon": (b"1,2\n3;4\n5;6\n", "auto"),
    "negatives": (b"-1\t-2\n-9223372036854775808\t9223372036854775807\n", "auto"),
    "not_canonical": (b"-0\t1\n01\t2\n+1\t2\n1\t2 \n 1\t2\n1e3\t2\n\t1\n1\t\n", "\t"),
    "out_of_range": (b"9223372036854775808\t1\n1\t-9223372036854775809\n"
                     b"18446744073709551615\t1\n", "\t"),
    "comments": (b"# FromNodeId\tToNodeId\n#\n1\t2\n", "auto"),
    "utf8_separator": ("1§2\n3§4\n".encode(), "§"),
    "separator_in_ids": (b"1121\n313\n", "1"),
    "nul_bytes": (b"\x00\t\xff\n1\t2\n", "auto"),
}
BAD_SEPARATORS = ("", "\n", "a\nb", b"", b"\n\t", 0)
# chip_smoke's text corpus
CORPUS_TEXT = [c for c in chip_smoke.GRAPH_EDGES if not str(c[2]).startswith("graph:bin")]


def _ref_serial(raw: bytes):
    return RefStream(np.frombuffer(raw, np.uint8).copy(), RefSType.SERIAL, 1)


def _to_ref(s: Stream) -> RefStream:
    """A port stream as a reference stream (the reference's unsigned view)."""
    return RefStream(s.numpy(), RefSType(int(s.stype)), s.width, s.lengths).validate()


def _from_ref(o: RefStream) -> Stream:
    """A reference stream as the port's, byte for byte."""
    if o.stype == RefSType.STRING:
        return Stream(torch.from_numpy(o.data.copy()), SType.STRING, 1, o.lengths).validate()
    return from_numpy(o.data, SType(int(o.stype)), o.width)


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
    Returns the port's outputs and header, or None where both refused."""
    spec, ref = get_codec(codec), ref_get_codec(codec)
    try:
        ref_outs, ref_header = ref.run_encode(ref_ins, params)
    except ValueError as err:
        with pytest.raises(ValueError) as port_err:
            spec.run_encode(ins, params)
        assert str(port_err.value) == str(err)
        return None
    outs, header = spec.run_encode(ins, params)
    assert header == ref_header
    _same(outs, ref_outs)
    back = spec.run_decode(outs, header)
    _same(back, ref_ins)
    assert all(b.data.device.type == "cpu" for b in back)
    _same(ref.run_decode([_to_ref(o) for o in outs], header), ref_ins)
    _same(spec.run_decode([_from_ref(o) for o in ref_outs], header), ref_ins)
    return outs, header


def _edge_list(raw: bytes, sep):
    return _check("edge_list", [_ref_serial(raw)], [serial(raw)], {"sep": sep})


def _columns(src: np.ndarray, dst: np.ndarray, width: int):
    ref = [RefStream(x.astype(UNSIGNED[width]), RefSType.NUMERIC, width) for x in (src, dst)]
    return ref, [_from_ref(s) for s in ref]


def _adj_gap(src, dst, width: int, window: int):
    ref_ins, ins = _columns(src, dst, width)
    return _check("adj_gap", ref_ins, ins, {"window": window})


# ------------------------------------------------------------------ helpers
def test_u64_helpers_match_the_reference_at_every_boundary():
    rng = np.random.default_rng(0)
    vals = np.concatenate([np.array(U64_EDGES, np.uint64),
                           rng.integers(0, 1 << 64, 5000, dtype=np.uint64, endpoint=False)])
    t = torch.from_numpy(vals.view(np.int64).copy())
    zz = graph._zigzag_u64(t)
    assert np.array_equal(zz.numpy().view(np.uint64), ref_graph._zigzag_u64(vals))
    assert np.array_equal(graph._unzigzag_u64(t).numpy().view(np.uint64),
                          ref_graph._unzigzag_u64(vals))
    assert np.array_equal(graph._unzigzag_u64(zz).numpy(), t.numpy())
    assert np.array_equal(graph._varint_lens(t).numpy(), ref_graph._varint_lens(vals))
    a, b = t[:, None], t[None, :100]
    assert np.array_equal(graph._u64_gt(a, b).numpy(), vals[:, None] > vals[None, :100])


# ----------------------------------------------------------------- edge_list
@pytest.mark.parametrize("name", sorted(EDGE_TRAPS))
def test_edge_list_matches_the_reference_on_each_trap(name):
    raw, sep = EDGE_TRAPS[name]
    assert _edge_list(raw, sep) is not None


@pytest.mark.parametrize("sep", ("auto", "\t", " ", ",", "::", "\r", b"\t"))
@pytest.mark.parametrize("case", CORPUS_TEXT, ids=[c[0] for c in CORPUS_TEXT])
def test_edge_list_matches_the_reference_on_the_corpus(case, sep):
    assert _edge_list(case[1], sep) is not None


@pytest.mark.parametrize("sep", BAD_SEPARATORS)
def test_edge_list_refuses_a_bad_separator(sep):
    assert _edge_list(b"1\t2\n", sep) is None


def test_edge_list_refuses_a_numeric_stream():
    ref_ins, ins = _columns(np.arange(4), np.arange(4), 1)
    assert _check("edge_list", ref_ins[:1], ins[:1], {}) is None


@pytest.mark.parametrize("raw, sep", (
    (b"1\t2\n3 4\n", b"\t"),  # a tie: the earlier candidate
    (b"1 2\n3 4\n5\t6\n", b" "),
    (b"1,2\n3;4\n5;6\n", b";"),
    (b"x\ny\n", b"\t"),  # no edges at all
))
def test_auto_keeps_the_first_separator_that_parses_the_most_edges(raw, sep):
    _outs, header = _edge_list(raw, "auto")
    assert header.endswith(bytes([len(sep)]) + sep)


def _random_edge_file(rng, n_lines: int, sep: bytes, eol: bytes) -> bytes:
    """Edge lines of ids of every shape, with comments, blank lines and
    lines of other shapes among them."""
    pool = [b"-0", b"007", b"+5", b"9223372036854775808", b"-9223372036854775808",
            b"x", b"", b" 1", b"1.5"]
    lines = []
    for _ in range(n_lines):
        kind = rng.random()
        u = b"%d" % int(rng.integers(-(1 << 63), 1 << 63, dtype=np.int64))
        v = b"%d" % int(rng.integers(-1000, 1 << 40))
        if kind < 0.05:
            lines.append(b"# comment " + u)
        elif kind < 0.08:
            lines.append(b"")
        elif kind < 0.12:
            lines.append(u + sep + v + sep + v)
        elif kind < 0.18:
            lines.append(pool[int(rng.integers(len(pool)))] + sep + v)
        else:
            lines.append(u + sep + v)
    return eol.join(lines) + (eol if n_lines % 3 else b"")


@pytest.mark.parametrize("seed", range(6))
def test_edge_list_matches_the_reference_on_random_files(seed):
    rng = np.random.default_rng(seed)
    sep = (b"\t", b" ", b",", b";", b"::", b"\r")[seed]
    for n_lines, eol in ((1, b"\n"), (40, b"\r\n"), (3000, b"\n")):
        raw = _random_edge_file(rng, n_lines, sep, eol)
        for param in ("auto", sep):
            outs, _header = _edge_list(raw, param)
            assert outs[2].n_elts == (n_lines + 7) // 8


def _ref_raises(codec, outs, header):
    with pytest.raises(Exception):
        ref_get_codec(codec).run_decode([_to_ref(o) for o in outs], header)


def test_edge_list_decode_fails_closed():
    spec = get_codec("edge_list")
    outs, header = spec.run_encode([serial(b"1\t2\nx\n3\t4\n")], {"sep": "\t"})
    src, dst, bitmap, exc = outs
    cases = (
        [Stream(src.data[:1], SType.NUMERIC, 8), dst, bitmap, exc],  # a value too few
        [src, Stream(torch.cat([dst.data, dst.data]), SType.NUMERIC, 8), bitmap, exc],
        [src, dst, bitmap, repro_torch.strings([])],  # an exception too few
        [src, dst, Stream(bitmap.data[:0], SType.SERIAL, 1), exc],  # no bitmap
        [src, dst, Stream(torch.tensor([0b11100000], dtype=torch.uint8), SType.SERIAL, 1), exc],
    )
    for bad in cases:
        _ref_raises("edge_list", bad, header)
        with pytest.raises(ValueError):
            spec.run_decode(bad, header)
    with pytest.raises(ValueError):
        spec.run_decode(outs, header + b"\x00")


def test_edge_list_decode_refuses_surplus_exceptions_the_reference_ignores():
    """A difference by design (ROADMAP §3): the reference reads as many
    exception lines as the bitmap asks for and ignores the rest."""
    spec = get_codec("edge_list")
    outs, header = spec.run_encode([serial(b"1\t2\nx\n")], {"sep": "\t"})
    bad = outs[:3] + [repro_torch.strings([b"x", b"y"])]
    (want,) = ref_get_codec("edge_list").run_decode([_to_ref(o) for o in bad], header)
    assert want.data.tobytes() == b"1\t2\nx\n"
    with pytest.raises(ValueError):
        spec.run_decode(bad, header)


# ------------------------------------------------------------- edge_list_bin
@pytest.mark.parametrize("width", (2, 4, 8))
def test_edge_list_bin_matches_the_reference(width):
    rng = np.random.default_rng(width)
    top = 1 << (8 * width - 1)
    for n in (0, 1, 7, 4097):
        ids = (rng.integers(0, 100, 2 * n).astype(np.uint64) + np.uint64(top - 50)).astype(
            UNSIGNED[width])
        ids[::5] = (1 << (8 * width)) - 1
        raw = ids.tobytes()
        outs, _header = _check("edge_list_bin", [_ref_serial(raw)], [serial(raw)],
                               {"width": width})
        assert outs[0].n_elts == n
    # from a view at an odd byte offset of a larger tensor
    raw = bytes(range(1, 1 + 8 * width))
    view = serial(b"\x00" + raw).data[1:]
    outs, _h = get_codec("edge_list_bin").run_encode([Stream(view, SType.SERIAL, 1)],
                                                    {"width": width})
    ref_outs, _h = ref_get_codec("edge_list_bin").run_encode([_ref_serial(raw)],
                                                            {"width": width})
    _same(outs, ref_outs)


@pytest.mark.parametrize("raw, params", (
    (bytes(12), {"width": 3}),
    (bytes(12), {"width": 1}),
    (bytes(12), {"width": 8}),  # 12 bytes is not a whole (u, v) pair of u64s
    (bytes(3), {}),
))
def test_edge_list_bin_refuses_as_the_reference_does(raw, params):
    assert _check("edge_list_bin", [_ref_serial(raw)], [serial(raw)], params) is None


def test_edge_list_bin_decode_fails_closed():
    spec = get_codec("edge_list_bin")
    raw = np.arange(8, dtype=np.uint32).tobytes()
    (src, dst), header = spec.run_encode([serial(raw)], {"width": 4})
    for bad in ([src, Stream(dst.data[:3], SType.NUMERIC, 4)],
                [src, Stream(dst.data.view(torch.int16), SType.NUMERIC, 2)]):
        _ref_raises("edge_list_bin", bad, header)
        with pytest.raises(ValueError):
            spec.run_decode(bad, header)


# -------------------------------------------------------------------- adj_gap
def _random_graph(rng, n: int, width: int, kind: str):
    """(src, dst) of ``n`` edges with ids in the upper half of ``width``:
    sorted, duplicate-free lists drawn from a few shared pools (so that
    lists overlap), or unsorted lists with duplicates."""
    top = 1 << (8 * width - 1)
    n_nodes = max(n // 12, 1)
    base = top - 40 if width < 8 else TOP - 40
    src = np.sort(rng.integers(0, n_nodes, n)) + base
    pool = rng.integers(0, 4 * n_nodes + 64, 60)
    dst = np.where(rng.random(n) < 0.7, pool[rng.integers(0, 60, n)],
                   rng.integers(0, 4 * n_nodes + 64, n)) + base
    src, dst = src.astype(np.uint64), dst.astype(np.uint64)
    if kind == "sorted":
        pairs = np.unique(np.stack([src, dst], 1), axis=0)
        src, dst = pairs[:, 0].copy(), pairs[:, 1].copy()
    return src, dst


@pytest.mark.parametrize("width", (2, 4, 8))
@pytest.mark.parametrize("window", (0, 1, 3, 8))
def test_adj_gap_matches_the_reference_on_random_graphs(window, width):
    rng = np.random.default_rng(window * 10 + width)
    chose = 0
    for n in (0, 1, 2, 7, 500, 5000, 20000):
        for kind in ("sorted", "unsorted"):
            src, dst = _random_graph(rng, n, width, kind)
            outs, _header = _adj_gap(src, dst, width, window)
            chose += int((outs[2].data != 0).sum())
    assert (chose > 0) == (window > 0)


def test_adj_gap_chain_decodes_level_by_level():
    """200 runs, each the list before it: the reference codes each as a copy
    of the one before, so its decode runs 199 dependency levels."""
    outs, _h = get_codec("edge_list").run_encode([serial(chip_smoke.CHAIN)], {})
    src, dst = outs[0].numpy(), outs[1].numpy()
    adj, _h = _adj_gap(src, dst, 8, 8)
    refs = adj[2].data
    assert refs[0] == 0 and bool((refs[1:] == 1).all())
    assert graph.reference_levels(refs) == 199


def test_adj_gap_takes_no_hub_as_a_reference():
    outs, _h = get_codec("edge_list").run_encode([serial(chip_smoke.HUB)], {})
    adj, _h = _adj_gap(outs[0].numpy(), outs[1].numpy(), 8, 8)
    assert adj[1].data.tolist() == [100, 10] and adj[2].data.tolist() == [0, 0]


@pytest.mark.parametrize("case", ("serial", "widths", "lengths", "window"))
def test_adj_gap_refuses_as_the_reference_does(case):
    ref_ins, ins = _columns(np.arange(6), np.arange(6), 4)
    params = {"window": 2}
    if case == "serial":
        ref_ins[0] = _ref_serial(bytes(24))
        ins[0] = serial(bytes(24))
    elif case == "widths":
        ref_ins[1], ins[1] = (x[1] for x in _columns(np.arange(6), np.arange(6), 8))
    elif case == "lengths":
        ref_ins[1], ins[1] = (x[1] for x in _columns(np.arange(5), np.arange(5), 4))
    else:
        params = {"window": -1}
    assert _check("adj_gap", ref_ins, ins, params) is None


def _u64(vals) -> Stream:
    return Stream(torch.tensor(np.array(vals, np.uint64).view(np.int64)), SType.NUMERIC, 8)


def _adj_streams():
    """A small graph whose runs 1 and 3 are references (to runs 0 and 2)."""
    lists = [[10, 11, 12, 13, 14, 15], [10, 11, 12, 13, 14, 16], [40, 41, 42, 43, 44],
             [40, 41, 42, 43, 44, 45]]
    src = np.concatenate([[k] * len(L) for k, L in enumerate(lists)]).astype(np.uint64)
    dst = np.concatenate(lists).astype(np.uint64)
    outs, header = _adj_gap(src, dst, 8, 8)
    assert outs[2].data.tolist() == [0, 1, 0, 1]
    return outs, header


def _corrupt():
    """(label, streams) of malformed adj_gap streams, each refused by both."""
    outs, header = _adj_streams()
    nodes, degs, refs, bits, gaps = outs
    d, g = degs.numpy().tolist(), gaps.numpy()
    return header, [
        ("reference_before_first_run", [nodes, degs, _u64([0, 2, 0, 1]), bits, gaps]),
        ("reference_to_itself_past_2_63", [nodes, degs, _u64([0, TOP, 0, 1]), bits, gaps]),
        ("copy_bits_exhausted", [nodes, degs, refs, Stream(bits.data[:1], SType.SERIAL, 1),
                                 gaps]),
        ("gaps_exhausted", [nodes, degs, refs, bits, _u64(g[:-1])]),
        ("trailing_gaps", [nodes, degs, refs, bits, _u64(list(g) + [2])]),
        ("degree_past_2_63", [nodes, _u64([d[0], (1 << 64) - 1, d[2], d[3]]), refs, bits,
                              gaps]),
        ("plain_degree_past_2_63", [nodes, _u64([(1 << 64) - 1] + d[1:]), refs, bits, gaps]),
        ("fewer_than_copied", [nodes, _u64([d[0], 1, d[2], d[3]]), refs, bits, gaps]),
        ("run_streams_differ", [nodes, _u64(d[:3]), refs, bits, gaps]),
        ("gaps_not_u64", [nodes, degs, refs, bits,
                          Stream(gaps.data.view(torch.uint8)[:-1], SType.SERIAL, 1)]),
        ("no_runs_but_gaps", [_u64([]), _u64([]), _u64([]), bits, gaps]),
    ]


@pytest.mark.parametrize("label", [c[0] for c in _corrupt()[1]])
def test_adj_gap_decode_fails_closed_as_the_reference_does(label):
    header, cases = _corrupt()
    bad = dict(cases)[label]
    try:
        ref_get_codec("adj_gap").run_decode([_to_ref(o) for o in bad], header)
    except ValueError as err:
        with pytest.raises(ValueError) as port_err:
            get_codec("adj_gap").run_decode(bad, header)
        if str(err).startswith("adj_gap"):  # the run loop's checks, not numpy's view
            assert str(port_err.value) == str(err)
    else:
        pytest.fail("the reference decoded a malformed stream")


def test_adj_gap_decode_refuses_a_bad_width():
    outs, header = _adj_streams()
    for bad_header in (b"\x03", b"\x08\x00"):
        _ref_raises("adj_gap", outs, bad_header)
        with pytest.raises(ValueError):
            get_codec("adj_gap").run_decode(outs, bad_header)


# ---------------------------------------------------------------- frames
def _ref_frame(ref_plan, streams, **kw):
    """The reference's frame, from an empty resolve cache, with the port's
    cache emptied at the same point.  ``adjacency_auto``'s trials compress
    through each package's cache even under ``use_resolve_cache=False``,
    keyed by plan, (type, width, bit length of the count), level and
    version, so without this a choice would depend on what this process
    compressed before."""
    resolve_cache_clear()
    repro_torch.resolve_cache_clear()
    return ref_compress(ref_plan, streams, backend="device", use_resolve_cache=False, **kw)


def _frames_equal(ref_plan, plan, raw: bytes, level=5):
    want = _ref_frame(ref_plan, [_ref_serial(raw)], ctx=RefCtx(level=level))
    frame = repro_torch.compress(plan, serial(raw), CompressionCtx(level=level), device="cpu", use_resolve_cache=False)
    assert frame == want
    (back,) = repro_torch.decompress(frame, device="cpu")
    assert back.content_bytes() == raw and back.stype == SType.SERIAL
    (ref_back,) = ref_decompress(frame)
    assert ref_back.data.tobytes() == raw
    return frame


@pytest.fixture(scope="module")
def edges():
    raw, pairs = chip_smoke.synth_edge_pairs(64 << 10, 1)
    return raw, pairs[: raw.count(b"\n") - 2]


@pytest.mark.parametrize("level", (1, 3, 5, 7, 9))
def test_graph_profile_writes_the_reference_frame(edges, level):
    frame = _frames_equal(ref_profiles.graph_profile(), repro_torch.graph_profile(),
                          edges[0], level)
    assert len(frame) * 3 < len(edges[0])


@pytest.mark.parametrize("level", (1, 3, 5, 7, 9))
@pytest.mark.parametrize("width", (2, 4, 8))
def test_graph_bin_profile_writes_the_reference_frame(edges, width, level):
    top = 1 << (8 * width - 1)
    ids = edges[1].astype(np.uint64) + np.uint64(top - 256)  # across 2^(8w - 1)
    raw = ids.astype(UNSIGNED[width]).tobytes()
    _frames_equal(ref_profiles.graph_bin_profile(width), repro_torch.graph_bin_profile(width),
                  raw, level)


def _corpus_plans(how):
    if isinstance(how, str):
        return ref_profiles.resolve_profile_spec(how), repro_torch.resolve_profile_spec(how)
    return ref_profiles.graph_profile(**how), repro_torch.graph_profile(**how)


@pytest.mark.parametrize("level", (1, 5, 9))
@pytest.mark.parametrize("case", chip_smoke.GRAPH_EDGES, ids=[c[0] for c in chip_smoke.GRAPH_EDGES])
def test_graph_profiles_write_the_reference_frame_on_the_edge_corpus(case, level):
    _label, raw, how = case
    _frames_equal(*_corpus_plans(how), raw, level)


@pytest.mark.parametrize("window", (0, 1, 8))
def test_the_adjacency_backends_write_the_reference_frame(edges, window):
    src, dst = (x.copy() for x in edges[1].T)
    ref_ins, ins = _columns(src, dst, 8)
    want = _ref_frame(ref_graph.adj_backend(window), ref_ins)
    assert repro_torch.compress(graph.adj_backend(window), ins, device="cpu", use_resolve_cache=False) == want
    back = repro_torch.decompress(want, device="cpu")
    _same(back, ref_ins)


def _u32_pairs(seed: int, n: int, unique: bool) -> bytes:
    rng = np.random.default_rng(seed)
    n_nodes = max(n // 12, 1)
    pairs = np.stack([np.sort(rng.integers(0, n_nodes, n)), rng.integers(0, 3 * n_nodes, n)], 1)
    if unique:
        pairs = np.unique(pairs, axis=0)
    return pairs.astype(np.uint32).tobytes()


def test_adjacency_auto_resolves_afresh_where_the_reference_reuses_its_cache():
    """The trials of both packages reuse a resolution cached for an earlier
    graph whose sample had the same type, width and count bit length, even
    under ``use_resolve_cache=False``: the frame for ``b`` depends on
    whether ``a`` was compressed first.  The port's frame equals the
    reference's both from empty caches and from caches warmed by ``a``."""
    a, b = _u32_pairs(123, 3000, False), _u32_pairs(223, 2500, True)
    ref_plan, plan = ref_profiles.graph_bin_profile(4), repro_torch.graph_bin_profile(4)
    fresh = _ref_frame(ref_plan, [_ref_serial(b)])
    assert repro_torch.compress(plan, serial(b), device="cpu", use_resolve_cache=False) == fresh
    _ref_frame(ref_plan, [_ref_serial(a)])  # both caches emptied, the reference's warmed by a
    repro_torch.compress(plan, serial(a), device="cpu", use_resolve_cache=False)
    warm = ref_compress(ref_plan, [_ref_serial(b)], backend="device", use_resolve_cache=False)
    assert warm != fresh
    assert repro_torch.compress(plan, serial(b), device="cpu", use_resolve_cache=False) == warm


@pytest.mark.parametrize("args", ((3,), (1,), (16, 8)))
def test_graph_bin_profile_validates_as_the_reference_does(args):
    with pytest.raises(ValueError) as ref_err:
        ref_profiles.graph_bin_profile(*args)
    with pytest.raises(ValueError) as err:
        repro_torch.graph_bin_profile(*args)
    assert str(err.value) == str(ref_err.value)


def _same_plan(plan, ref):
    assert plan.name == ref.name and plan.n_inputs == ref.n_inputs
    assert [(n.kind, n.name, n.inputs, n.n_out, n.param_dict()) for n in plan.nodes] == [
        (n.kind, n.name, n.inputs, n.n_out, n.param_dict()) for n in ref.nodes
    ]


@pytest.mark.parametrize("factory, args", (
    ("graph_profile", ()), ("graph_profile", (" ", 0)), ("graph_profile", ("::", 3)),
    ("graph_bin_profile", ()), ("graph_bin_profile", (8, 1)),
))
def test_graph_profiles_are_the_reference_graphs(factory, args):
    _same_plan(getattr(repro_torch, factory)(*args), getattr(ref_profiles, factory)(*args))


# ------------------------------------------------------------- the catalogue
def test_named_profiles_are_the_reference_catalogue():
    ours, ref = repro_torch.named_profiles(), ref_profiles.named_profiles()
    assert list(ours) == list(ref)
    for name, (fn, desc) in ours.items():
        ref_fn, ref_desc = ref[name]
        assert desc == ref_desc
        _same_plan(fn(), ref_fn())


SPECS = (
    "generic", "numeric", "text", "float32", "bfloat16", "float64", "sao", "graph",
    "graph:\t", "graph: ", "graph:::", "graph:,", "graph:bin", "graph:bin:", "graph:bin:2",
    "graph:bin:4", "graph:bin:8", "struct:4,4", "struct:8,,2,", "struct:28", "csv:3",
    "csv:3::", "csv:2:;", "csv:1:ab", "csv:2:",
    # malformed
    "", "nope", "Graph", "graph:", "graph:bin:3", "graph:bin:x", "graph:bin:4:5",
    "graph:bin:-4", "graph:a\rb", "graph:\n", "struct:", "struct:0", "struct:a", "struct:4,-1",
    "csv:", "csv:x", "csv:0", "csv:2:\r", "csv:-1:,",
)


@pytest.mark.parametrize("spec", SPECS)
def test_resolve_profile_spec_gives_the_reference_plan_or_message(spec):
    try:
        ref = ref_profiles.resolve_profile_spec(spec)
    except ValueError as err:
        with pytest.raises(ValueError) as port_err:
            repro_torch.resolve_profile_spec(spec)
        assert str(port_err.value) == str(err)
        return
    _same_plan(repro_torch.resolve_profile_spec(spec), ref)


def test_the_catalogue_is_exported_beside_the_other_profiles():
    for name in ("graph_profile", "graph_bin_profile", "named_profiles", "resolve_profile_spec"):
        assert getattr(repro_torch, name) is getattr(repro_torch.codecs, name)


def test_the_port_registers_every_reference_selector():
    from repro.core.selector import _SELECTORS as REF
    from repro_torch.core.selector import get_selector

    for name in REF:
        assert get_selector(name).name == name


# ------------------------------------------------------ chip_smoke's data
@pytest.mark.parametrize("nbytes_seed", ((64 << 10, 0), (1 << 20, 5), (100, 3)))
def test_chip_smoke_edge_recipe_is_the_benchmarks_recipe(nbytes_seed):
    from benchmarks.engine_bench import synth_edges

    nbytes, seed = nbytes_seed
    raw, pairs = chip_smoke.synth_edge_pairs(nbytes, seed)
    assert raw == synth_edges(nbytes, seed)
    lines = raw.split(b"\n")[2:-1]  # the complete edge lines
    assert lines == [b"%d\t%d" % (u, v) for u, v in pairs[: len(lines)].tolist()]
