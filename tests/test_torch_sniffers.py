"""The port's format sniffers (``repro_torch.codecs.parse.sniff_*``) and the
trainer's ``detect_frontend`` against the reference's.

Each sniffer's answer, and the frontend ``detect_frontend`` picks (its type
and fields), equal the reference's on ``tests/test_sniffers_fuzz.py``'s
seeded corpus and edge inputs, on hypothesis bytes, edge lists and CSVs, on
the inputs of ``test_detect_frontend_families`` and
``test_detect_frontend_graph_families``, and on prefixes of chip_smoke's
recipes (A, B, C, D, E, F, G, S, C1, C2, G1, G2).  Whatever a sniffer claims,
the port's own frontend codec encodes the sample losslessly on the CPU, as
the reference's fuzz test requires of the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from _hyp import given, settings, st  # noqa: E402
from test_sniffers_fuzz import _structured_blobs  # noqa: E402

from repro.codecs import parse as RP  # noqa: E402
from repro.training import detect_frontend as ref_detect  # noqa: E402
from repro_torch.codecs import parse as PP  # noqa: E402
from repro_torch.core.engine import Compressor  # noqa: E402
from repro_torch.core.graph import GraphBuilder  # noqa: E402
from repro_torch.core.message import serial  # noqa: E402
from repro_torch.training import detect_frontend  # noqa: E402

NAMES = ("sniff_csv", "sniff_edge_list", "sniff_edge_list_bin", "sniff_numeric_width",
         "sniff_struct_width")
RECIPE_BYTES = 1 << 18


def _frontend(fe):
    return type(fe).__name__, dataclasses.asdict(fe)


def assert_same_sniffs(raw: bytes) -> None:
    for name in NAMES:
        assert getattr(PP, name)(raw) == getattr(RP, name)(raw), name
    assert PP.sniff_numeric_width(raw, require_monotone=True) == RP.sniff_numeric_width(
        raw, require_monotone=True)
    assert _frontend(detect_frontend(raw)) == _frontend(ref_detect(raw))


def _rt(plan, raw: bytes) -> None:
    assert Compressor(plan, device="cpu").roundtrip_check(serial(raw))


def assert_port_parses_what_it_sniffs(raw: bytes) -> None:
    """``test_sniffers_fuzz.assert_sniffs_agree_with_parsers`` on the port."""
    csv = PP.sniff_csv(raw)
    if csv is not None:
        cut = raw.rfind(b"\n")
        g = GraphBuilder(1)
        g.add("csv_split", g.input(0), n_out=csv[0], sep=csv[1])
        _rt(g.build(), raw[: cut + 1] if cut >= 0 else raw)
    sep = PP.sniff_edge_list(raw)
    if sep is not None:
        g = GraphBuilder(1)
        g.add("edge_list", g.input(0), sep=sep)
        _rt(g.build(), raw)
    w = PP.sniff_edge_list_bin(raw)
    if w is not None:
        g = GraphBuilder(1)
        g.add("edge_list_bin", g.input(0), width=w)
        _rt(g.build(), raw)
    w = PP.sniff_numeric_width(raw)
    if w is not None:
        g = GraphBuilder(1)
        g.add("interpret_numeric", g.input(0), width=w)
        _rt(g.build(), raw)
    w = PP.sniff_struct_width(raw)
    if w is not None:
        g = GraphBuilder(1)
        g.add("field_split", g.input(0), n_out=w, widths=[1] * w)
        _rt(g.build(), raw)


def test_the_constants_are_the_references():
    assert PP.SNIFF_PROBE_BYTES == RP.SNIFF_PROBE_BYTES
    assert np.array_equal(PP._PRINTABLE_MASK, RP._PRINTABLE_MASK)
    for b in (b"", b"0", b"-0", b"007", b"-12", b"9223372036854775807",
              b"9223372036854775808", b"-9223372036854775808", b"1e3", b" 1", b"+1"):
        assert PP._canonical_int(b) == RP._canonical_int(b)


def test_sniffers_are_the_references_on_the_seeded_corpus():
    rng = np.random.default_rng(0xC0DEC)
    for _ in range(300):
        raw = _structured_blobs(rng)
        assert_same_sniffs(raw)
        assert_port_parses_what_it_sniffs(raw)


def test_detect_frontend_is_the_references_on_the_seeded_corpus():
    rng = np.random.default_rng(0xF20)
    for _ in range(150):
        raw = _structured_blobs(rng)
        assert _frontend(detect_frontend(raw)) == _frontend(ref_detect(raw))


@pytest.mark.parametrize(
    "raw",
    [b"", b"\n", b"\r\n" * 40, b"\x00" * 1024, b"#" * 1024, b"1\t2\n" * 64,
     b"-0\t007\n" * 64, bytes(range(256)) * 8],
)
def test_sniffers_are_the_references_on_edge_inputs(raw):
    assert_same_sniffs(raw)
    assert_port_parses_what_it_sniffs(raw)


@given(st.binary(min_size=0, max_size=2048))
@settings(max_examples=150, deadline=None)
def test_sniffers_are_the_references_hypothesis(raw):
    pytest.importorskip("hypothesis")
    assert_same_sniffs(raw)


@given(st.binary(min_size=0, max_size=2048))
@settings(max_examples=40, deadline=None)
def test_port_parses_what_it_sniffs_hypothesis(raw):
    pytest.importorskip("hypothesis")
    assert_port_parses_what_it_sniffs(raw)


@given(
    st.lists(st.tuples(st.integers(0, 99), st.integers(0, 99)), min_size=40, max_size=200),
    st.sampled_from([b"\t", b" "]),
)
@settings(max_examples=40, deadline=None)
def test_edge_lists_sniff_as_the_references(pairs, sep):
    pytest.importorskip("hypothesis")
    raw = b"\n".join(b"%d%s%d" % (u, sep, v) for u, v in sorted(pairs)) + b"\n"
    assert PP.sniff_edge_list(raw) == sep.decode()
    assert_same_sniffs(raw)


@given(
    st.lists(st.lists(st.integers(0, 999), min_size=3, max_size=3), min_size=2, max_size=60),
    st.sampled_from([b"\n", b"\r\n"]),
)
@settings(max_examples=40, deadline=None)
def test_csvs_sniff_as_the_references(rows, eol):
    pytest.importorskip("hypothesis")
    raw = eol.join(b",".join(b"%d" % v for v in r) for r in rows) + eol
    got = PP.sniff_csv(raw)
    assert got is not None and got[0] == 3
    assert_same_sniffs(raw)


def _family_inputs():
    """The inputs of ``test_detect_frontend_families`` and
    ``test_detect_frontend_graph_families``, drawn as they draw them."""
    out = []
    rng = np.random.default_rng(5)
    out.append(b"\n".join(b"%d,%d" % (i, i * 2) for i in range(300)) + b"\n")
    out.append(np.sort(rng.integers(0, 1 << 30, 4000)).astype(np.uint32).tobytes())
    n = 2001
    rec = np.empty((n, 5), np.uint8)
    rec[:, :4] = rng.integers(0, 1000, n).astype(np.uint32).view(np.uint8).reshape(n, 4)
    rec[:, 4] = rng.integers(0, 3, n)
    out.append(rec.tobytes())
    out.append(rng.integers(0, 256, 7919).astype(np.uint8).tobytes())
    rng = np.random.default_rng(17)
    lines = [b"# Nodes: 200", b"# FromNodeId\tToNodeId"]
    for u in range(200):
        for v in np.unique(rng.integers(0, 200, 5)):
            lines.append(b"%d\t%d" % (u, v))
    out.append(b"\n".join(lines) + b"\n")
    src = np.repeat(np.arange(150, dtype=np.uint32), 5)
    dst = np.concatenate(
        [np.sort(rng.choice(5000, 5, replace=False)) for _ in range(150)]
    ).astype(np.uint32)
    out.append(np.stack([src, dst], axis=1).tobytes())
    out.append(np.sort(rng.integers(0, 1 << 30, 4000)).astype(np.uint32).tobytes())
    return out


@pytest.mark.parametrize("index", range(7))
def test_detect_frontend_families_are_the_references(index):
    raw = _family_inputs()[index]
    assert_same_sniffs(raw)
    assert_port_parses_what_it_sniffs(raw)


def test_detect_frontend_families_pick_what_the_reference_tests_expect():
    csv, sorted_u32, rec5, noise, snap, pairs, flat = _family_inputs()
    assert _frontend(detect_frontend(csv))[0] == "CsvFrontend"
    assert _frontend(detect_frontend(sorted_u32)) == ("NumericFrontend", {"name": "numeric", "width": 4})
    fe = detect_frontend(rec5)
    assert type(fe).__name__ == "StructFrontend" and sum(fe.widths) == 5
    assert type(detect_frontend(noise)).__name__ == "Frontend"
    fe = detect_frontend(snap)
    assert type(fe).__name__ == "GraphFrontend" and fe.sep == "\t" and not fe.binary_width
    fe = detect_frontend(pairs)
    assert type(fe).__name__ == "GraphFrontend" and fe.binary_width == 4
    assert type(detect_frontend(flat)).__name__ == "NumericFrontend"


def _recipes():
    """Prefixes of chip_smoke's recipes at ``RECIPE_BYTES``, made as chip_smoke
    makes them (its column recipes at that column size)."""
    saved = chip_smoke.COLUMN_BYTES
    chip_smoke.COLUMN_BYTES = RECIPE_BYTES
    try:
        cols = chip_smoke.columns(0)
    finally:
        chip_smoke.COLUMN_BYTES = saved
    out = {label[0]: np.ascontiguousarray(col).tobytes() for label, col in cols.items()}
    out["S"] = chip_smoke.make_sao(RECIPE_BYTES // 28, 0)
    out["C1"] = chip_smoke.make_ppmf_csv(20_000, 3)[:RECIPE_BYTES]
    out["C2"] = chip_smoke.make_psam_csv(10_000, 4)[:RECIPE_BYTES]
    g1, pairs = chip_smoke.synth_edge_pairs(RECIPE_BYTES, 5)
    out["G1"] = g1
    out["G2"] = pairs[: g1.count(b"\n") - 2].astype(np.uint32).tobytes()
    return out


RECIPES = ("A", "B", "C", "D", "E", "F", "G", "S", "C1", "C2", "G1", "G2")


def test_chip_smoke_recipes_sniff_as_the_references():
    recipes = _recipes()
    assert sorted(recipes) == sorted(RECIPES)
    picked = {}
    for label in RECIPES:
        raw = recipes[label]
        for cut in (raw, raw[: 4 << 10], raw[: len(raw) // 3]):
            assert_same_sniffs(cut)
        picked[label] = type(detect_frontend(raw)).__name__
    assert picked["C1"] == picked["C2"] == "CsvFrontend"
    assert picked["G1"] == picked["G2"] == "GraphFrontend"
    assert picked["A"] == "NumericFrontend"
