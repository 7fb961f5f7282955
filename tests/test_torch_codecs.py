"""Every codec of the port, held against the reference's encoders.

For each ported codec the port's encoder output — every stream's type,
width and bytes, and the header — equals the reference host encoder's and,
where the reference has one, its ``"device"`` twin's.  The port's numpy
decoders bring every input back.  All on the CPU, tolerance 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.codec import get_backend_codec  # noqa: E402
from repro.core.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro_torch.core.codec import all_codecs, get_codec  # noqa: E402
from repro_torch.core.message import SType, from_numpy  # noqa: E402

PORTED = (
    "store", "delta", "zigzag", "transpose", "range_pack",
    "tokenize", "huffman", "fse", "zlib_backend", "lz77", "float_split",
    "bitpack", "fused_delta_bitpack", "lzma_backend", "bz2_backend", "interpret_numeric",
)
# the structural codecs, rle and transpose_split (tests/test_torch_structural.py)
STRUCTURAL = (
    "dup", "constant", "split_n", "concat", "field_split", "string_split", "rle",
    "transpose_split",
)
# the CSV frontend (tests/test_torch_csv.py)
FRONTEND = ("csv_split", "parse_numeric")
# the graph frontend (tests/test_torch_graph.py)
GRAPH = ("edge_list", "edge_list_bin", "adj_gap")
DEVICE_TWINS = (
    "delta", "transpose", "huffman", "fse", "float_split", "bitpack", "fused_delta_bitpack",
)
HOST_LEAVES = ("zlib_backend", "lzma_backend", "bz2_backend")
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _numeric(kind, width, n, seed):
    rng = np.random.default_rng(seed)
    dt = UNSIGNED[width]
    if kind == "walk":
        x = np.cumsum(rng.integers(0, 40, n)).astype(dt)
    elif kind == "full":
        x = rng.integers(0, np.iinfo(dt).max, n, dtype=dt, endpoint=True)
    else:  # "few": a handful of distinct values
        x = rng.choice(np.array([3, 250, 7, 3, 9], dt), n)
    return RefStream(x, RefSType.NUMERIC, width)


def _bytes(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "one":
        x = np.full(n, 200, np.uint8)
    elif kind == "255":
        x = (np.arange(n) % 255).astype(np.uint8)
    else:
        x = (rng.zipf(1.3, n) % 251).astype(np.uint8)
    return RefStream(x, RefSType.SERIAL, 1)


def _cases(codec):
    """(reference stream, params) pairs each codec must match on."""
    out = []
    if codec in ("huffman", "fse"):
        for kind in ("skewed", "one", "255"):
            for n in (0, 1, 4097, 9000):
                if codec == "fse" and n == 0 and kind != "skewed":
                    continue
                out.append((_bytes(kind, n, n), {}))
        x = _bytes("skewed", 3000, 5).data
        out.append((RefStream(x, RefSType.NUMERIC, 1), {}))
        if codec == "fse":
            out.append((_bytes("skewed", 5000, 6), {"table_log": 9}))
        return out
    if codec == "float_split":
        for width in (2, 4, 8):
            for kind in ("walk", "full", "few"):
                for n in (0, 1, 3001):
                    out.append((_numeric(kind, width, n, width * 7 + n), {}))
        out.append((_numeric("full", 2, 999, 3), {"fmt": 1}))
        return out
    if codec in ("store", "lz77") + HOST_LEAVES:
        out.append((_bytes("skewed", 4000, 1), {}))
    for width in (1, 2, 4, 8):
        for kind in ("walk", "full", "few"):
            for n in (0, 1, 3001):
                out.append((_numeric(kind, width, n, width * 7 + n), {}))
    if codec in ("transpose", "tokenize", "store", "lz77") + HOST_LEAVES:
        rec = np.random.default_rng(2).integers(0, 4, 3 * 500).astype(np.uint8)
        out.append((RefStream(rec, RefSType.STRUCT, 3), {}))
    return out


def _port(s: RefStream):
    return from_numpy(s.data, SType(int(s.stype)), s.width)


def _same(port_outs, ref_outs):
    assert len(port_outs) == len(ref_outs)
    for p, r in zip(port_outs, ref_outs):
        assert (int(p.stype), p.width) == (int(r.stype), r.width)
        assert p.content_bytes() == r.content_bytes()


def test_the_slice_registers_exactly_its_codecs():
    ported = all_codecs()
    assert sorted(ported) == sorted(PORTED + STRUCTURAL + FRONTEND + GRAPH)
    for name, spec in ported.items():
        ref = ref_get_codec(name)
        assert (spec.codec_id, spec.n_outputs, spec.min_version) == (
            ref.codec_id, ref.n_outputs, ref.min_version,
        )


@pytest.mark.parametrize("codec", PORTED)
def test_encoder_matches_reference_and_roundtrips(codec):
    spec, ref = get_codec(codec), ref_get_codec(codec)
    twin = get_backend_codec("device", codec) if codec in DEVICE_TWINS else None
    checked_twin = False
    for s, params in _cases(codec):
        try:
            ref_outs, ref_header = ref.run_encode([s], params)
        except ValueError:
            with pytest.raises(ValueError):
                spec.run_encode([_port(s)], params)
            continue
        outs, header = spec.run_encode([_port(s)], params)
        assert header == ref_header
        _same(outs, ref_outs)
        if twin is not None and twin.applies([s], dict(params)):
            twin_outs, twin_header = twin.encode([s], dict(params))
            assert header == twin_header
            _same(outs, twin_outs)
            checked_twin = True
        (back,) = spec.run_decode(outs, header)
        assert (int(back.stype), back.width) == (int(s.stype), s.width)
        assert back.content_bytes() == s.content_bytes()
    assert twin is None or checked_twin, f"no case reached the {codec} device twin"


def test_range_pack_refuses_a_range_wider_than_57_bits():
    s = RefStream(np.array([0, 1 << 60], np.uint64), RefSType.NUMERIC, 8)
    with pytest.raises(ValueError):
        ref_get_codec("range_pack").run_encode([s], {})
    with pytest.raises(ValueError):
        get_codec("range_pack").run_encode([_port(s)], {})


@pytest.mark.parametrize("codec", ["huffman", "fse"])
def test_entropy_coders_refuse_wide_streams(codec):
    s = RefStream(np.arange(10, dtype=np.uint32), RefSType.NUMERIC, 4)
    with pytest.raises(ValueError):
        get_codec(codec).run_encode([_port(s)], {})
