"""The port against the frozen golden corpus (``tests/golden/``).

Every vector whose codecs and selectors all lie in the port's slice is
re-encoded by the port on the CPU (at the manifest's ``chunk_bytes``, so the
container vectors write containers) and must reproduce the frozen frame byte
for byte; the port's decoder must read every such frame back to its input.
The plans reach the port the way a deployed compressor would: the
reference's serialized plan, as a plain dict, through ``plan_from_dict``.
"""
import pytest

torch = pytest.importorskip("torch")

from _golden import GOLDEN_DIR, LEVEL, load_manifest, stream_from_entry  # noqa: E402

from repro.core.serialize import deserialize_plan, plan_to_dict  # noqa: E402
from repro_torch import CompressionCtx, compress, decompress, plan_from_dict, resolve_cache_clear  # noqa: E402,E501
from repro_torch.core.message import Stream, SType, from_numpy  # noqa: E402

IN_SLICE = (
    "codec_store", "codec_delta", "codec_transpose", "codec_zigzag",
    "codec_range_pack", "codec_tokenize", "codec_huffman", "codec_fse",
    "codec_zlib_backend", "profile_numeric", "codec_float_split", "codec_lz77",
    "profile_float32", "profile_bfloat16", "profile_float64",
    "codec_bitpack", "codec_fused_delta_bitpack",
    "codec_lzma_backend", "codec_bz2_backend",
    "container_numeric", "container_text", "profile_text",
    "profile_generic_numeric", "profile_generic_text",
    "version_v1_generic", "version_v2_generic", "version_v3_generic", "version_v4_generic",
    "codec_interpret_numeric", "trained_era5_flux",
    "codec_dup", "codec_constant", "codec_split_n", "codec_concat", "codec_field_split",
    "codec_string_split", "codec_rle", "codec_transpose_split", "profile_sao",
    "profile_struct44",
    "codec_csv_split", "codec_csv_split_crlf", "codec_csv_split_multisep", "codec_parse_numeric",
    "profile_csv3",
    "codec_edge_list", "codec_edge_list_bin", "codec_adj_gap", "profile_graph",
    "profile_graph_bin",
)
MANIFEST = load_manifest()
ALL_PLANS = sorted(p.stem for p in GOLDEN_DIR.glob("*.ozp"))


def _ref_plan(name):
    return deserialize_plan((GOLDEN_DIR / f"{name}.ozp").read_bytes())


def _port_plan(name):
    plan, meta = _ref_plan(name)
    fv, level = meta.get("format_version"), meta.get("level")
    return plan_from_dict(plan_to_dict(plan, meta["name"], format_version=fv, level=level))


@pytest.mark.parametrize("name", IN_SLICE)
def test_port_reproduces_frozen_frame(name):
    entry = MANIFEST[name]
    payload = (GOLDEN_DIR / f"{name}.in").read_bytes()
    s = stream_from_entry(entry, payload)
    plan, _meta = _port_plan(name)
    if s.lengths is not None:  # a STRING stream: its bytes and host lengths
        port_s = Stream(torch.from_numpy(s.data.copy()), SType.STRING, 1, s.lengths)
    else:
        port_s = from_numpy(s.data, SType(int(s.stype)), s.width)
    # selector trials consult the resolve cache (as the reference's do): the
    # frozen frames are those of an empty cache, not of the vectors before
    resolve_cache_clear()
    frame = compress(
        plan,
        [port_s],
        CompressionCtx(entry["format_version"], LEVEL),
        device="cpu",
        chunk_bytes=entry["chunk_bytes"] or None,
    )
    assert frame == (GOLDEN_DIR / f"{name}.ozl").read_bytes()


@pytest.mark.parametrize("name", IN_SLICE)
def test_port_decodes_frozen_frame(name):
    (out,) = decompress((GOLDEN_DIR / f"{name}.ozl").read_bytes(), device="cpu")
    assert out.content_bytes() == (GOLDEN_DIR / f"{name}.in").read_bytes()
    assert int(out.stype) == MANIFEST[name]["stype"]


@pytest.mark.parametrize("name", ALL_PLANS)
def test_every_golden_plan_crosses_over_or_names_what_is_missing(name):
    # every codec is ported: each golden plan crosses over whole
    ref_plan, ref_meta = _ref_plan(name)
    plan, meta = _port_plan(name)
    assert name in IN_SLICE
    assert meta == ref_meta
    assert plan.n_inputs == ref_plan.n_inputs and plan.name == ref_plan.name
    assert [(n.kind, n.name, n.inputs, n.n_out, n.param_dict()) for n in plan.nodes] == [
        (n.kind, n.name, n.inputs, n.n_out, n.param_dict()) for n in ref_plan.nodes
    ]
