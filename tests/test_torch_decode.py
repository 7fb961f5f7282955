"""The port's decode path, held against the reference on the CPU.

Each decode kernel's plain PyTorch version (``repro_torch.kernels.ref``, the
version every wrapper takes for a CPU tensor) is pinned bit for bit against
``repro.kernels.ops`` with ``use_pallas=False``, and in one small case each
against the Pallas kernel in interpret mode.  ``repro_torch.decompress(frame,
device="cpu")`` must return what ``repro.core.decompress`` returns on every
golden frame in the port's slice and on port-made frames of each plan.  All
integer data, tolerance 0, made with numpy from fixed seeds.  The CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _golden import GOLDEN_DIR  # noqa: E402

import repro_torch  # noqa: E402
from repro.codecs import entropy as E  # noqa: E402
from repro.codecs.numeric import _delta_dec as ref_host_delta_dec  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core.message import Stream as RefStream  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import _device  # noqa: E402
from repro_torch.codecs._util import HeaderWriter  # noqa: E402
from repro_torch.core.codec import get_codec  # noqa: E402
from repro_torch.core.message import Stream, SType, from_numpy, numeric  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
IN_SLICE = (
    "codec_store", "codec_delta", "codec_transpose", "codec_zigzag",
    "codec_range_pack", "codec_tokenize", "codec_huffman", "codec_fse",
    "codec_zlib_backend", "profile_numeric", "codec_float_split", "codec_lz77",
    "profile_float32", "profile_bfloat16", "profile_float64",
    "codec_bitpack", "codec_fused_delta_bitpack",
    "codec_lzma_backend", "codec_bz2_backend",
)


def _symbols(kind, n, seed=0):
    """Byte streams: skewed, a one-symbol alphabet, or 255 distinct symbols."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        return np.full(n, 77, np.uint8)
    if kind == "255":
        return (np.arange(n) % 255).astype(np.uint8)
    return (rng.zipf(1.4, n) % 251).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (cached tables are frozen)


# ----------------------------------------------------------- K2 delta decode
@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [0, 1, 7, 2048, 2049, 5000])
def test_delta_decode_plain_matches_reference(width, n):
    d = np.random.default_rng(n * 10 + width).integers(
        0, np.iinfo(UNSIGNED[width]).max, n, dtype=UNSIGNED[width], endpoint=True
    )
    got = ops.delta_decode(numeric(d).data).numpy().view(UNSIGNED[width])
    (host,) = ref_host_delta_dec([RefStream(d, RefSType.NUMERIC, width)], b"")
    np.testing.assert_array_equal(got, host.data)
    if width <= 4:  # the TPU kernel works in u32; truncating back is exact
        want = np.asarray(jops.delta_decode(jnp.asarray(d.astype(np.uint32)), use_pallas=False))
        np.testing.assert_array_equal(got, want.astype(UNSIGNED[width]))


@pytest.mark.parametrize("offset", [0, 1], ids=["d", "d[1:]"])
@pytest.mark.parametrize("edge", ["tile-1", "tile", "tile+1", "2tile+1"])
@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_delta_decode_plain_around_the_tile_and_from_an_offset_view(width, edge, offset):
    """The plain K2 at the tile's edges, from a view that starts one element
    into its tensor (as a payload view does), on deltas over the width's
    every bit pattern, so that the sums wrap."""
    t = ops.delta_decode_tile(width)  # the card's tile, around which chip_smoke.py checks K2
    n = {"tile-1": t - 1, "tile": t, "tile+1": t + 1, "2tile+1": 2 * t + 1}[edge]
    full = np.random.default_rng(n * 10 + width + offset).integers(
        0, np.iinfo(UNSIGNED[width]).max, n + 1, dtype=UNSIGNED[width], endpoint=True
    )
    d = full[offset: offset + n]
    view = numeric(full).data[offset: offset + n]
    assert view.storage_offset() == offset
    got = ops.delta_decode(view).numpy().view(UNSIGNED[width])
    (host,) = ref_host_delta_dec([RefStream(d, RefSType.NUMERIC, width)], b"")
    np.testing.assert_array_equal(got, host.data)
    if width <= 4:  # the TPU kernel works in u32; truncating back is exact
        want = np.asarray(jops.delta_decode(jnp.asarray(d.astype(np.uint32)), use_pallas=False))
        np.testing.assert_array_equal(got, want.astype(UNSIGNED[width]))


def test_delta_decode_inverts_delta_encode_at_width_8():
    x = np.random.default_rng(4).integers(0, 1 << 64, 3000, dtype=np.uint64, endpoint=False)
    back = ops.delta_decode(ops.delta_encode(numeric(x).data))
    np.testing.assert_array_equal(back.numpy().view(np.uint64), x)


def test_delta_decode_plain_matches_pallas_interpret():
    d = np.random.default_rng(1).integers(0, 1 << 32, 2049, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jops.delta_decode(jnp.asarray(d), use_pallas=True))
    np.testing.assert_array_equal(ops.delta_decode(numeric(d).data).numpy().view(np.uint32), want)


# ---------------------------------------------------------- K4 byteunshuffle
@pytest.mark.parametrize("w,n", [(1, 0), (1, 2049), (3, 100), (8, 2049), (1024, 3), (4096, 1), (4096, 5)])
def test_byteunshuffle_plain_matches_reference(w, n):
    p = np.random.default_rng(n + w).integers(0, 256, (w, n), dtype=np.uint8)
    got = ops.byteunshuffle(_t(p)).numpy()
    assert got.shape == (n, w)
    np.testing.assert_array_equal(got, np.asarray(jops.byteunshuffle(jnp.asarray(p), use_pallas=False)))
    np.testing.assert_array_equal(ops.byteshuffle(_t(got)).numpy(), p)


def test_byteunshuffle_plain_matches_pallas_interpret():
    p = np.random.default_rng(3).integers(0, 256, (3, 2100), dtype=np.uint8)
    want = np.asarray(jops.byteunshuffle(jnp.asarray(p), use_pallas=True))
    np.testing.assert_array_equal(ops.byteunshuffle(_t(p)).numpy(), want)


# --------------------------------------------------------------- K16 refill
def _refill_case(n_cursors, seed):
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, 4096 + 8, dtype=np.uint8)
    pos = rng.integers(0, 4096 * 8, n_cursors)
    pos[: min(8, n_cursors)] = np.arange(min(8, n_cursors)) * 9  # r = 0 .. 7
    return buf, pos


@pytest.mark.parametrize("n_cursors", [0, 1, 300, 5000])
def test_lane_refill_plain_matches_reference(n_cursors):
    buf, pos = _refill_case(n_cursors, seed=n_cursors)
    got = ops.lane_refill(_t(buf), _t(pos.astype(np.int64))).numpy().view(np.uint32)
    want = np.asarray(
        jops.lane_refill(jnp.asarray(buf), jnp.asarray(pos.astype(np.int32)), use_pallas=False)
    )
    np.testing.assert_array_equal(got, want)
    for p, win in zip(pos[:50], got[:50]):  # against the definition
        word = int.from_bytes(buf[p >> 3 : (p >> 3) + 5].tobytes(), "little")
        assert win == (word >> (p & 7)) & 0xFFFFFFFF


def test_lane_refill_plain_matches_pallas_interpret():
    buf, pos = _refill_case(300, seed=7)
    want = np.asarray(
        jops.lane_refill(jnp.asarray(buf), jnp.asarray(pos.astype(np.int32)), use_pallas=True)
    )
    got = ops.lane_refill(_t(buf), _t(pos.astype(np.int64))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- K15 huffman decode
def _huffman_case(kind, n):
    """The reference's host-encoded lanes, laid out as tests/test_kernels.py does."""
    data = _symbols(kind, n, seed=n)
    lens = E._huffman_code_lengths(E._hist_u8(data))
    codes = E._canonical_codes(lens)
    packed, offs = E._write_bits_blocked(codes[data], lens[data].astype(np.int64), 1 << E.BLOCK_LOG)
    lut_sym, lut_len = E._huffman_decode_lut(lens)
    block = 1 << E.BLOCK_LOG
    n_blocks = (n + block - 1) // block
    rem = np.minimum(n - np.arange(n_blocks) * block, block)
    max_rem = int(rem.max())
    pad = 16 + ((E.MAX_CODE_LEN * max_rem + 7) >> 3)
    buf = np.zeros(packed.size + pad, np.uint8)
    buf[: packed.size] = packed
    return data, buf, offs[:-1:block], lut_sym, lut_len, max_rem


def _port_huffman(buf, pos, lut_sym, lut_len, max_rem):
    lut = ref.pack_huffman_lut(_t(lut_sym), _t(lut_len.astype(np.int64)))
    return ops.huffman_decode(_t(buf), _t(pos.astype(np.int64)), lut, max_rem).numpy()


def _jax_huffman(buf, pos, lut_sym, lut_len, max_rem, use_pallas):
    return np.asarray(
        jops.huffman_decode(
            jnp.asarray(buf), jnp.asarray(pos.astype(np.int32)),
            jnp.asarray(lut_sym.astype(np.int32)), jnp.asarray(lut_len.astype(np.int32)),
            max_rem, use_pallas=use_pallas,
        )
    )


@pytest.mark.parametrize("kind", ["skewed", "one", "255"])
@pytest.mark.parametrize("n", [1, 100, 4097, 12000])
def test_huffman_decode_plain_matches_reference(kind, n):
    data, *case = _huffman_case(kind, n)
    got = _port_huffman(*case)
    np.testing.assert_array_equal(got, _jax_huffman(*case, use_pallas=False))  # every row
    symbols = ops.byteunshuffle(_t(got)).reshape(-1)[:n].numpy()
    np.testing.assert_array_equal(symbols, data)


def test_huffman_decode_plain_matches_pallas_interpret():
    _data, *case = _huffman_case("skewed", 300)
    np.testing.assert_array_equal(_port_huffman(*case), _jax_huffman(*case, use_pallas=True))


# ---------------------------------------------------------- K10 tANS decode
def _fse_case(kind, n, table_log=11):
    """Host-encoded tANS lanes in the reference's per-lane padded layout."""
    data = _symbols(kind, n, seed=n + 3)
    norm = E._normalize_counts(E._hist_u8(data), table_log)
    dec_sym, dec_nb, dec_base, _enc = E._build_tables(norm, table_log)
    outs, _ = E._fse_enc([RefStream(data, RefSType.SERIAL, 1)], {"table_log": table_log})
    stream = np.frombuffer(outs[0].content_bytes(), np.uint8)
    meta = np.frombuffer(outs[1].content_bytes(), np.uint32)
    bitlen = meta[0::2].astype(np.int64)
    nbytes = (bitlen + 7) // 8
    offsets = np.concatenate([[0], np.cumsum(nbytes)])
    cap = int(nbytes.max()) + 16
    flat = np.zeros(bitlen.size * cap, np.uint8)
    for k in range(bitlen.size):
        flat[k * cap : k * cap + nbytes[k]] = stream[offsets[k] : offsets[k + 1]]
    block = 1 << E.FSE_BLOCK_LOG
    max_rem = min(n, block)
    lanes = (flat, np.arange(bitlen.size) * cap, bitlen, meta[1::2].astype(np.int64), max_rem)
    return data, stream, offsets, (dec_sym, dec_nb, dec_base), lanes


def _port_fse(tables, flat, lane_base, bitlen, state0, max_rem):
    sym, nbb = ref.pack_fse_table(*(_t(a) for a in tables))
    return ops.fse_decode(
        _t(flat), _t(lane_base.astype(np.int64)), _t(bitlen),
        _t(state0.astype(np.int32)), sym, nbb, max_rem,
    ).numpy()


def _jax_fse(tables, flat, lane_base, bitlen, state0, max_rem, use_pallas):
    dec_sym, dec_nb, dec_base = tables
    return np.asarray(
        jops.fse_decode(
            jnp.asarray(flat), jnp.asarray(lane_base.astype(np.int32)),
            jnp.asarray(bitlen.astype(np.int32)), jnp.asarray(state0.astype(np.int32)),
            jnp.asarray(dec_sym.astype(np.int32)), jnp.asarray(dec_nb), jnp.asarray(dec_base),
            max_rem, use_pallas=use_pallas,
        )
    )


@pytest.mark.parametrize("kind", ["skewed", "one", "255"])
@pytest.mark.parametrize("n", [1, 100, 1025, 5000])
def test_fse_decode_plain_matches_reference(kind, n):
    data, stream, offsets, tables, lanes = _fse_case(kind, n)
    got = _port_fse(tables, *lanes)
    np.testing.assert_array_equal(got, _jax_fse(tables, *lanes, use_pallas=False))  # every row
    # the port's own layout: the concatenated wire stream read at each lane's
    # byte offset, padded by 8 bytes, decodes the same symbols
    buf = np.concatenate([stream, np.zeros(8, np.uint8)])
    _flat, _base, bitlen, state0, max_rem = lanes
    wire = _port_fse(tables, buf, offsets[:-1], bitlen, state0, max_rem)
    symbols = ops.byteunshuffle(_t(wire)).reshape(-1)[:n].numpy()
    np.testing.assert_array_equal(symbols, data)


@pytest.mark.parametrize("table_log", [16, 18, 20])
def test_fse_decode_above_the_cards_table_log_matches_reference(table_log):
    """Table logs past 15, whose tables the card reads from global memory
    instead of shared memory, decode as the reference does."""
    from repro.core.codec import get_codec as ref_get_codec

    x = _symbols("skewed", 70000, seed=table_log)
    x[777] = 252  # a symbol seen once: its states emit up to table_log bits
    spec, outs, header = _encoded("fse", x, params={"table_log": table_log})
    (back,) = spec.run_decode(outs, header)
    np.testing.assert_array_equal(back.data.numpy(), x)
    ref_outs = [RefStream(o.numpy(), RefSType(int(o.stype)), o.width) for o in outs]
    (want,) = ref_get_codec("fse").run_decode(ref_outs, header)
    assert back.content_bytes() == want.content_bytes()


def test_fse_step_entries_widen_past_table_log_26():
    """Above table_log 26 a step entry is int64, so ``base`` keeps every bit;
    checked on small tables (a 2^27-entry table is checked on the card)."""
    nb = torch.tensor([0, 1, 26, 27, 30, 31], dtype=torch.int32)
    base = torch.tensor([0, 1 << 26, (1 << 27) - 1, 1 << 29, (1 << 30) - 1, 12345], dtype=torch.int32)
    sym = torch.arange(6, dtype=torch.int32)
    _sym, wide = ref.pack_fse_table(sym, nb, base, wide=True)
    assert wide.dtype == torch.int64
    np.testing.assert_array_equal((wide & 0x1F).numpy(), nb.numpy())
    np.testing.assert_array_equal((wide >> 5).numpy(), base.numpy())
    # the wide layout decodes a real table_log 11 stream as the narrow one does
    data, stream, offsets, tables, lanes = _fse_case("skewed", 5000)
    assert ref.pack_fse_table(*(_t(a) for a in tables))[1].dtype == torch.int32
    sym8, wide = ref.pack_fse_table(*(_t(a) for a in tables), wide=True)
    buf = np.concatenate([stream, np.zeros(8, np.uint8)])
    _flat, _base, bitlen, state0, max_rem = lanes
    args = (_t(buf), _t(offsets[:-1].astype(np.int64)), _t(bitlen), _t(state0.astype(np.int32)))
    got = ops.fse_decode(*args, sym8, wide, max_rem)
    np.testing.assert_array_equal(got.numpy(), _port_fse(tables, buf, offsets[:-1], bitlen, state0, max_rem))
    np.testing.assert_array_equal(ops.byteunshuffle(got).reshape(-1)[:5000].numpy(), data)


def test_fse_encoder_refuses_a_table_log_past_the_ports_limit():
    x = _symbols("skewed", 3000)
    with pytest.raises(ValueError):
        _encoded("fse", x, params={"table_log": ref.FSE_MAX_TABLE_LOG + 1})


def test_fse_decode_plain_matches_pallas_interpret():
    _data, _stream, _offsets, tables, lanes = _fse_case("skewed", 1500)
    np.testing.assert_array_equal(
        _port_fse(tables, *lanes), _jax_fse(tables, *lanes, use_pallas=True)
    )


# --------------------------------------------------------------- decompress
def _same_streams(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.device == torch.device("cpu")
        assert (int(a.stype), a.width) == (int(b.stype), b.width)
        assert a.content_bytes() == b.content_bytes()


@pytest.mark.parametrize("name", IN_SLICE)
def test_decompress_matches_reference_on_golden_frames(name):
    frame = (GOLDEN_DIR / f"{name}.ozl").read_bytes()
    _same_streams(repro_torch.decompress(frame, device="cpu"), ref_decompress(frame))


PLANS = {
    "numeric_l1": ("profile", 1),
    "numeric_l5": ("profile", 5),
    "delta_transpose_huffman": (("delta", "transpose", "huffman"), 5),
    "delta_transpose_fse": (("delta", "transpose", "fse"), 5),
    "zigzag_range_pack": (("zigzag", "range_pack"), 5),
    "tokenize": (("tokenize",), 5),
}


def _column(plan_name, n):
    rng = np.random.default_rng(n)
    if plan_name in ("numeric_l5", "tokenize"):  # zipf ids: tokenize is chosen
        return (rng.zipf(1.3, n) % 5000).astype(np.uint32)
    if plan_name == "zigzag_range_pack":
        return rng.integers(-3000, 3000, n).astype(np.int16)
    return (1_700_000_000_000 + np.cumsum(rng.integers(900, 1100, n))).astype(np.int64)


@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 1 << 18])
@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_decompress_matches_reference_on_port_frames(plan_name, n):
    spec, level = PLANS[plan_name]
    plan = repro_torch.numeric_profile() if spec == "profile" else repro_torch.pipeline(*spec)
    col = _column(plan_name, n)
    frame = repro_torch.compress(
        plan, repro_torch.numeric(col), repro_torch.CompressionCtx(level=level), device="cpu", use_resolve_cache=False
    )
    ours = repro_torch.decompress(frame, device="cpu")
    _same_streams(ours, ref_decompress(frame))
    assert ours[0].content_bytes() == col.tobytes()


def test_decompress_defaults_to_the_card_and_raises_without_one(monkeypatch):
    frame = repro_torch.compress(
        repro_torch.numeric_profile(), repro_torch.numeric(np.arange(100, dtype=np.uint32)),
        device="cpu", use_resolve_cache=False,
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(_device.NoCardError):
        repro_torch.decompress(frame)
    with pytest.raises(_device.NoCardError):
        repro_torch.decompress(frame, device="cuda")


# ----------------------------------------------------------------- wrappers
def test_decode_wrappers_count_no_launch_on_the_cpu():
    ops.reset_launches()
    ops.delta_decode(torch.arange(10, dtype=torch.int32))
    ops.byteunshuffle(torch.zeros((4, 2), dtype=torch.uint8))
    ops.lane_refill(torch.zeros(16, dtype=torch.uint8), torch.zeros(3, dtype=torch.int64))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_decode_wrappers_refuse_bad_shapes_and_devices():
    with pytest.raises(ValueError):
        ops.byteunshuffle(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(TypeError):
        ops.delta_decode(torch.zeros(8, dtype=torch.float32))
    with pytest.raises(ValueError):
        ops.huffman_decode(
            torch.zeros(8, dtype=torch.uint8), torch.zeros(1, dtype=torch.int64),
            torch.zeros(100, dtype=torch.int16), 4,
        )
    with pytest.raises(ValueError):  # tables of 2^table_log entries
        ops.fse_decode(
            torch.zeros(8, dtype=torch.uint8), torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int32),
            torch.zeros(100, dtype=torch.uint8), torch.zeros(100, dtype=torch.int32), 4,
        )
    meta = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ops.KernelError, match="cuda or cpu"):
        ops.delta_decode(meta)


# ------------------------------------------------------------- fail closed
def _encoded(codec, data, stype=SType.SERIAL, width=1, params=None):
    spec = get_codec(codec)
    outs, header = spec.run_encode([from_numpy(data, stype, width)], params or {})
    return spec, outs, header


def _replace(outs, k, data):
    s = outs[k]
    return outs[:k] + [Stream(torch.from_numpy(np.array(data)), s.stype, s.width)] + outs[k + 1 :]


def _malformed(case):
    """(codec spec, output streams, header) that a decoder must refuse."""
    x = _symbols("skewed", 5000, seed=1)
    if case == "huffman_offset_past_stream":
        spec, outs, header = _encoded("huffman", x)
        return spec, _replace(outs, 1, np.array([0, 1 << 40], np.int64)), header
    if case == "fse_lengths_past_stream":
        spec, outs, header = _encoded("fse", x)
        meta = outs[1].data.numpy().copy()
        meta[0] += 64
        return spec, _replace(outs, 1, meta), header
    if case == "fse_state_past_table":
        spec, outs, header = _encoded("fse", x)
        meta = outs[1].data.numpy().copy()
        meta[1] = 1 << 11
        return spec, _replace(outs, 1, meta), header
    if case == "fse_counts_off_the_table":
        # the same counts under a header that says table_log 12: they sum to
        # 2^11, not 2^12, and the tables are never built
        spec, outs, header = _encoded("fse", x)
        at = len(HeaderWriter().varint(x.size).u8(0).done())  # n, then the block log
        assert header[at] == 11
        return spec, outs, header[:at] + bytes([12]) + header[at + 1 :]
    if case == "tokenize_index_past_alphabet":
        spec, outs, header = _encoded("tokenize", np.arange(10, dtype=np.uint32), SType.NUMERIC, 4)
        return spec, _replace(outs, 1, np.array([0, 10] * 5, np.int32)), header
    if case == "range_pack_short_payload":
        spec, outs, header = _encoded("range_pack", np.arange(1000, dtype=np.uint32), SType.NUMERIC, 4)
        return spec, _replace(outs, 0, outs[0].data.numpy()[:-3]), header
    spec, outs, header = _encoded("transpose", np.arange(100, dtype=np.uint32), SType.NUMERIC, 4)
    return spec, _replace(outs, 0, outs[0].data.numpy()[:-1]), header


@pytest.mark.parametrize("case", [
    "huffman_offset_past_stream", "fse_lengths_past_stream", "fse_state_past_table",
    "fse_counts_off_the_table",
    "tokenize_index_past_alphabet", "range_pack_short_payload", "transpose_ragged_planes",
])
def test_decoders_fail_closed_on_malformed_streams(case):
    """Streams from outside are checked before a kernel or gather reads them
    (on the card an out-of-bounds read would fault the context)."""
    spec, outs, header = _malformed(case)
    with pytest.raises(ValueError):
        spec.run_decode(outs, header)
