"""The port's kernels, held against the reference's on the same inputs.

On the CPU every wrapper in ``repro_torch.kernels.ops`` takes its plain
PyTorch version, so these tests pin that plain version (and the glue around
it) bit for bit — tolerance 0, every function here is integer — against
``repro.kernels.ops`` with ``use_pallas=False``, and for one small case each
against the Pallas kernel in interpret mode.  The CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.codecs.entropy import (  # noqa: E402
    _canonical_codes,
    _fse_tables_cached,
    _huffman_code_lengths,
    _normalize_counts,
)
from repro.codecs.numeric import _delta_enc as ref_host_delta  # noqa: E402
from repro.core.message import numeric as ref_numeric  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.message import numeric  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SIZES = [0, 1, 7, 2048, 2049, 5000]
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _unsigned(t, width):
    return t.numpy().view(UNSIGNED[width])


def _symbols(kind, n, seed=0):
    """Byte streams: skewed, a one-symbol alphabet, or 255 distinct symbols."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        return np.full(n, 77, np.uint8)
    if kind == "255":
        return (np.arange(n) % 255).astype(np.uint8)
    return (rng.zipf(1.4, n) % 251).astype(np.uint8)


# ------------------------------------------------------------------ K1 delta
@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_delta_plain_matches_reference(width, n):
    x = np.random.default_rng(n * 10 + width).integers(
        0, np.iinfo(UNSIGNED[width]).max, n, dtype=UNSIGNED[width], endpoint=True
    )
    got = _unsigned(ops.delta_encode(numeric(x).data), width)
    (host,), _ = ref_host_delta([ref_numeric(x)], {})
    np.testing.assert_array_equal(got, host.data.view(UNSIGNED[width]))
    if width <= 4:  # the TPU kernel works in u32; truncating back is exact
        jx = jnp.asarray(x.astype(np.uint32))
        want = np.asarray(jops.delta_encode(jx, use_pallas=False))
        np.testing.assert_array_equal(got, want.astype(UNSIGNED[width]))


def test_delta_plain_matches_pallas_interpret():
    x = np.random.default_rng(1).integers(0, 1 << 32, 2049, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jops.delta_encode(jnp.asarray(x), use_pallas=True))
    np.testing.assert_array_equal(_unsigned(ops.delta_encode(numeric(x).data), 4), want)


# ------------------------------------------------------------ K3 byteshuffle
@pytest.mark.parametrize("w", [1, 3, 8, 1024])
@pytest.mark.parametrize("n", [0, 1, 100, 2049])
def test_byteshuffle_plain_matches_reference(n, w):
    x = np.random.default_rng(n + w).integers(0, 256, (n, w), dtype=np.uint8)
    got = ops.byteshuffle(torch.from_numpy(x)).numpy()
    want = np.asarray(jops.byteshuffle(jnp.asarray(x), use_pallas=False))
    assert got.shape == (w, n)
    np.testing.assert_array_equal(got, want)


def test_byteshuffle_plain_matches_pallas_interpret():
    x = np.random.default_rng(3).integers(0, 256, (2100, 3), dtype=np.uint8)
    want = np.asarray(jops.byteshuffle(jnp.asarray(x), use_pallas=True))
    np.testing.assert_array_equal(ops.byteshuffle(torch.from_numpy(x)).numpy(), want)


# ------------------------------------------------------------ K14 huffman map
def _huffman_tables(x):
    lens = _huffman_code_lengths(np.bincount(x, minlength=256).astype(np.int64))
    return _canonical_codes(lens), lens


@pytest.mark.parametrize("kind", ["skewed", "one", "255"])
@pytest.mark.parametrize("n", [0, 1, 2049, 5000])
def test_huffman_map_and_glue_match_reference(kind, n):
    x = _symbols(kind, n, seed=n)
    codes, lens = _huffman_tables(x)
    tx = torch.from_numpy(x)
    code, nb = ops.huffman_map(
        tx, torch.from_numpy(codes.astype(np.int32)), torch.from_numpy(lens.astype(np.int32))
    )
    offs = ref.exclusive_offsets(nb)
    jcode, jnb, joffs = jops.huffman_map(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(lens.astype(np.int32)),
        use_pallas=False,
    )
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode).astype(np.int64))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    np.testing.assert_array_equal(
        ref.histogram_exact(tx).numpy(), np.asarray(jops.histogram_exact(jnp.asarray(x)))
    )
    total_bytes = (int(offs[-1]) + 7) >> 3
    packed = ref.pack_bits(code, offs[:-1], total_bytes).numpy()
    want = np.asarray(jops.pack_bits(jcode, joffs[:-1], total_bytes))
    np.testing.assert_array_equal(packed, want)


def test_huffman_map_plain_matches_pallas_interpret():
    x = _symbols("skewed", 2100, seed=5)
    codes, lens = _huffman_tables(x)
    jcode, jnb, _ = jops.huffman_map(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(lens.astype(np.int32)),
        use_pallas=True,
    )
    code, nb = ops.huffman_map(
        torch.from_numpy(x),
        torch.from_numpy(codes.astype(np.int32)),
        torch.from_numpy(lens.astype(np.int32)),
    )
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode).astype(np.int64))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))


def test_bit_offsets_are_int64_past_the_int32_range():
    # the reference's int32 cumsum capped streams at 2^27 symbols; the port's
    # offsets are int64, so a total past 2^31 bits stays exact
    offs = ref.exclusive_offsets(torch.full((3,), 1 << 30, dtype=torch.int32))
    assert offs.dtype == torch.int64
    assert offs.tolist() == [0, 1 << 30, 1 << 31, 3 << 30]


# ------------------------------------------------------------ K9 tANS encode
def _fse_case(x, table_log=11):
    norm = _normalize_counts(np.bincount(x, minlength=256).astype(np.int64), table_log)
    _ds, _dn, _db, enc, nb0, thr, st0 = _fse_tables_cached(norm, table_log)
    n = x.size
    block = 1024
    n_blocks = (n + block - 1) // block
    padded = np.zeros(n_blocks * block, np.uint8)
    padded[:n] = x
    lanes = padded.reshape(n_blocks, block)
    rem = np.minimum(n - np.arange(n_blocks) * block, block).astype(np.int32)
    return lanes, rem, norm, enc, nb0, thr, st0


def _port_fse(lanes, rem, norm, enc, nb0, thr, st0, table_log=11):
    i32 = lambda a: torch.from_numpy(np.array(a, dtype=np.int32))  # noqa: E731
    lanesT = ops.byteshuffle(torch.from_numpy(lanes))
    sym_start, compact = ref.compact_encode_table(
        i32(norm), i32(enc.reshape(-1)), enc.shape[1]
    )
    vals, nbs, state = ops.fse_encode(
        lanesT, i32(rem), i32(nb0), i32(thr), i32(st0), i32(norm),
        sym_start, compact, enc.shape[1], 1 << table_log,
    )
    goffs, bitpos, byte_off = ref.fse_lane_offsets(nbs)
    return vals, nbs, state, goffs, bitpos, byte_off


def _jax_fse(lanes, rem, norm, enc, nb0, thr, st0, use_pallas, table_log=11):
    return jops.fse_encode(
        jnp.asarray(lanes.T), jnp.asarray(rem), jnp.asarray(nb0.astype(np.int32)),
        jnp.asarray(thr.astype(np.int32)), jnp.asarray(st0.astype(np.int32)),
        jnp.asarray(norm.astype(np.int32)), jnp.asarray(enc.reshape(-1)),
        enc.shape[1], 1 << table_log, use_pallas=use_pallas,
    )


@pytest.mark.parametrize("kind", ["skewed", "one", "255"])
@pytest.mark.parametrize("n", [1, 2049, 5000])
def test_fse_encode_and_glue_match_reference(kind, n):
    case = _fse_case(_symbols(kind, n, seed=n + 1))
    vals, nbs, state, goffs, bitpos, byte_off = _port_fse(*case)
    jvals, jgoffs, jstate, jbitpos, jbyte_off = _jax_fse(*case, use_pallas=False)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals).astype(np.int64))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    np.testing.assert_array_equal(goffs.numpy(), np.asarray(jgoffs))
    np.testing.assert_array_equal(bitpos.numpy(), np.asarray(jbitpos))
    np.testing.assert_array_equal(byte_off.numpy(), np.asarray(jbyte_off))
    total_bytes = int(byte_off[-1])
    packed = ref.pack_bits(vals, goffs, total_bytes).numpy()
    want = np.asarray(jops.pack_bits(jvals.reshape(-1), jgoffs.reshape(-1), total_bytes))
    np.testing.assert_array_equal(packed, want)


def test_fse_encode_plain_matches_pallas_interpret():
    case = _fse_case(_symbols("skewed", 1500, seed=9))
    vals, _nbs, state, goffs, _bitpos, _byte_off = _port_fse(*case)
    jvals, jgoffs, jstate, _jb, _jo = _jax_fse(*case, use_pallas=True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals).astype(np.int64))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    np.testing.assert_array_equal(goffs.numpy(), np.asarray(jgoffs))


def test_compact_encode_table_holds_every_live_entry():
    case = _fse_case(_symbols("skewed", 3000, seed=2))
    _lanes, _rem, norm, enc, *_ = case
    sym_start, compact = ref.compact_encode_table(
        torch.from_numpy(norm.astype(np.int32)), torch.from_numpy(np.array(enc.reshape(-1))), enc.shape[1]
    )
    assert compact.numel() == 1 << 11
    for s in np.nonzero(norm)[0]:
        lo = int(sym_start[s])
        np.testing.assert_array_equal(compact[lo : lo + norm[s]].numpy(), enc[s, : norm[s]])


# ------------------------------------------------------------------- wrappers
def test_wrappers_count_no_launch_on_the_cpu():
    ops.reset_launches()
    ops.delta_encode(numeric(np.arange(10, dtype=np.uint32)).data)
    ops.byteshuffle(torch.zeros((4, 2), dtype=torch.uint8))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError):
        ops.byteshuffle(torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError):
        ops.huffman_map(
            torch.zeros(8, dtype=torch.uint8),
            torch.zeros(255, dtype=torch.int32),
            torch.zeros(256, dtype=torch.int32),
        )
