"""K3 (byte shuffle) and K9 (tANS encode) on the host side, pinned on the CPU.

K3's path is chosen on the host from the record width
(``ops.byteshuffle_path``), pinned here at one width of each path; its
plain version is held against the reference's at a width of each path and
ragged n, from inputs at byte offsets 0, 1 and 16 into their buffer.  K9's
kernel walks the lanes in a short form that rests on invariants of the
codec's tables (``csrc/fse.cu``): they are checked here on the tables the
codec builds, with the entry range that the kernel's u16 shared table
needs, and the port's plain walk is held bit for bit (tolerance 0) against
the reference's ``fse_encode`` across table_log 1, 11, 15 (the largest
shared table) and 16 (global), lane-length patterns, and symbols the table
does not hold.  The CUDA kernels themselves are held against the plain
versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.codecs.entropy import _fse_tables_cached, _normalize_counts  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

BLOCK = 1024


# ------------------------------------------------------------ K3 byteshuffle
@pytest.mark.parametrize("w, path", [(8, ops.SHUFFLE_NARROW), (1024, ops.SHUFFLE_WIDE),
                                     (3, ops.SHUFFLE_BYTES)])
def test_byteshuffle_path_by_width(w, path):
    assert ops.byteshuffle_path(w) == path


@pytest.mark.parametrize("w", [1, 3, 8, 1024])
def test_byteshuffle_plain_matches_reference_at_every_path(w):
    for n_mod in (0, 7):
        n = 16 * (3 if w < 1024 else 1) + n_mod
        buf = np.random.default_rng(100 * w + n_mod).integers(0, 256, n * w + 16, dtype=np.uint8)
        tbuf = torch.from_numpy(buf)
        for offset in (0, 1, 16):
            x = buf[offset: offset + n * w].reshape(n, w)
            got = ops.byteshuffle(tbuf[offset: offset + n * w].view(n, w))
            want = np.asarray(jops.byteshuffle(jnp.asarray(x), use_pallas=False))
            np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ K9 tANS encode
def _tables(x, table_log):
    norm = _normalize_counts(np.bincount(x, minlength=256).astype(np.int64), table_log)
    _ds, _dn, _db, enc, nb0, thr, st0 = _fse_tables_cached(norm, table_log)
    return norm, enc, nb0, thr, st0


def _lanes(x, rem_kind):
    """(lanes, rem): x cut into 1024-symbol lanes, then the lane lengths of
    ``rem_kind`` (the symbols past a lane's length are never encoded)."""
    n_blocks = (x.size + BLOCK - 1) // BLOCK
    padded = np.zeros(n_blocks * BLOCK, np.uint8)
    padded[: x.size] = x
    rem = np.minimum(x.size - np.arange(n_blocks) * BLOCK, BLOCK)
    if rem_kind == "one_and_two":
        rem[0], rem[-1] = 1, 2
    elif rem_kind == "mixed":
        rem = np.random.default_rng(x.size).integers(0, BLOCK + 1, n_blocks)
    return padded.reshape(n_blocks, BLOCK), rem.astype(np.int32)


def _symbols(n, seed, table_log=11):
    """Skewed bytes; two symbols at most where table_log 1 leaves two slots."""
    x = np.random.default_rng(seed).zipf(1.3, n) % 200
    return (x % 2 if table_log == 1 else x).astype(np.uint8)


def _i32(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _port_args(lanes, rem, norm, enc, nb0, thr, st0, table_log):
    lanesT = ops.byteshuffle(torch.from_numpy(lanes))
    sym_start, compact = ref.compact_encode_table(_i32(norm), _i32(enc.reshape(-1)), enc.shape[1])
    return (lanesT, _i32(rem), _i32(nb0), _i32(thr), _i32(st0), _i32(norm), sym_start, compact,
            enc.shape[1], 1 << table_log)


def _reference(lanes, rem, norm, enc, nb0, thr, st0, table_log):
    jvals, _goffs, jstate, _bitpos, _byte_off = jops.fse_encode(
        jnp.asarray(lanes.T), jnp.asarray(rem), jnp.asarray(nb0.astype(np.int32)),
        jnp.asarray(thr.astype(np.int32)), jnp.asarray(st0.astype(np.int32)),
        jnp.asarray(norm.astype(np.int32)), jnp.asarray(enc.reshape(-1)),
        enc.shape[1], 1 << table_log, use_pallas=False,
    )
    return np.asarray(jvals).astype(np.int64), np.asarray(jstate)


@pytest.mark.parametrize("table_log", [1, 11, 15, 16])
def test_fse_symbol_words_hold_the_plain_tables(table_log):
    # the invariants K9's packed per-symbol word and short chain rest on:
    # thr = norm << nb0, nb0 = table_log + 1 - bit_length(norm), and each
    # symbol's first compact entry is its lane-start state st0 = enc[s][0]
    x = _symbols(3000, table_log, table_log)
    norm, enc, nb0, thr, st0 = _tables(x, table_log)
    total = 1 << table_log
    sym_start, compact = ref.compact_encode_table(_i32(norm), _i32(enc.reshape(-1)), enc.shape[1])
    shared = total <= _build.FSE_SHARED_TABLE
    assert shared == (table_log <= 15)
    np.testing.assert_array_equal(thr, norm << nb0)
    np.testing.assert_array_equal(nb0, table_log + 1 - np.array([int(v).bit_length() for v in norm]))
    held = norm != 0
    np.testing.assert_array_equal(enc[:, 0][held], st0[held])
    np.testing.assert_array_equal(compact.numpy()[sym_start.numpy()[held]], st0[held])
    if shared:  # a nb term of one add and one shift: |X - thr| < 2^16 for X in [total, 2 total)
        assert thr.max() < 2 * total <= 1 << 16


@pytest.mark.parametrize("table_log", [1, 11, 15, 16])
def test_fse_table_x_is_u16_while_the_kernel_holds_it_in_shared_memory(table_log):
    # the kernel carries X = state + total: every entry must lie in
    # [total, 2 total), below 2^16 where it is held as u16 in shared memory
    x = _symbols(5000, table_log + 7, table_log)
    norm, enc, *_ = _tables(x, table_log)
    _sym_start, compact = ref.compact_encode_table(_i32(norm), _i32(enc.reshape(-1)), enc.shape[1])
    total = 1 << table_log
    table_x = compact.to(torch.int64) + total
    assert compact.numel() == total
    assert int(table_x.min()) >= total and int(table_x.max()) < 2 * total
    if total <= _build.FSE_SHARED_TABLE:
        assert int(table_x.max()) < 1 << 16


@pytest.mark.parametrize("table_log", [1, 11, 15, 16])
@pytest.mark.parametrize("rem_kind", ["full", "short_last", "one_and_two", "mixed"])
def test_fse_encode_words_match_reference(table_log, rem_kind):
    n = 3 * BLOCK if rem_kind == "full" else 3 * BLOCK + 517
    x = _symbols(n, 7 * table_log + len(rem_kind), table_log)
    norm, enc, nb0, thr, st0 = _tables(x, table_log)
    lanes, rem = _lanes(x, rem_kind)
    vals, _nbs, state = ops.fse_encode(*_port_args(lanes, rem, norm, enc, nb0, thr, st0, table_log))
    jvals, jstate = _reference(lanes, rem, norm, enc, nb0, thr, st0, table_log)
    np.testing.assert_array_equal(vals.numpy(), jvals)
    np.testing.assert_array_equal(state.numpy(), jstate)


@pytest.mark.parametrize("table_log", [11, 16])
def test_fse_encode_words_take_absent_symbols_as_the_plain_walk_does(table_log):
    # a table built from other data: symbols it gives no slot are encoded
    # through the reference's clip (the state falls to 0), on both sides
    norm, enc, nb0, thr, st0 = _tables(_symbols(4000, 3) % 64, table_log)
    x = np.random.default_rng(5).integers(0, 256, 2 * BLOCK + 100, dtype=np.uint8)
    assert (norm[x] == 0).any()
    lanes, rem = _lanes(x, "short_last")
    vals, _nbs, state = ops.fse_encode(*_port_args(lanes, rem, norm, enc, nb0, thr, st0, table_log))
    jvals, jstate = _reference(lanes, rem, norm, enc, nb0, thr, st0, table_log)
    np.testing.assert_array_equal(vals.numpy(), jvals)
    np.testing.assert_array_equal(state.numpy(), jstate)


def test_fse_encode_refuses_an_empty_table_width():
    lanesT = torch.zeros((4, 2), dtype=torch.uint8)
    z = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.fse_encode(lanesT, torch.full((2,), 4, dtype=torch.int32), z, z, z, z, z,
                       torch.zeros(2, dtype=torch.int32), 0, 2)
