"""K13 (histogram) and K12 (fused delta + bitpack decode), on the CPU.

The plain versions behind both wrappers (``repro_torch.kernels.ref``, which
``ops.histogram`` and ``ops.fused_delta_bitpack_decode`` take for a CPU
tensor) are held against the reference: the histogram against
``repro.kernels.ops.histogram`` run through its Pallas kernel in interpret
mode and against ``histogram_exact``, at every size up to 64 bytes and a
64 KiB trial's sample, from byte offsets 0-15 of a view, the sizes of
``chip_smoke.py``'s card sweep; the fused decode against
``repro.kernels.ops.fused_delta_bitpack_decode`` in Pallas interpret mode
at small sizes, and against the reference's jnp oracle at every bits and
width around the card kernel's tile edges (read from
``csrc/fused_delta_bitpack.cu``), from words 0-3 words into their buffer.
Inputs are made with numpy from fixed seeds; tolerance 0.  The CUDA kernels
are held against the same plain versions on the card by ``chip_smoke.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

HIST_SIZES = tuple(range(65)) + (1 << 16,)
PALLAS_SIZES = (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 1 << 16)
BITS = (1, 2, 4, 8, 16, 32)
WIDTHS = (1, 2, 4)
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32}
FDB_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
              / "fused_delta_bitpack.cu")


# -------------------------------------------------------------- K13 histogram
def _hist_buffer():
    return np.random.default_rng(13).integers(0, 256, HIST_SIZES[-1] + 16).astype(np.uint8)


@pytest.mark.parametrize("offset", range(16))
def test_histogram_plain_matches_reference_from_every_offset(offset):
    """Sizes 0-64 and 64 KiB from byte ``offset`` of a view, against
    ``histogram_exact`` at every size and the Pallas kernel in interpret
    mode at the sizes around a 16-byte chunk and the trial's 64 KiB."""
    buf = _hist_buffer()
    whole = torch.from_numpy(buf)
    for n in HIST_SIZES:
        x = whole[offset: offset + n]
        assert x.storage_offset() == offset
        got = ops.histogram(x)
        assert got.dtype == torch.int64 and got.shape == (256,)
        want = np.asarray(jops.histogram_exact(jnp.asarray(buf[offset: offset + n])))
        np.testing.assert_array_equal(got.numpy(), want)
        if n in PALLAS_SIZES:
            pallas = jops.histogram(jnp.asarray(buf[offset: offset + n]), use_pallas=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(pallas).astype(np.int64))


@pytest.mark.parametrize("value", [0, 127, 128, 255])
def test_histogram_plain_on_single_value_streams(value):
    """Streams of one byte past the card's one-block size, from byte 1 of a
    view, in the low and high bins: all their count in one bin."""
    for n in ((1 << 16) + 16, (1 << 18) + 17):
        x = torch.full((n + 1,), value, dtype=torch.uint8)[1:]
        got = ops.histogram(x)
        want = np.asarray(jops.histogram_exact(jnp.full((n,), value, jnp.uint8)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got[value]) == n and int(got.sum()) == n


# ------------------------------------------------ K12 fused bitpack decode
def _fdb_constants():
    text = FDB_SOURCE.read_text()
    return {k: int(re.search(rf"#define {k} (\d+)", text).group(1))
            for k in ("FTHREADS", "FRUN_BYTES", "FTILE_OUT", "FTILE_IN")}


def _k12_tile(bits, width):
    """The values of one tile of the card's K12, by FDecode's rule in the
    source: a run of VPT values keeps its input and output within
    FRUN_BYTES, and a thread takes R runs within FTILE_IN input and
    FTILE_OUT output bytes."""
    c = _fdb_constants()
    vpt = c["FRUN_BYTES"] // max(width, max(bits // 8, 1))
    wpt = vpt // (32 // bits)
    runs = min(c["FTILE_IN"] // (4 * wpt), c["FTILE_OUT"] // (vpt * width))
    return runs * c["FTHREADS"] * vpt


def _words(bits, n_words, seed):
    """Random words (deltas over every field value, so the sums wrap) with
    three more at the front, for views 0-3 words in."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, n_words + 3, dtype=np.uint64).astype(np.uint32)


def test_k12_tiles_read_from_the_source():
    """Every tile holds whole warps of whole runs (32 values at least)."""
    assert all(_k12_tile(b, w) % (32 * 32) == 0 for b in BITS for w in WIDTHS)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("bits", BITS)
def test_fused_decode_plain_around_tile_edges(bits, width):
    """n around the card kernel's tile (a word's values and one value on
    either side of one and two tiles, and the tile's quarters), from words
    0-3 words into their buffer, against the reference's jnp oracle (the
    decode of a prefix of values depends only on the words before it)."""
    per = 32 // bits
    t = _k12_tile(bits, width)
    sizes = (1, per, t // 4 - 1, t // 2 + 1, 3 * t // 4 + per, t - per, t - 1, t, t + 1,
             t + per, 2 * t - 1, 2 * t + per + 1)
    m_max = -(-max(sizes) // per)
    buf = _words(bits, m_max, bits * 10 + width)
    whole = torch.from_numpy(buf.view(np.int32))
    for offset in range(4):
        oracle = np.asarray(jref.fused_delta_bitpack_decode(
            jnp.asarray(buf[offset: offset + m_max]), bits))
        for n in sizes:
            m = -(-n // per)
            w = whole[offset: offset + m]
            assert w.storage_offset() == offset
            got = ops.fused_delta_bitpack_decode(w, bits, n, width)
            np.testing.assert_array_equal(got.numpy().view(UNSIGNED[width]),
                                          oracle[:n].astype(UNSIGNED[width]))


@pytest.mark.parametrize("bits", BITS)
def test_fused_decode_plain_matches_pallas_interpret(bits):
    """Small n at every width, from words 0-3 words in, against the
    reference's Pallas kernels in interpret mode."""
    per = 32 // bits
    buf = _words(bits, 40, bits)
    whole = torch.from_numpy(buf.view(np.int32))
    for n in (1, per, 33, 37 * per + 1):
        m = -(-n // per)
        for offset in range(4):
            pallas = np.asarray(jops.fused_delta_bitpack_decode(
                jnp.asarray(buf[offset: offset + m]), bits, n))
            for width in WIDTHS:
                got = ops.fused_delta_bitpack_decode(whole[offset: offset + m], bits, n, width)
                np.testing.assert_array_equal(got.numpy().view(UNSIGNED[width]),
                                              pallas.astype(UNSIGNED[width]))
