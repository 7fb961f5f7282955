"""The invariants K15 (Huffman decode) and K10 (tANS decode) lean on, on the CPU.

The two CUDA kernels (``repro_torch/csrc/huffman.cu``, ``fse.cu``) fetch each
lane's bytes ahead of their walk into a ring of 16-byte slots in shared
memory (``LaneRing``, ``csrc/common.cuh``) and shift them through a 64-bit
bit container; K15 copies only the first 2^p entries of its LUT.  This file
pins what that rests on:

- the decode LUT is periodic in 2^L, L the longest code, for every length
  vector the codec builds and for random ones that satisfy Kraft's
  inequality (incomplete ones too), as the reference builds it;
- ``ops.huffman_lut_log`` finds the least period and refuses entries whose
  length the kernel cannot shift by;
- a step-for-step model of each kernel (its ring, with each vector's copy
  round and the rounds a read waits for, its container and K10's clamp),
  run over a buffer whose bytes outside the allocation are junk, equals the
  plain version (``kernels/ref.py``) on every row, reads nothing outside the
  allocation, and never reads a ring word before its copy has landed, for
  lane starts that are unsorted, equal or at the buffer's end, the longest
  lanes, short lanes, and tables from one symbol to table_log 16;
- the plain decoders equal ``repro.kernels.ops`` (plain path and Pallas
  interpret mode) on unsorted and overlapping Huffman lane starts.

The models read the kernels' ring constants from the CUDA sources.  All
integer data, tolerance 0, made with numpy from fixed seeds.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.codecs import entropy as E  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.codecs import entropy as TE  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
M32 = 0xFFFFFFFF


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (cached tables are frozen)


def _ring_constants(source, prefix):
    text = (CSRC / source).read_text()
    return tuple(int(re.search(rf"#define {prefix}_{k} (\d+)", text).group(1))
                 for k in ("RING", "ROUND", "PENDING"))


HUFF = _ring_constants("huffman.cu", "HUFF")
FSE = _ring_constants("fse.cu", "FSE_DEC")


# ------------------------------------------------------------ LUT periodicity
def _kraft_lengths(rng, complete):
    """Random code lengths (1-15) over a random alphabet with sum 2^-l <= 1;
    ``complete`` then hands the unused code space to new symbols."""
    lens = np.zeros(256, np.uint8)
    budget = 1 << 15  # the unused code space, in units of 2^-15
    order = rng.permutation(256)
    k = int(rng.integers(1, 257))
    for s in order[:k]:
        if not budget:
            break
        lens[s] = int(rng.integers(max(1, 16 - budget.bit_length()), 16))
        budget -= 1 << (15 - int(lens[s]))
    for s in order[k:] if complete else ():
        if not budget:
            break
        lens[s] = 16 - budget.bit_length()  # the largest code that fits
        budget -= 1 << (15 - int(lens[s]))
    return lens


def _codec_lengths():
    """Length vectors as the codec builds them from histograms: skewed, one
    symbol, two symbols, 255 symbols, and counts whose code reaches 15 bits."""
    rng = np.random.default_rng(0)
    out = []
    for counts in (
        np.bincount(rng.zipf(1.4, 20000) % 251, minlength=256),
        np.eye(256, dtype=np.int64)[77] * 1000,
        np.bincount([3, 3, 3, 200], minlength=256),
        np.bincount(np.arange(3000) % 255, minlength=256),
        np.array([1 << min(i, 40) for i in range(256)], dtype=np.int64),
    ):
        out.append(TE._huffman_code_lengths(counts.astype(np.int64)))
    return out


def _lut(lens):
    sym, length = TE._huffman_decode_lut(lens)
    return ref.pack_huffman_lut(_t(sym), _t(length.astype(np.int64)))


@pytest.mark.parametrize("case", range(5))
def test_codec_luts_are_periodic_in_their_longest_code(case):
    lens = _codec_lengths()[case]
    want_sym, want_len = E._huffman_decode_lut(lens)  # the reference's LUT
    sym, length = TE._huffman_decode_lut(lens)
    np.testing.assert_array_equal(sym, want_sym)
    np.testing.assert_array_equal(length, want_len)
    lut = _lut(lens)
    top = int(lens.max())
    assert torch.equal(lut.view(-1, 1 << top), lut[: 1 << top].repeat(1 << (15 - top), 1))
    assert ops.huffman_lut_log(lut) <= top


@pytest.mark.parametrize("complete", [False, True])
@pytest.mark.parametrize("seed", range(12))
def test_kraft_luts_are_periodic_in_their_longest_code(seed, complete):
    lens = _kraft_lengths(np.random.default_rng(seed), complete)
    assert (np.ldexp(1.0, -lens[lens > 0].astype(int))).sum() <= 1.0
    want_sym, want_len = E._huffman_decode_lut(lens)
    sym, length = TE._huffman_decode_lut(lens)
    np.testing.assert_array_equal(sym, want_sym)
    np.testing.assert_array_equal(length, want_len)
    lut = _lut(lens)
    top = int(lens.max())
    assert torch.equal(lut.view(-1, 1 << top), lut[: 1 << top].repeat(1 << (15 - top), 1))
    p = ops.huffman_lut_log(lut)
    assert p <= top
    assert torch.equal(lut.view(-1, 1 << p), lut[: 1 << p].repeat(1 << (15 - p), 1))
    if p:  # the least period: half of it is not one
        assert not torch.equal(lut.view(-1, 1 << (p - 1)),
                               lut[: 1 << (p - 1)].repeat(1 << (16 - p), 1))


def test_lut_log_is_kept_until_the_lut_changes():
    lens = np.zeros(256, np.uint8)
    lens[[5, 6, 7]] = [1, 2, 2]
    lut = _lut(lens)
    assert ops.huffman_lut_log(lut) == 2
    assert ops.huffman_lut_log(lut) == 2
    lut[1 << 14] = lut[0] + 1  # no longer periodic below 2^15
    assert ops.huffman_lut_log(lut) == 15
    empty = _lut(np.zeros(256, np.uint8))  # no code: every entry is (0, 0)
    assert ops.huffman_lut_log(empty) == 0


def test_lut_log_refuses_lengths_the_kernel_cannot_shift_by():
    lut = _lut(_codec_lengths()[0])
    lut[3] = 16 << 8
    with pytest.raises(ValueError, match="length"):
        ops.huffman_lut_log(lut)
    lut[3] = -1  # length 255 in the int16 entry
    with pytest.raises(ValueError, match="length"):
        ops.huffman_lut_log(lut)


# -------------------------------------------------------------- kernel models
class _Ring:
    """A lane's ``LaneRing`` (csrc/common.cuh) over a buffer that starts at
    address ``addr0``: which vectors it issues at which round, what each
    slot holds, and, at each read, that the word's vector is in its slot and
    its copy's round has been waited for."""

    def __init__(self, mem, lo, hi, v0, forward, consts, rot):
        self.mem, self.lo, self.hi, self.v0, self.rot = mem, lo, hi, v0, rot
        self.forward = forward
        self.ring, self.round_steps, self.pending = consts
        self.filled = 0
        self.slots = {}

    def fill(self, keep, rnd, most):
        for _ in range(most):
            if self.filled >= keep + self.ring:
                break
            v = self.filled
            a = self.v0 + 16 * v if self.forward else self.v0 - 16 * v
            held = a + 16 > self.lo and a < self.hi
            words = self.mem.words(a) if held else (0, 0, 0, 0)
            slot = ((v if self.forward else ~v) + self.rot) & (self.ring - 1)
            self.slots[slot] = (v, rnd, words)
            self.filled += 1

    def word(self, d, done):
        """Word d, read after the rounds up to ``done`` have been waited for."""
        v = d >> 2
        slot = ((v if self.forward else ~v) + self.rot) & (self.ring - 1)
        held_v, rnd, words = self.slots[slot]
        assert held_v == v, "the ring slot was reused before its vector was read"
        assert rnd == 0 or rnd <= done - self.pending, "a ring word read before its copy landed"
        return words[d & 3] if self.forward else words[3 - (d & 3)]


class _Memory:
    """Device memory around one allocation: the buffer's bytes at ``addr0``
    and junk in the rest of each 16-byte vector; every vector read must hold
    a byte of the allocation."""

    def __init__(self, buf, addr0, seed):
        self.buf, self.addr0 = buf, addr0
        self.junk = np.random.default_rng(seed).integers(0, 256, 64, dtype=np.uint8)

    def byte(self, a):
        k = a - self.addr0
        assert 0 <= k < self.buf.size, "a read outside the allocation"
        return int(self.buf[k])

    def words(self, a):
        k = a - self.addr0
        assert a % 16 == 0 and k + 16 > 0 and k < self.buf.size
        b = [int(self.buf[k + i]) if 0 <= k + i < self.buf.size else int(self.junk[i])
             for i in range(16)]
        return tuple(b[4 * w] | b[4 * w + 1] << 8 | b[4 * w + 2] << 16 | b[4 * w + 3] << 24
                     for w in range(4))


def _rounds(max_rem, round_steps):
    """Step i -> the last round waited for before step i's ring read (round
    0 is the first fill, waited for in full; round k comes before step
    k * round_steps while a whole round of steps remains)."""
    last = max(max_rem // round_steps - 1, 0)
    return lambda i: min(i // round_steps, last)


def _fsr(lo, hi, s):  # __funnelshift_r: the low word of {hi:lo} >> (s & 31)
    return (((hi << 32) | lo) >> (s & 31)) & M32


def _fsl(lo, hi, s):  # __funnelshift_l: the high word of {hi:lo} << (s & 31)
    return ((((hi << 32) | lo) << (s & 31)) >> 32) & M32


def _model_k15(buf, pos, lut, max_rem, addr0=4096, seed=0):
    """K15 step for step (csrc/huffman.cu), lane by lane."""
    lut_log = max(ops.huffman_lut_log(lut), 3)
    raw = lut[: 1 << lut_log].numpy().astype(np.int64) & 0xFFFF
    s_lut = ((raw & 0xFF) << 8) | (raw >> 8)  # len | sym << 8
    mem = _Memory(buf, addr0, seed)
    ring_n, round_steps, _ = HUFF
    done_at = _rounds(max_rem, round_steps)
    out = np.zeros((max_rem, pos.size), np.uint8)
    for lane, p in enumerate(pos.tolist()):
        first = addr0 + (p >> 3)
        ring = _Ring(mem, addr0, addr0 + buf.size, first & ~15, True, HUFF, lane & 7)
        ring.fill(0, 0, ring.ring)
        sbit = ((first & 15) << 3) | (p & 7)
        # the container starts one junk bit before the lane's first bit, and
        # holds at most 63 bits
        if sbit:
            r, d = (sbit - 1) & 31, (sbit - 1) >> 5
            w1 = ring.word(d + 1, 0) if r else 0
            lo, hi = _fsr(ring.word(d, 0), w1, r), w1 >> r
            avail = 64 - r if r else 32
            d += 2 if r else 1
        else:
            w0 = ring.word(0, 0)
            lo, hi, avail, d = (w0 << 1) & M32, w0 >> 31, 33, 1
        w_next = ring.word(d, 0)
        peek = lo
        for i in range(max_rem):
            if i and i % round_steps == 0 and i + round_steps <= max_rem:
                ring.fill(d >> 2, i // round_steps, round_steps // 4)
            e = int(s_lut[(peek & (((1 << lut_log) - 1) << 1)) >> 1])
            peek = _fsr(lo, hi, e)
            hi = hi >> (e & 31)
            avail -= e & 31
            w = w_next if avail < 32 else 0
            assert avail >= 17 and (avail < 32 or w == 0)
            lo = peek | ((w << avail) & M32 if w else 0)
            hi |= w >> (32 - avail) if w else 0
            d += avail < 32
            avail |= 32
            assert avail < 64
            out[i, lane] = e >> 8
            w_next = ring.word(d, done_at(i))
    return out


def _model_k10(buf, lane_base, bitlen, state0, sym, nbb, max_rem, addr0=4096, seed=0):
    """K10 step for step (csrc/fse.cu), lane by lane, on the shared-table
    entry layout up to 2^15 entries and the global one above."""
    total = nbb.numel()
    nbb = nbb.numpy().astype(np.int64)
    sym = sym.numpy().astype(np.int64)
    shared = total <= 1 << 15 and nbb.dtype == torch.int32
    if shared:
        packed = (31 - (nbb & 31)) | (sym << 5) | ((nbb >> 5) << 15)
    mem = _Memory(buf, addr0, seed)
    _ring_n, round_steps, _ = FSE
    done_at = _rounds(max_rem, round_steps)
    out = np.zeros((max_rem, bitlen.size), np.uint8)
    for lane in range(bitlen.size):
        lb = addr0 + int(lane_base[lane])
        bl = int(bitlen[lane])
        top = lb + ((bl - 1) >> 3)
        ring = _Ring(mem, addr0, addr0 + buf.size, top & ~15, False, FSE, lane & 7)
        ring.fill(0, 0, ring.ring)
        f = sum((mem.byte(lb + k) if addr0 <= lb + k < addr0 + buf.size else 0) << (8 * k)
                for k in range(5))
        excess = 31 - (((top & 3) << 3) | ((bl - 1) & 7))
        d = 3 - ((top & 15) >> 2)
        w0 = ring.word(d, 0)
        w1 = ring.word(d + 1, 0) if excess else 0
        dhi, dlo = _fsl(w1, w0, excess), (w1 << excess) & M32
        avail = 64 - excess if excess else 32
        d += 2 if excess else 1
        w_next = ring.word(d, 0)
        c = bl
        state = int(state0[lane])
        v0 = top & ~15
        for i in range(max_rem):
            if i and i % round_steps == 0 and i + round_steps <= max_rem:
                ring.fill(d >> 2, i // round_steps, round_steps // 4)
            if i % round_steps == 0:
                # the kernel finds the cursor from the ring position once a
                # round, and clamps nothing in a round that starts 32 bits a
                # step above the lane's start
                assert 8 * (v0 - lb + 16) - 32 * d + avail == c
                fast = c >= 32 * round_steps and i + round_steps <= max_rem
            if shared:
                e = int(packed[state])
                t_nb, nb, symbol, base = e, ~e & 31, (e >> 5) & 0xFF, (e >> 13) >> 2
            else:
                e = int(nbb[state])
                nb = e & 31
                t_nb, symbol, base = 31 - nb, int(sym[state]), e >> 5
            value = _fsr(dhi >> 1, 0, t_nb)
            c -= nb
            if c < 0:
                assert not fast, "a round without the clamp reached below the lane's start"
                value = ((f >> (c & 7)) & M32) & ((1 << nb) - 1)
            state = base + value
            out[i, lane] = symbol
            dhi, dlo = _fsl(dlo, dhi, nb), (dlo << nb) & M32
            avail -= nb
            if avail < 32:
                assert avail > 0
                dlo |= (w_next << (32 - avail)) & M32
                dhi |= w_next >> avail
                d += 1
            avail |= 32
            assert avail < 64
            w_next = ring.word(d, done_at(i))
    return out


# --------------------------------------------------------- K15 on the model
def _huffman_stream(data, lens=None):
    """The reference's host-encoded lanes (4096 symbols each), padded as
    ``entropy.huffman_lanes`` pads them; returns (buf, data bytes, lane
    starts, lut, max_rem)."""
    if lens is None:
        lens = E._huffman_code_lengths(E._hist_u8(data))
    codes = E._canonical_codes(lens)
    block = 1 << E.BLOCK_LOG
    packed, offs = E._write_bits_blocked(codes[data], lens[data].astype(np.int64), block)
    max_rem = min(data.size, block)
    pad = 16 + ((E.MAX_CODE_LEN * max_rem + 7) >> 3)
    buf = np.zeros(packed.size + pad, np.uint8)
    buf[: packed.size] = packed
    return buf, packed.size, offs[:-1:block].astype(np.int64), _lut(lens), max_rem


def _check_k15(buf, pos, lut, max_rem, addr0=4096):
    want = ref.huffman_decode_lanes(_t(buf), _t(pos), lut, max_rem).numpy()
    np.testing.assert_array_equal(_model_k15(buf, pos, lut, max_rem, addr0), want)
    return want


@pytest.mark.parametrize("addr0", [4096, 4096 + 5, 4096 + 13])
def test_k15_model_on_unsorted_equal_and_end_lane_starts(addr0):
    rng = np.random.default_rng(1)
    data = (rng.zipf(1.3, 3 * 4096 + 517) % 251).astype(np.uint8)
    buf, n_data, pos, lut, max_rem = _huffman_stream(data)
    # and starts 1 bit past a word, where the container takes one word
    starts = np.concatenate([pos[::-1], pos[[1, 1]], [8 * n_data, 8 * n_data - 3, 0, 13],
                             [1, 33, 65, 97]])
    got = _check_k15(buf, starts, lut, max_rem, addr0)
    back = ops.byteunshuffle(_t(got[:, : pos.size][:, ::-1].copy())).reshape(-1)[: data.size]
    np.testing.assert_array_equal(back.numpy(), data)


@pytest.mark.parametrize("max_rem", [1, 2, 3, 4095, 4096])
def test_k15_model_at_every_lane_length(max_rem):
    rng = np.random.default_rng(max_rem)
    data = rng.integers(0, 256, 2 * 4096, dtype=np.uint8)  # ~8 bits a code
    buf, n_data, pos, lut, _ = _huffman_stream(data)
    buf = buf[: n_data + 16 + ((15 * max_rem + 7) >> 3)]  # the glue's pad for this max_rem
    _check_k15(buf, np.concatenate([pos, [8 * n_data]]), lut, max_rem)


@pytest.mark.parametrize("table", ["15-bit code", "L <= 8", "one symbol"])
def test_k15_model_on_every_table_shape(table):
    rng = np.random.default_rng(7)
    if table == "15-bit code":
        counts = np.array([1 << min(i, 40) for i in range(256)], dtype=np.int64)
        lens = TE._huffman_code_lengths(counts)
        assert lens.max() == 15
        # the longest codes only: the fastest a lane can drain its ring
        data = rng.choice(np.flatnonzero(lens == 15), 2 * 4096).astype(np.uint8)
    elif table == "L <= 8":
        data = (rng.zipf(1.2, 2 * 4096) % 40).astype(np.uint8)
        lens = TE._huffman_code_lengths(np.bincount(data, minlength=256).astype(np.int64))
        assert lens.max() <= 8
    else:
        data = np.full(2 * 4096 + 9, 42, np.uint8)
        lens = None
    buf, n_data, pos, lut, max_rem = _huffman_stream(data, lens)
    _check_k15(buf, np.concatenate([pos, [8 * n_data]]), lut, max_rem)


@pytest.mark.parametrize("n", [1, 4095, 4096, 3 * 4096 + 517])
def test_glue_padding_covers_every_bit_a_lane_can_reach(n):
    """``entropy.huffman_lanes`` pads the stream so that a lane started at
    its very end can walk max_rem codes of 15 bits and still read a whole
    32-bit window inside the buffer (the plain version's reads; the kernel's
    read-ahead past the buffer writes zeros)."""
    from repro_torch.core.codec import get_codec
    from repro_torch.core.message import Stream, SType

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    outs, header = get_codec("huffman").run_encode([Stream(_t(data), SType.SERIAL, 1)], {})
    buf, pos, lut, max_rem, n_sym, _stype = TE.huffman_lanes(outs, header)
    n_data = outs[0].raw().numel()
    assert (n_sym, max_rem) == (n, min(n, 4096))
    assert 8 * n_data + 15 * max_rem + 32 <= 8 * buf.numel()
    end = torch.full((3,), 8 * n_data, dtype=torch.int64)
    np.testing.assert_array_equal(  # lanes at the end decode the pad's zeros
        ops.huffman_decode(buf, end, lut, max_rem).numpy(),
        np.repeat(ops.huffman_decode(buf, end[:1], lut, max_rem).numpy(), 3, axis=1))


# --------------------------------------------------------- K10 on the model
def _fse_lanes(table_log, rem, seed):
    """tANS lanes of 1024 symbols, lane k holding rem[k] of them, encoded by
    the port's plain walk with the codec's tables, laid out as
    ``entropy.fse_lanes`` lays them out; returns (args, symbols)."""
    rng = np.random.default_rng(seed)
    n_lanes = len(rem)
    lanes = np.zeros((n_lanes, 1024), np.uint8)
    alphabet = min(200, 1 << (table_log - 1))  # a table of 2^table_log states holds them
    for k, r in enumerate(rem):
        lanes[k, :r] = (rng.zipf(1.25, r) % alphabet).astype(np.uint8)
    counts = np.bincount(lanes.reshape(-1), minlength=256).astype(np.int64)
    norm = TE._normalize_counts(counts, table_log)
    ds, dn, db, enc, nb0, thr, st0 = TE._fse_tables_cached(norm, table_log)
    want_ds, want_dn, want_db, _ = E._build_tables(norm, table_log)  # the reference's
    for a, b in ((ds, want_ds), (dn, want_dn), (db, want_db)):
        np.testing.assert_array_equal(a, b)
    i32 = lambda a: torch.from_numpy(np.array(a, dtype=np.int32))  # noqa: E731
    sym_start, compact = ref.compact_encode_table(i32(norm), i32(enc.reshape(-1)), enc.shape[1])
    vals, nbs, state = ref.fse_encode_lanes(
        _t(lanes.T.copy()), i32(rem), i32(nb0), i32(thr), i32(st0), i32(norm), sym_start,
        compact, enc.shape[1], 1 << table_log)
    goffs, bitlen, byte_off = ref.fse_lane_offsets(nbs)
    stream = ref.pack_bits(vals, goffs, int(byte_off[-1]))[: int(byte_off[-1])]
    buf = torch.cat([stream, torch.zeros(8, dtype=torch.uint8)])
    sym, nbb = ref.pack_fse_table(*(_t(a) for a in (ds, dn, db)))
    lane_base = ref.exclusive_offsets((bitlen + 7) >> 3)[:-1]
    return (buf, lane_base, bitlen, state.to(torch.int32), sym, nbb, 1024), lanes


@pytest.mark.parametrize("table_log", [5, 11, 15, 16])
def test_k10_model_on_short_empty_and_full_lanes(table_log):
    rem = [1024, 1, 2, 1024, 1024, 3, 517]  # lanes of 1 symbol have no bits
    args, lanes = _fse_lanes(table_log, rem, seed=table_log)
    buf, lane_base, bitlen, state0, sym, nbb, max_rem = args
    assert int(bitlen[1]) == 0
    want = ref.fse_decode_lanes(*args).numpy()
    for k, r in enumerate(rem):
        np.testing.assert_array_equal(want[:r, k], lanes[k, :r])
    for addr0 in (4096, 4097, 4098, 4099, 4096 + 7):  # every lane end within a word
        got = _model_k10(buf.numpy(), lane_base.numpy(), bitlen.numpy(), state0.numpy(), sym,
                         nbb, max_rem, addr0)
        np.testing.assert_array_equal(got, want)  # surplus rows too


def test_k10_model_on_wide_step_entries():
    """Above table_log 26 the step entries are int64; the global-table path
    reads them as the narrow ones (checked on a table_log 11 stream)."""
    args, _lanes = _fse_lanes(11, [1024, 700, 2], seed=3)
    buf, lane_base, bitlen, state0, sym8, nbb, max_rem = args
    wide = nbb.to(torch.int64)
    want = ref.fse_decode_lanes(buf, lane_base, bitlen, state0, sym8, wide, max_rem).numpy()
    got = _model_k10(buf.numpy(), lane_base.numpy(), bitlen.numpy(), state0.numpy(), sym8,
                     wide, max_rem)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------- plain decoders against the reference
@pytest.mark.parametrize("use_pallas", [False, True])
def test_plain_huffman_decode_on_unsorted_and_overlapping_starts(use_pallas):
    rng = np.random.default_rng(5)
    n = 3 * 4096 + 300 if not use_pallas else 700
    data = (rng.zipf(1.3, n) % 251).astype(np.uint8)
    buf, n_data, pos, lut, max_rem = _huffman_stream(data)
    if use_pallas:
        max_rem = 300  # interpret mode walks every step in Python
    starts = np.concatenate([pos[::-1], pos[:1], [3, 8 * n_data]]).astype(np.int64)
    got = ops.huffman_decode(_t(buf), _t(starts), lut, max_rem).numpy()
    sym, length = TE._huffman_decode_lut(E._huffman_code_lengths(E._hist_u8(data)))
    want = np.asarray(jops.huffman_decode(
        jnp.asarray(buf), jnp.asarray(starts.astype(np.int32)),
        jnp.asarray(sym.astype(np.int32)), jnp.asarray(length.astype(np.int32)),
        max_rem, use_pallas=use_pallas))
    np.testing.assert_array_equal(got, want)
