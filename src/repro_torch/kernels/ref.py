"""Plain PyTorch versions of the port's kernels and of their glue.

Each function here computes exactly what its CUDA kernel in ``csrc/``
computes (and what the reference's jnp oracle in ``repro/kernels/ref.py``
computes).  ``kernels/ops.py`` takes them for tensors on the CPU, and
``chip_smoke.py`` holds every kernel against them on the card.

The glue — the exclusive bit offsets, the tANS lane
offsets and the bit packer — was XLA glue outside Pallas in the reference;
here it is these PyTorch ops on whatever device the data is on.  The
reference's exact histogram was such glue too; in the port it is K13.

Unsigned arithmetic: PyTorch's ``uint32`` lacks subtraction, shifts and
comparisons, so 32-bit unsigned data is carried as int64 masked to 32 bits,
and wrapping is done in int64 and masked, never left to signed overflow.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.message import PACK_BITS  # noqa: F401  (re-exported: the widths K5-K12 pack)
from ..core.message import join_u32, narrow_unsigned, sub_u64, widen_unsigned

_U32 = 0xFFFFFFFF
# tANS tables: K9 holds X = state + 2^table_log (< 2^(table_log + 1)) in an
# int32, so both sides stop at table_log 30; the packed u32 decode step entry
# nb | base << 5 holds base up to table_log 26, and larger tables take u64
FSE_MAX_TABLE_LOG = 30
FSE_NARROW_TABLE_LOG = 26

# float_split formats: fmt -> (width, exp_bits, man_bits, exp_width, man_width),
# the bytes of a value, of its exponent plane and of its mantissa plane
FLOAT_FORMATS = {
    0: (2, 8, 7, 1, 1),  # bfloat16
    1: (2, 5, 10, 1, 2),  # float16
    2: (4, 8, 23, 1, 4),  # float32
    3: (8, 11, 52, 2, 8),  # float64
}
_SIGN_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)  # np.packbits: the first value in the top bit


# ------------------------------------------------------------------ K1 delta
def delta_encode(x: torch.Tensor) -> torch.Tensor:
    """out[0] = x[0]; out[i] = x[i] - x[i-1] (wrapping, unsigned), any width."""
    w = x.element_size()
    u = widen_unsigned(x)
    if w == 8:
        return torch.cat([u[:1], sub_u64(u[1:], u[:-1])])
    return narrow_unsigned(torch.cat([u[:1], u[1:] - u[:-1]]), w)


# ----------------------------------------------------------- K2 delta decode
def delta_decode(d: torch.Tensor) -> torch.Tensor:
    """x[i] = d[0] + ... + d[i] (wrapping, unsigned), any width.

    Widths 1, 2 and 4 sum exactly in int64 (fewer than 2^31 values below
    2^32) and keep the low bits; width 8 sums its 32-bit halves apart and
    carries the low half's overflow into the high half.
    """
    w = d.element_size()
    if w < 8:
        return narrow_unsigned(torch.cumsum(widen_unsigned(d), 0), w)
    lo = torch.cumsum(d & _U32, 0)
    hi = torch.cumsum((d >> 32) & _U32, 0) + (lo >> 32)
    return join_u32(lo & _U32, hi & _U32)


# ------------------------------------------------------------ K3 byteshuffle
def byteshuffle(x: torch.Tensor) -> torch.Tensor:
    """(n, w) uint8 records -> (w, n) byte planes."""
    return x.t().contiguous()


# ---------------------------------------------------------- K4 byteunshuffle
def byteunshuffle(p: torch.Tensor) -> torch.Tensor:
    """(w, n) uint8 byte planes -> (n, w) records."""
    return p.t().contiguous()


# ------------------------------------------------------------ K14 huffman map
def huffman_map(
    x: torch.Tensor, codes: torch.Tensor, lens: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-symbol (canonical code, code length) table gathers, both int32."""
    xi = x.long()
    return codes[xi], lens[xi]


# ------------------------------------------------------------ K9 tANS encode
def compact_encode_table(
    norm: torch.Tensor, enc_flat: torch.Tensor, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the reference's (256, width) encode table to its live entries.

    Symbol s owns entries [sym_start[s], sym_start[s] + norm[s]), in rank
    order; together they are exactly ``total`` entries.  Returns
    (sym_start int32[256], enc_compact int32[total]).
    """
    live = torch.arange(width, device=norm.device)[None, :] < norm[:, None]
    enc_compact = enc_flat.reshape(256, width)[live].to(torch.int32).contiguous()
    sym_start = (torch.cumsum(norm, 0) - norm).to(torch.int32).contiguous()
    return sym_start, enc_compact


def fse_encode_lanes(
    lanesT: torch.Tensor,
    rem: torch.Tensor,
    nb0: torch.Tensor,
    thr: torch.Tensor,
    st0: torch.Tensor,
    norm: torch.Tensor,
    sym_start: torch.Tensor,
    enc_compact: torch.Tensor,
    width: int,
    total: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tANS backward state walk, every lane at once, one position per step.

    ``lanesT`` is (max_rem, n_lanes) symbols; a lane of length r starts its
    state at position r-1 and emits the low bits of ``X = state + total`` for
    every earlier position, then steps through the compact encode table
    (:func:`compact_encode_table`).  Returns the (vals, nbits) planes, int32,
    and the final lane states, int32.
    """
    max_rem, n_lanes = lanesT.shape
    dev = lanesT.device
    nb0, thr, st0, norm, sym_start, enc, rem = (
        t.to(torch.int64) for t in (nb0, thr, st0, norm, sym_start, enc_compact, rem)
    )
    vals = torch.zeros((max_rem, n_lanes), dtype=torch.int32, device=dev)
    nbs = torch.zeros((max_rem, n_lanes), dtype=torch.int32, device=dev)
    state = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    one = torch.ones(n_lanes, dtype=torch.int64, device=dev)
    for i in range(max_rem - 1, -1, -1):
        s = lanesT[i].long()
        emit = rem > i + 1
        X = state + total
        nb = nb0[s] - (X < thr[s]).long()
        nbe = torch.where(emit, nb, 0)
        vals[i] = (X & ((one << nbe) - 1)).to(torch.int32)
        nbs[i] = nbe.to(torch.int32)
        # clip as the reference does; its table is zero past norm[s]
        xprime = ((X >> nb) - norm[s]).clamp(0, width - 1)
        idx = (sym_start[s] + xprime).clamp(max=total - 1)
        new_state = torch.where(xprime < norm[s], enc[idx], 0)
        state = torch.where(emit, new_state, torch.where(rem == i + 1, st0[s], state))
    return vals, nbs, state.to(torch.int32)


# -------------------------------------------------------------- K16 refill
def _refill(buf: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """int64 windows in [0, 2^32): the 32 bits of ``buf`` at each bit cursor."""
    byte0 = bitpos >> 3
    r = bitpos & 7
    b = [buf[byte0 + k].to(torch.int64) for k in range(5)]
    lo = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
    return ((lo >> r) | (b[4] << (32 - r))) & _U32


def lane_refill(buf: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """The LSB-first 32-bit window of ``buf`` at each int64 bit cursor.

    ``buf`` must hold five readable bytes past every cursor.  Returns the
    windows' uint32 bits in an int32 tensor.
    """
    return narrow_unsigned(_refill(buf, bitpos.to(torch.int64)), 4)


# ------------------------------------------------------- K15 huffman decode
def pack_huffman_lut(lut_sym: torch.Tensor, lut_len: torch.Tensor) -> torch.Tensor:
    """The 2^15-entry decode LUT packed as int16 ``symbol | length << 8``."""
    return (lut_sym.to(torch.int32) | (lut_len.to(torch.int32) << 8)).to(torch.int16)


def huffman_decode_lanes(
    buf: torch.Tensor, pos: torch.Tensor, lut: torch.Tensor, max_rem: int
) -> torch.Tensor:
    """Lane-parallel Huffman decode, one symbol per 32-bit refill.

    ``buf`` is the bitstream padded past every cursor (16 + (15 * max_rem + 7)
    // 8 zero bytes), ``pos`` each lane's first bit, ``lut`` the packed LUT
    (:func:`pack_huffman_lut`).  Returns (max_rem, n_lanes) uint8; the
    surplus rows of a short lane decode the pad's zeros.
    """
    n_lanes = pos.numel()
    out = torch.empty((max_rem, n_lanes), dtype=torch.uint8, device=buf.device)
    p = pos.to(torch.int64)
    table = lut.to(torch.int64)
    for i in range(max_rem):
        e = table[_refill(buf, p) & 0x7FFF]
        out[i] = (e & 0xFF).to(torch.uint8)
        p = p + (e >> 8)
    return out


# ---------------------------------------------------------- K10 tANS decode
def pack_fse_table(
    dec_sym: torch.Tensor,
    dec_nb: torch.Tensor,
    dec_base: torch.Tensor,
    wide: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode tables as (symbol uint8, step entry ``nb | base << 5``) per state.

    ``nb <= table_log`` takes five bits and ``base < 2^table_log`` the rest:
    the entry is int32 up to table_log 26 (``FSE_NARROW_TABLE_LOG``) and
    int64 above it (``wide``, which defaults to the table's size).
    """
    if wide is None:
        wide = dec_sym.numel() > 1 << FSE_NARROW_TABLE_LOG
    step = torch.int64 if wide else torch.int32
    return dec_sym.to(torch.uint8), dec_nb.to(step) | (dec_base.to(step) << 5)


def fse_decode_lanes(
    buf: torch.Tensor,
    lane_base: torch.Tensor,
    bitlen: torch.Tensor,
    state0: torch.Tensor,
    sym: torch.Tensor,
    nbb: torch.Tensor,
    max_rem: int,
) -> torch.Tensor:
    """Lane-parallel tANS decode: forward symbol order, backward bit reads.

    Lane k reads ``buf`` from byte ``lane_base[k]``; its cursor starts at
    ``bitlen[k]`` and walks backward, and a cursor below 0 reads byte 0 at
    bit ``cursor & 7``, as the reference clamps it.  ``sym`` and ``nbb`` are
    the decode tables (:func:`pack_fse_table`).  Returns (max_rem, n_lanes) uint8;
    surplus rows walk states that stay in the table.
    """
    n_lanes = bitlen.numel()
    out = torch.empty((max_rem, n_lanes), dtype=torch.uint8, device=buf.device)
    tab = nbb.to(torch.int64)
    state = state0.to(torch.int64)
    cursor = bitlen.to(torch.int64)
    base_bits = lane_base.to(torch.int64) * 8
    one = torch.ones_like(cursor)
    for i in range(max_rem):
        e = tab[state]
        out[i] = sym[state]
        nb = e & 0x1F
        cursor = cursor - nb
        win = _refill(buf, base_bits + torch.where(cursor >= 0, cursor, cursor & 7))
        state = (e >> 5) + (win & ((one << nb) - 1))
    return out


# ------------------------------------------------------------ K7 float split
def float_split(
    u: torch.Tensor, fmt: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bit patterns of ``fmt`` (int16 / int32 / int64 carrier) -> planes.

    Returns the sign bits packed as ``np.packbits`` packs them (uint8,
    ceil(n / 8) bytes), the exponent plane (uint8, or int16 for float64) and
    the mantissa plane (the carrier of ``man_width`` bytes).  The carrier is
    signed, so every field is masked after its shift: an arithmetic shift's
    copies of the sign bit never reach a plane.
    """
    _width, exp_bits, man_bits, exp_width, man_width = FLOAT_FORMATS[fmt]
    v = widen_unsigned(u)  # int64: the unsigned value, or the 64-bit pattern
    sign = (v >> (exp_bits + man_bits)) & 1
    exp = (v >> man_bits) & ((1 << exp_bits) - 1)
    man = v & ((1 << man_bits) - 1)
    bits = torch.cat([sign, sign.new_zeros((-sign.numel()) % 8)]).view(-1, 8)
    shifts = torch.tensor(_SIGN_SHIFTS, dtype=torch.int64, device=u.device)
    packed = (bits << shifts).sum(1).to(torch.uint8)
    return packed, narrow_unsigned(exp, exp_width), narrow_unsigned(man, man_width)


# ------------------------------------------------------------ K8 float merge
def float_merge(
    sign: torch.Tensor, exp: torch.Tensor, man: torch.Tensor, fmt: int
) -> torch.Tensor:
    """(packed sign bits, exponent, mantissa) -> the bit patterns of ``fmt``.

    ``(sign << (exp_bits + man_bits)) | (exp << man_bits) | man`` on the
    unsigned values, cut to the format's width, with no plane masked — what
    the codec's decoder computes.  ``n`` is the mantissa plane's length;
    ``sign`` holds at least ceil(n / 8) bytes.
    """
    width, exp_bits, man_bits, _exp_width, _man_width = FLOAT_FORMATS[fmt]
    n = man.numel()
    shifts = torch.tensor(_SIGN_SHIFTS, dtype=torch.int64, device=sign.device)
    bytes_ = sign[: (n + 7) // 8].to(torch.int64)
    s = ((bytes_[:, None] >> shifts[None, :]) & 1).reshape(-1)[:n]
    u = (s << (exp_bits + man_bits)) | (widen_unsigned(exp) << man_bits) | widen_unsigned(man)
    return narrow_unsigned(u, width)


# ---------------------------------------------------------------- K13 histogram
def histogram_exact(x: torch.Tensor) -> torch.Tensor:
    """256-bin byte histogram with integer counts (int64), exact at any size."""
    return torch.bincount(x, minlength=256)


# ---------------------------------------------------- K5 / K6 bitpack, unpack
def _words(u: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 values (< 2^32) -> int32 words of 32 // bits values each, LSB-first.

    The sum of the shifted values mod 2^32, as the reference sums them (the
    bitwise OR when every value fits ``bits``); slots past the values are 0.
    """
    per = 32 // bits
    n = u.numel()
    m = -(-n // per)
    v = torch.zeros(m * per, dtype=torch.int64, device=u.device)
    v[:n] = u
    shifts = torch.arange(per, dtype=torch.int64, device=u.device) * bits
    return narrow_unsigned(((v.view(m, per) << shifts) & _U32).sum(1), 4)


def bitpack(x: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 / int16 / int32 values, read unsigned -> int32 words (``PACK_BITS``)."""
    return _words(widen_unsigned(x), bits)


def bitunpack(w: torch.Tensor, bits: int, n: int, width: int = 4) -> torch.Tensor:
    """The first n values of int32 words packed at ``bits``, in the carrier of
    ``width`` bytes (each value cut to that width)."""
    per = 32 // bits
    u = widen_unsigned(w[: -(-n // per)])
    shifts = torch.arange(per, dtype=torch.int64, device=w.device) * bits
    vals = ((u[:, None] >> shifts) & ((1 << bits) - 1)).reshape(-1)[:n]
    return narrow_unsigned(vals, width)


# ------------------------------------------- K11 / K12 fused delta + bitpack
def fused_delta_bitpack(x: torch.Tensor, bits: int) -> torch.Tensor:
    """d[i] = (x[i] - x[i-1]) mod 2^32 with x[-1] = 0, masked to ``bits``,
    then packed as :func:`bitpack`; x is uint8 / int16 / int32, read unsigned.
    2^bits divides 2^64, so masking the int64 difference equals masking it
    mod 2^32."""
    u = widen_unsigned(x)
    d = torch.cat([u[:1], u[1:] - u[:-1]]) & ((1 << bits) - 1)
    return _words(d, bits)


def fused_delta_bitpack_decode(
    w: torch.Tensor, bits: int, n: int, width: int = 4
) -> torch.Tensor:
    """Unpack n deltas, then their inclusive prefix sum mod 2^32, cut to the
    carrier of ``width`` bytes (n < 2^31 values below 2^32 sum exactly in int64)."""
    d = widen_unsigned(bitunpack(w, bits, n))
    return narrow_unsigned(torch.cumsum(d, 0), width)


def exclusive_offsets(nbits: torch.Tensor) -> torch.Tensor:
    """int64 bit offsets [n+1]: offs[i] = sum(nbits[:i]); offs[-1] is the total."""
    offs = torch.zeros(nbits.numel() + 1, dtype=torch.int64, device=nbits.device)
    offs[1:] = torch.cumsum(nbits, 0, dtype=torch.int64)
    return offs


def fse_lane_offsets(
    nbs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wire placement of every tANS emission, all int64.

    Emission order is decreasing position, so an emission's offset inside
    its lane is the suffix sum of later positions' bit counts; lanes are
    concatenated at byte granularity.  Returns (global bit offsets planes,
    per-lane bit lengths, lane byte offsets [n_lanes+1]).
    """
    nbs = nbs.to(torch.int64)
    bitpos = nbs.sum(0)
    suffix = torch.flip(torch.cumsum(torch.flip(nbs, [0]), 0), [0])
    intra = suffix - nbs
    byte_off = exclusive_offsets((bitpos + 7) >> 3)
    goffs = byte_off[None, :-1] * 8 + intra
    return goffs, bitpos, byte_off


def pack_bits(vals: torch.Tensor, offs: torch.Tensor, total_bytes: int) -> torch.Tensor:
    """Place pre-masked values (< 2^32) LSB-first at int64 bit offsets -> uint8.

    The device twin of the host codecs' bit writer.  Each value, shifted to
    its offset inside a 32-bit word, spans at most two words; both halves are
    scatter-added into int64 words.  Every output bit has exactly one writer,
    so no add ever carries: the sum equals the bitwise OR, in any order.
    """
    dev = vals.device
    n_words = (total_bytes + 3) // 4 + 2
    words = torch.zeros(n_words, dtype=torch.int64, device=dev)
    if vals.numel():
        v = vals.reshape(-1).to(torch.int64) << (offs.reshape(-1) & 31)
        w0 = offs.reshape(-1) >> 5
        words.index_add_(0, w0, v & _U32)
        words.index_add_(0, w0 + 1, v >> 32)
    # low 4 bytes of each little-endian int64 word are the 32-bit word
    return words.view(torch.uint8).view(-1, 8)[:, :4].reshape(-1)[:total_bytes]
