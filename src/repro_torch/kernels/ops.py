"""Wrappers around the port's CUDA kernels, with launch counters.

Each wrapper checks its tensors, allocates the outputs with ``torch.empty``
and launches its kernel on the current CUDA stream.  It takes its kernel's
plain PyTorch version (``kernels/ref.py``) only for tensors that lie on the
CPU; for a CUDA tensor it launches the kernel or raises — there is no
fallback and no size window.  ``<wrapper>.launches`` counts the launches
made by this process (reset with :func:`reset_launches`), counted under a
lock, since a session's pool launches from many threads.

Kernels and the TPU kernels they replace:

  ==============================  ======================================================================
  wrapper                         TPU kernel (``src/repro/kernels``)
  ==============================  ======================================================================
  ``delta_encode``                ``delta.py`` ``delta_encode_pallas`` (K1)
  ``delta_decode``                ``delta.py`` ``delta_decode_pallas`` (K2)
  ``byteshuffle``                 ``byteshuffle.py`` ``byteshuffle_pallas`` (K3)
  ``byteunshuffle``               ``byteshuffle.py`` ``byteunshuffle_pallas`` (K4)
  ``bitpack``                     ``bitpack.py`` ``bitpack_pallas`` (K5)
  ``bitunpack``                   ``bitpack.py`` ``bitunpack_pallas`` (K6)
  ``float_split``                 ``float_split.py`` ``float_split_pallas`` (K7)
  ``float_merge``                 ``float_split.py`` ``float_merge_pallas`` (K8)
  ``fse_encode``                  ``fse.py`` ``fse_encode_pallas`` (K9)
  ``fse_decode``                  ``fse.py`` ``fse_decode_pallas`` (K10)
  ``fused_delta_bitpack``         ``fused_delta_bitpack.py`` ``fused_delta_bitpack_pallas`` (K11)
  ``fused_delta_bitpack_decode``  ``fused_delta_bitpack.py`` ``fused_delta_bitpack_decode_pallas`` (K12)
  ``histogram``                   ``histogram.py`` ``histogram_pallas`` (K13)
  ``huffman_map``                 ``huffman.py`` ``huffman_map_pallas`` (K14)
  ``huffman_decode``              ``huffman.py`` ``huffman_decode_pallas`` (K15)
  ``lane_refill``                 ``lane_refill.py`` ``lane_refill_pallas`` (K16)
  ==============================  ======================================================================

K16's body, ``refill32``, runs only in its own launch (``csrc/lane_refill.cu``):
K15 and K10 fetch each lane's bytes ahead of their walk instead.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from ..core.message import CARRIER
from . import ref

KERNELS = (
    "delta_encode", "byteshuffle", "huffman_map", "fse_encode",
    "delta_decode", "byteunshuffle", "huffman_decode", "fse_decode", "lane_refill",
    "float_split", "float_merge", "histogram",
    "bitpack", "bitunpack", "fused_delta_bitpack", "fused_delta_bitpack_decode",
)
HUFFMAN_LUT_ENTRIES = 1 << 15
MAX_CODE_LEN = 15


def _lib():
    from ._build import library

    return library()


class KernelError(RuntimeError):
    """A wrapper's precondition on where or how its tensors lie (their
    device, contiguity or alignment) failed.

    A fault of the caller, never a codec's refusal of its data: it is not a
    ``ValueError``, so neither a selector trial nor the chunked path's
    fresh resolve, which catch only a codec's ``ValueError``, can hide it.
    """


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors; raise for any device but CPU or CUDA."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise KernelError(f"tensors on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise KernelError(f"repro_torch kernels run on cuda or cpu tensors, not {dev}")
    return False


def _need(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise KernelError(f"{what}: tensor must be contiguous")


def _launched(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# a session's pool launches from many threads: each count is one locked
# read-modify-write
_LAUNCHES_LOCK = threading.Lock()


def _count(wrapper) -> None:
    with _LAUNCHES_LOCK:
        wrapper.launches += 1


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in KERNELS:
            globals()[name].launches = 0


def launch_counts() -> Dict[str, int]:
    with _LAUNCHES_LOCK:
        return {name: globals()[name].launches for name in KERNELS}


# ------------------------------------------------------------------ K1 delta
def delta_encode(x: torch.Tensor) -> torch.Tensor:
    """Wrapping first difference of a 1-D uint8/int16/int32/int64 carrier."""
    if x.dim() != 1 or x.element_size() not in (1, 2, 4, 8) or x.is_floating_point():
        raise TypeError(f"delta_encode: 1-D integer tensor of width 1/2/4/8, got {x.dtype}")
    if _on_cpu(x):
        return ref.delta_encode(x)
    _need(x, x.dtype, "delta_encode")
    out = torch.empty_like(x)
    if x.numel():
        _launched(
            _lib().repro_delta_encode(
                x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(), _stream(x)
            ),
            "delta_encode",
        )
        _count(delta_encode)
    return out


delta_encode.launches = 0


# ----------------------------------------------------------- K2 delta decode
def delta_decode(d: torch.Tensor) -> torch.Tensor:
    """Wrapping inclusive prefix sum of a 1-D uint8/int16/int32/int64 carrier."""
    if d.dim() != 1 or d.element_size() not in (1, 2, 4, 8) or d.is_floating_point():
        raise TypeError(f"delta_decode: 1-D integer tensor of width 1/2/4/8, got {d.dtype}")
    if _on_cpu(d):
        return ref.delta_decode(d)
    _need(d, d.dtype, "delta_decode")
    n = d.numel()
    out = torch.empty_like(d)
    if n:
        lib = _lib()
        w = d.element_size()
        scratch = torch.empty(lib.repro_delta_decode_scratch(n, w), dtype=torch.uint8,
                              device=d.device)
        _launched(
            lib.repro_delta_decode(
                d.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, w,
                _stream(d),
            ),
            "delta_decode",
        )
        _count(delta_decode)
    return out


delta_decode.launches = 0


def delta_decode_tile(width: int) -> int:
    """Elements of one tile of the card's K2 at ``width`` bytes."""
    from ._build import DELTA_TILE_BYTES

    return DELTA_TILE_BYTES // width


# ------------------------------------------------------------ K3 byteshuffle
# K3's paths (csrc/byteshuffle.cu SHUFFLE_*): 16-byte vectors transposed in
# registers for w of 1, 2, 4 and 8, a 128 x 128 shared tile for multiples of
# 16 (the tANS lanes' 1024), byte-wise tiles for any other w
SHUFFLE_NARROW, SHUFFLE_WIDE, SHUFFLE_BYTES = 0, 1, 2


def byteshuffle_path(w: int) -> int:
    """The K3 path that records of ``w`` bytes take on the card, at any n and
    any input offset."""
    if w in (1, 2, 4, 8):
        return SHUFFLE_NARROW
    return SHUFFLE_WIDE if w % 16 == 0 else SHUFFLE_BYTES


def byteshuffle(x: torch.Tensor) -> torch.Tensor:
    """(n, w) uint8 records -> (w, n) byte planes, for any w >= 1."""
    if x.dim() != 2:
        raise ValueError(f"byteshuffle: (n, w) tensor expected, got {tuple(x.shape)}")
    if _on_cpu(x):
        return ref.byteshuffle(x)
    _need(x, torch.uint8, "byteshuffle")
    n, w = x.shape
    out = torch.empty((w, n), dtype=torch.uint8, device=x.device)
    if x.numel():
        _launched(
            _lib().repro_byteshuffle(
                x.data_ptr(), out.data_ptr(), n, w, byteshuffle_path(w), _stream(x)
            ),
            "byteshuffle",
        )
        _count(byteshuffle)
    return out


byteshuffle.launches = 0


# ---------------------------------------------------------- K4 byteunshuffle
def byteunshuffle(p: torch.Tensor) -> torch.Tensor:
    """(w, n) uint8 planes -> (n, w) records, for any w >= 1."""
    if p.dim() != 2:
        raise ValueError(f"byteunshuffle: (w, n) tensor expected, got {tuple(p.shape)}")
    if _on_cpu(p):
        return ref.byteunshuffle(p)
    _need(p, torch.uint8, "byteunshuffle")
    w, n = p.shape
    out = torch.empty((n, w), dtype=torch.uint8, device=p.device)
    if p.numel():
        _launched(
            _lib().repro_byteunshuffle(p.data_ptr(), out.data_ptr(), w, n, _stream(p)),
            "byteunshuffle",
        )
        _count(byteunshuffle)
    return out


byteunshuffle.launches = 0


# ------------------------------------------------------------ K14 huffman map
def huffman_map(
    x: torch.Tensor, codes: torch.Tensor, lens: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symbols -> (canonical code int32, code length int32) per symbol."""
    if x.dim() != 1 or codes.shape != (256,) or lens.shape != (256,):
        raise ValueError("huffman_map: 1-D symbols and 256-entry tables expected")
    if _on_cpu(x, codes, lens):
        return ref.huffman_map(x, codes, lens)
    _need(x, torch.uint8, "huffman_map symbols")
    _need(codes, torch.int32, "huffman_map codes")
    _need(lens, torch.int32, "huffman_map lens")
    n = x.numel()
    code = torch.empty(n, dtype=torch.int32, device=x.device)
    nbits = torch.empty(n, dtype=torch.int32, device=x.device)
    if n:
        _launched(
            _lib().repro_huffman_map(
                x.data_ptr(), codes.data_ptr(), lens.data_ptr(),
                code.data_ptr(), nbits.data_ptr(), n, _stream(x),
            ),
            "huffman_map",
        )
        _count(huffman_map)
    return code, nbits


huffman_map.launches = 0


# ------------------------------------------------------------ K9 tANS encode
def fse_encode(
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
    """tANS backward lane walk -> (vals int32, nbits int32) planes + final states.

    ``lanesT`` is (max_rem, n_lanes) uint8, ``rem`` the int32 lane lengths,
    the per-symbol tables int32[256], and the encode table in its compact
    form (``ref.compact_encode_table``: ``total`` entries, located per
    symbol by ``sym_start``), which the kernel holds in shared memory up to
    2^15 entries and reads from global memory above.  ``width`` is the
    reference table's row length, the largest norm.  The card computes the
    plain walk for tables as the codec builds them
    (``codecs.entropy._fse_tables_cached``: nb0 = table_log + 1 -
    bit_length(norm), thr = norm << nb0, st0[s] = enc[s][0], states in [0,
    total)); it reads neither ``st0`` nor ``width``, which those tables fix.
    """
    max_rem, n_lanes = lanesT.shape
    tables = (nb0, thr, st0, norm, sym_start)
    if rem.shape != (n_lanes,) or any(t.shape != (256,) for t in tables):
        raise ValueError("fse_encode: rem[n_lanes] and 256-entry tables expected")
    if enc_compact.shape != (total,):
        raise ValueError("fse_encode: the compact encode table holds total entries")
    if width < 1:
        raise ValueError(f"fse_encode: the encode table's width must be >= 1, got {width}")
    if _on_cpu(lanesT, rem, enc_compact, *tables):
        return ref.fse_encode_lanes(
            lanesT, rem, nb0, thr, st0, norm, sym_start, enc_compact, width, total
        )
    _need(lanesT, torch.uint8, "fse_encode lanes")
    for t in (rem, enc_compact, *tables):
        _need(t, torch.int32, "fse_encode tables")
    vals = torch.empty((max_rem, n_lanes), dtype=torch.int32, device=lanesT.device)
    nbs = torch.empty((max_rem, n_lanes), dtype=torch.int32, device=lanesT.device)
    state = torch.empty(n_lanes, dtype=torch.int32, device=lanesT.device)
    if n_lanes:
        _launched(
            _lib().repro_fse_encode(
                lanesT.data_ptr(), rem.data_ptr(), nb0.data_ptr(), thr.data_ptr(),
                st0.data_ptr(), norm.data_ptr(), sym_start.data_ptr(),
                enc_compact.data_ptr(), vals.data_ptr(), nbs.data_ptr(),
                state.data_ptr(), max_rem, n_lanes, total, width, _stream(lanesT),
            ),
            "fse_encode",
        )
        _count(fse_encode)
    return vals, nbs, state


fse_encode.launches = 0


# -------------------------------------------------------- K15 huffman decode
def huffman_decode(
    buf: torch.Tensor, pos: torch.Tensor, lut: torch.Tensor, max_rem: int
) -> torch.Tensor:
    """Lane-parallel Huffman decode -> (max_rem, n_lanes) uint8 symbols.

    ``buf`` is the uint8 bitstream padded with zeros past every cursor (the
    decoder pads by 16 + (15 * max_rem + 7) // 8 bytes), ``pos`` the lanes'
    int64 first bits, ``lut`` the int16 decode LUT of 2^15 entries
    (``ref.pack_huffman_lut``).  The kernel copies only the LUT's least
    period into each block (:func:`huffman_lut_log`).
    """
    if buf.dim() != 1 or pos.dim() != 1 or lut.shape != (HUFFMAN_LUT_ENTRIES,):
        raise ValueError("huffman_decode: 1-D buffer and cursors, 2^15-entry LUT expected")
    if max_rem < 0:
        raise ValueError("huffman_decode: max_rem must be >= 0")
    if _on_cpu(buf, pos, lut):
        return ref.huffman_decode_lanes(buf, pos, lut, max_rem)
    _need(buf, torch.uint8, "huffman_decode bitstream")
    _need(pos, torch.int64, "huffman_decode cursors")
    _need(lut, torch.int16, "huffman_decode LUT")
    if lut.data_ptr() % 16:
        raise KernelError("huffman_decode: the LUT must be 16-byte aligned")
    n_lanes = pos.numel()
    out = torch.empty((max_rem, n_lanes), dtype=torch.uint8, device=buf.device)
    if n_lanes and max_rem:
        _launched(
            _lib().repro_huffman_decode(
                buf.data_ptr(), buf.numel(), pos.data_ptr(), lut.data_ptr(),
                max(huffman_lut_log(lut), 3), out.data_ptr(), max_rem, n_lanes, _stream(buf),
            ),
            "huffman_decode",
        )
        _count(huffman_decode)
    return out


huffman_decode.launches = 0


def huffman_lut_log(lut: torch.Tensor) -> int:
    """The least p with ``lut[i] == lut[i % 2^p]`` for every i.

    A canonical LSB-first LUT whose longest code has L bits has p <= L, so
    K15 copies only its first 2^p entries.  Raises ``ValueError`` for an
    entry whose length is above 15 (the kernel shifts by an entry's low five
    bits).  Found once per LUT tensor, with one synchronisation, and kept on
    the tensor until it is written to.
    """
    known = getattr(lut, "_repro_lut_log", None)
    if known is not None and known[0] == lut._version:
        return known[1]
    lengths = (lut.to(torch.int32) & 0xFFFF) >> 8
    checks = [lengths.max() <= MAX_CODE_LEN]
    checks += [(lut.view(-1, 1 << p) == lut[: 1 << p]).all() for p in range(16)]
    ok, *periodic = torch.stack(checks).tolist()
    if not ok:
        raise ValueError(f"huffman_decode: a LUT entry's length is above {MAX_CODE_LEN}")
    log = periodic.index(True)
    lut._repro_lut_log = (lut._version, log)
    return log


# ----------------------------------------------------------- K10 tANS decode
def fse_decode(
    buf: torch.Tensor,
    lane_base: torch.Tensor,
    bitlen: torch.Tensor,
    state0: torch.Tensor,
    sym: torch.Tensor,
    nbb: torch.Tensor,
    max_rem: int,
) -> torch.Tensor:
    """Lane-parallel tANS decode -> (max_rem, n_lanes) uint8 symbols.

    ``buf`` is the concatenated lane bitstreams padded by 8 zero bytes,
    ``lane_base`` each lane's int64 byte offset, ``bitlen`` its int64 bit
    length, ``state0`` its int32 final encoder state, and ``sym`` (uint8)
    and ``nbb`` (int32 up to table_log 26, int64 above) the decode tables of
    2^table_log entries (``ref.pack_fse_table``).  The kernel holds int32
    tables of up to 2^15 entries in shared memory and reads larger ones from
    global memory.
    """
    n_lanes = bitlen.numel()
    total = nbb.numel()
    if buf.dim() != 1 or bitlen.dim() != 1 or any(
        t.shape != (n_lanes,) for t in (lane_base, state0)
    ):
        raise ValueError("fse_decode: 1-D buffer and n_lanes-long lane vectors expected")
    if (
        nbb.dim() != 1 or sym.shape != nbb.shape or total & (total - 1)
        or not 1 <= total <= 1 << ref.FSE_MAX_TABLE_LOG or max_rem < 0
    ):
        raise ValueError("fse_decode: two 2^table_log-entry tables and max_rem >= 0 expected")
    if nbb.dtype == torch.int32 and total > 1 << ref.FSE_NARROW_TABLE_LOG:
        raise ValueError("fse_decode: above table_log 26 the step entries are int64")
    if _on_cpu(buf, lane_base, bitlen, state0, sym, nbb):
        return ref.fse_decode_lanes(buf, lane_base, bitlen, state0, sym, nbb, max_rem)
    _need(buf, torch.uint8, "fse_decode bitstream")
    for t, what in ((lane_base, "lane offsets"), (bitlen, "bit lengths")):
        _need(t, torch.int64, f"fse_decode {what}")
    _need(state0, torch.int32, "fse_decode states")
    _need(sym, torch.uint8, "fse_decode symbol table")
    _need(nbb, torch.int64 if nbb.dtype == torch.int64 else torch.int32, "fse_decode step table")
    out = torch.empty((max_rem, n_lanes), dtype=torch.uint8, device=buf.device)
    if n_lanes and max_rem:
        _launched(
            _lib().repro_fse_decode(
                buf.data_ptr(), buf.numel(), lane_base.data_ptr(), bitlen.data_ptr(),
                state0.data_ptr(), sym.data_ptr(), nbb.data_ptr(), out.data_ptr(), max_rem,
                n_lanes, total, nbb.element_size(), _stream(buf),
            ),
            "fse_decode",
        )
        _count(fse_decode)
    return out


fse_decode.launches = 0


# ---------------------------------------------------------------- K16 refill
def lane_refill(buf: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """The LSB-first 32-bit window at each int64 bit cursor (uint32 bits, int32).

    ``buf`` must hold five readable bytes past every cursor.
    """
    if buf.dim() != 1 or bitpos.dim() != 1:
        raise ValueError("lane_refill: 1-D buffer and cursors expected")
    if _on_cpu(buf, bitpos):
        return ref.lane_refill(buf, bitpos)
    _need(buf, torch.uint8, "lane_refill bitstream")
    _need(bitpos, torch.int64, "lane_refill cursors")
    n = bitpos.numel()
    out = torch.empty(n, dtype=torch.int32, device=buf.device)
    if n:
        _launched(
            _lib().repro_lane_refill(
                buf.data_ptr(), bitpos.data_ptr(), out.data_ptr(), n, _stream(buf)
            ),
            "lane_refill",
        )
        _count(lane_refill)
    return out


lane_refill.launches = 0


# ------------------------------------------------------- K7 / K8 float split
def _float_planes(fmt: int) -> Tuple[int, int, int, int, int]:
    if fmt not in ref.FLOAT_FORMATS:
        raise ValueError(f"float_split: unknown fmt {fmt}; formats {sorted(ref.FLOAT_FORMATS)}")
    return ref.FLOAT_FORMATS[fmt]


def float_split(u: torch.Tensor, fmt: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bit patterns of ``fmt`` -> (packed sign bits uint8, exponent, mantissa).

    ``u`` is the int16 / int32 / int64 carrier of the format's width; the
    planes come in the carriers of their widths (``ref.FLOAT_FORMATS``).
    """
    width, exp_bits, man_bits, exp_width, man_width = _float_planes(fmt)
    if u.dim() != 1 or u.element_size() != width or u.is_floating_point():
        raise TypeError(f"float_split: 1-D integer carrier of width {width}, got {u.dtype}")
    if _on_cpu(u):
        return ref.float_split(u, fmt)
    _need(u, CARRIER[width], "float_split bit patterns")
    n = u.numel()
    sign = torch.empty((n + 7) // 8, dtype=torch.uint8, device=u.device)
    exp = torch.empty(n, dtype=CARRIER[exp_width], device=u.device)
    man = torch.empty(n, dtype=CARRIER[man_width], device=u.device)
    if n:
        _launched(
            _lib().repro_float_split(
                u.data_ptr(), sign.data_ptr(), exp.data_ptr(), man.data_ptr(), n,
                width, exp_width, man_width, exp_bits, man_bits, _stream(u),
            ),
            "float_split",
        )
        _count(float_split)
    return sign, exp, man


float_split.launches = 0


def float_merge(
    sign: torch.Tensor, exp: torch.Tensor, man: torch.Tensor, fmt: int
) -> torch.Tensor:
    """(packed sign bits, exponent, mantissa) -> the format's bit patterns.

    The planes are K7's outputs: ``exp`` and ``man`` of one length n in the
    carriers of the format's plane widths, ``sign`` at least ceil(n / 8) bytes.
    """
    width, exp_bits, man_bits, exp_width, man_width = _float_planes(fmt)
    n = man.numel()
    if sign.dim() != 1 or exp.shape != (n,) or man.dim() != 1 or sign.numel() < (n + 7) // 8:
        raise ValueError("float_merge: ceil(n / 8) sign bytes and two n-long planes expected")
    if _on_cpu(sign, exp, man):
        return ref.float_merge(sign, exp, man, fmt)
    _need(sign, torch.uint8, "float_merge signs")
    _need(exp, CARRIER[exp_width], "float_merge exponents")
    _need(man, CARRIER[man_width], "float_merge mantissas")
    out = torch.empty(n, dtype=CARRIER[width], device=man.device)
    if n:
        _launched(
            _lib().repro_float_merge(
                sign.data_ptr(), exp.data_ptr(), man.data_ptr(), out.data_ptr(), n,
                width, exp_width, man_width, exp_bits, man_bits, _stream(man),
            ),
            "float_merge",
        )
        _count(float_merge)
    return out


float_merge.launches = 0


# ------------------------------------------------------------- K13 histogram
def histogram(x: torch.Tensor) -> torch.Tensor:
    """Exact 256-bin counts (int64) of a 1-D uint8 stream, at any size."""
    if x.dim() != 1:
        raise ValueError(f"histogram: 1-D byte stream expected, got {tuple(x.shape)}")
    if _on_cpu(x):
        return ref.histogram_exact(x)
    _need(x, torch.uint8, "histogram symbols")
    if not x.numel():
        return torch.zeros(256, dtype=torch.int64, device=x.device)
    out = torch.empty(256, dtype=torch.int64, device=x.device)
    _launched(
        _lib().repro_histogram(x.data_ptr(), x.numel(), out.data_ptr(), _stream(x)),
        "histogram",
    )
    _count(histogram)
    return out


histogram.launches = 0


# ------------------------------------------ K5 / K6 / K11 / K12 bit packing
_PACK_CARRIERS = (torch.uint8, torch.int16, torch.int32)


def _pack_args(x: torch.Tensor, bits: int, what: str) -> None:
    if bits not in ref.PACK_BITS:
        raise ValueError(f"{what}: bits must be one of {ref.PACK_BITS}, got {bits}")
    if x.dim() != 1 or x.dtype not in _PACK_CARRIERS:
        raise TypeError(f"{what}: 1-D uint8/int16/int32 values expected, got {x.dtype}")


def _unpack_args(w: torch.Tensor, bits: int, n: int, width: int, what: str) -> None:
    if bits not in ref.PACK_BITS:
        raise ValueError(f"{what}: bits must be one of {ref.PACK_BITS}, got {bits}")
    if width not in (1, 2, 4):
        raise ValueError(f"{what}: output width must be 1, 2 or 4, got {width}")
    if w.dim() != 1 or n < 0 or w.numel() < -(-n // (32 // bits)):
        raise ValueError(f"{what}: ceil(n * bits / 32) words expected for n={n}")


def bitpack(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8/int16/int32 values, read unsigned, 32 // bits to an int32
    word, LSB-first; slots of the last word past n are 0."""
    _pack_args(x, bits, "bitpack")
    if _on_cpu(x):
        return ref.bitpack(x, bits)
    _need(x, x.dtype, "bitpack")
    n = x.numel()
    out = torch.empty(-(-n // (32 // bits)), dtype=torch.int32, device=x.device)
    if n:
        _launched(
            _lib().repro_bitpack(
                x.data_ptr(), out.data_ptr(), n, x.element_size(), bits, _stream(x)
            ),
            "bitpack",
        )
        _count(bitpack)
    return out


bitpack.launches = 0


def bitunpack(w: torch.Tensor, bits: int, n: int, width: int = 4) -> torch.Tensor:
    """The first n values of int32 words packed at ``bits``, in the carrier
    of ``width`` bytes (1, 2 or 4; each value cut to that width)."""
    _unpack_args(w, bits, n, width, "bitunpack")
    if _on_cpu(w):
        return ref.bitunpack(w, bits, n, width)
    _need(w, torch.int32, "bitunpack words")
    out = torch.empty(n, dtype=CARRIER[width], device=w.device)
    if n:
        _launched(
            _lib().repro_bitunpack(w.data_ptr(), out.data_ptr(), n, width, bits, _stream(w)),
            "bitunpack",
        )
        _count(bitunpack)
    return out


bitunpack.launches = 0


def fused_delta_bitpack(x: torch.Tensor, bits: int) -> torch.Tensor:
    """(x[i] - x[i-1]) mod 2^32 of uint8/int16/int32 values read unsigned,
    x[-1] = 0, masked to ``bits`` and packed as :func:`bitpack`, in one pass."""
    _pack_args(x, bits, "fused_delta_bitpack")
    if _on_cpu(x):
        return ref.fused_delta_bitpack(x, bits)
    _need(x, x.dtype, "fused_delta_bitpack")
    n = x.numel()
    out = torch.empty(-(-n // (32 // bits)), dtype=torch.int32, device=x.device)
    if n:
        _launched(
            _lib().repro_fused_delta_bitpack(
                x.data_ptr(), out.data_ptr(), n, x.element_size(), bits, _stream(x)
            ),
            "fused_delta_bitpack",
        )
        _count(fused_delta_bitpack)
    return out


fused_delta_bitpack.launches = 0


def fused_delta_bitpack_decode(
    w: torch.Tensor, bits: int, n: int, width: int = 4
) -> torch.Tensor:
    """Unpack n deltas from int32 words and take their inclusive prefix sum
    mod 2^32, cut to the carrier of ``width`` bytes (1, 2 or 4)."""
    _unpack_args(w, bits, n, width, "fused_delta_bitpack_decode")
    if _on_cpu(w):
        return ref.fused_delta_bitpack_decode(w, bits, n, width)
    _need(w, torch.int32, "fused_delta_bitpack_decode words")
    out = torch.empty(n, dtype=CARRIER[width], device=w.device)
    if n:
        lib = _lib()
        scratch = torch.empty(
            lib.repro_fused_delta_bitpack_decode_scratch(n, width, bits),
            dtype=torch.uint8, device=w.device,
        )
        _launched(
            lib.repro_fused_delta_bitpack_decode(
                w.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, width,
                bits, _stream(w),
            ),
            "fused_delta_bitpack_decode",
        )
        _count(fused_delta_bitpack_decode)
    return out


fused_delta_bitpack_decode.launches = 0


def fused_delta_bitpack_decode_tile(width: int, bits: int) -> int:
    """Values of one tile of the card's K12 at ``bits`` to ``width`` bytes."""
    tile = _lib().repro_fused_delta_bitpack_decode_tile(width, bits)
    if tile < 1:
        raise ValueError(f"fused_delta_bitpack_decode_tile: no tile at width {width}, bits {bits}")
    return tile
