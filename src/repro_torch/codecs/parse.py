"""Parser frontends (paper §IV "Frontend", §VI-C): ``csv_split`` and
``parse_numeric``.

The port's copy of the two codecs of ``repro.codecs.parse``: the same codec
ids, params, headers and output streams.

``csv_split``     — lossless rectangular CSV -> per-column STRING streams.
``parse_numeric`` — STRING of ASCII decimal ints -> (bitmap, i64 values,
                    exception strings).  Canonical integers go numeric; any
                    string that would not round-trip exactly stays an
                    exception.

Both are tensor programs on the device their input lies on, with no loop
over lines or strings: lines and separators are found by compares over the
byte tensor, fields and strings are cut out of it with one gather of byte
indices (``_gather``), integers are parsed from a right-aligned 20-byte
window of each string and formatted back from their digits.  The host sees
the header's scalars, the STRING lengths arrays (one device-to-host copy
for each codec's lengths) and the lengths of an input STRING stream (one
host-to-device copy).

The format sniffers at the end (``sniff_csv``, ``sniff_edge_list``,
``sniff_edge_list_bin``, ``sniff_numeric_width``, ``sniff_struct_width``)
are the reference's, on a bounded host prefix of sample bytes: the
trainer's ``detect_frontend`` reads them before any stream exists.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.codec import CodecSig, CodecSpec, InPort, ParamSpec, register_codec
from ..core.message import Stream, SType, narrow_unsigned
from ._util import HeaderReader, HeaderWriter, expect_stream, numeric_stream

_NL, _CR, _MINUS, _ZERO, _NINE = 10, 13, 45, 48, 57


def _gather(src: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, total: int):
    """The pieces ``src[starts[i] : starts[i] + lens[i]]``, joined in order,
    as one gather: output byte p of piece i comes from ``starts[i] + (p -
    out_off[i])``.  ``total`` is ``lens.sum()``, known on the host."""
    out_off = torch.cumsum(lens, 0) - lens
    pos = torch.arange(total, dtype=torch.int64, device=src.device) + torch.repeat_interleave(
        starts - out_off, lens, output_size=total)
    return src[pos]


def _lengths_to(lengths: np.ndarray, device) -> torch.Tensor:
    """Host uint32 lengths as int64 on ``device``: one host-to-device copy,
    4 bytes a length."""
    u32 = np.ascontiguousarray(lengths, dtype=np.uint32)
    return torch.from_numpy(u32.view(np.int32)).to(device).to(torch.int64) & 0xFFFFFFFF


def _lengths_of(lens: torch.Tensor) -> np.ndarray:
    """int64 lengths on the device as a host uint32 array: one
    device-to-host copy, 4 bytes a length."""
    return narrow_unsigned(lens.contiguous(), 4).cpu().numpy().view(np.uint32)


# ----------------------------------------------------------------- csv_split
# Header extension flag bits (appended after n_rows only when non-zero, so
# single-byte-separator LF frames stay byte-identical to the frozen vectors):
_CSV_EXT_CRLF = 1  # lines were CRLF-terminated; decode rejoins with \r\n
_CSV_EXT_MB_SEP = 2  # separator is multi-byte; the tail follows as bytes_


def _csv_sep_bytes(sep) -> bytes:
    sep_b = (
        bytes([sep])
        if isinstance(sep, int)
        else (sep.encode() if isinstance(sep, str) else bytes(sep))
    )
    if not sep_b:
        raise ValueError("csv_split: separator must be non-empty")
    if b"\n" in sep_b or b"\r" in sep_b:
        raise ValueError("csv_split: separator cannot contain newlines")
    return sep_b


def _has_border(sep_b: bytes) -> bool:
    """Whether a proper prefix of the separator is also its suffix: only
    then can two of its matches overlap."""
    return any(sep_b[:k] == sep_b[-k:] for k in range(1, len(sep_b)))


def _separators(body: torch.Tensor, sep_b: bytes) -> torch.Tensor:
    """The start positions of the matches ``bytes.split`` takes, in order.

    Candidates come from shifted compares.  A separator holds no newline,
    so no match straddles a line, and Python's left-to-right matching
    across the whole body equals its matching line by line.  Where the
    separator has a border, candidates may overlap: the taken ones are the
    chain from the first candidate through ``next(c)``, the first
    candidate at or past ``c + len(sep)``, marked by pointer jumping in
    O(log n) rounds."""
    size, nb = len(sep_b), body.numel()
    if nb < size:
        return torch.zeros(0, dtype=torch.int64, device=body.device)
    hit = body[: nb - size + 1] == sep_b[0]
    for k in range(1, size):
        hit &= body[k : nb - size + 1 + k] == sep_b[k]
    cand = torch.nonzero(hit).reshape(-1)
    k = cand.numel()
    if size == 1 or k < 2 or not _has_border(sep_b):
        return cand
    sentinel = torch.full((1,), k, dtype=torch.int64, device=body.device)
    jump = torch.cat([torch.searchsorted(cand, cand + size), sentinel])  # k: none left
    on = torch.zeros(k + 1, dtype=torch.int32, device=body.device)
    on[0] = 1
    for _ in range(k.bit_length()):  # after r rounds: the chain's first 2^r members
        on = on.scatter_reduce(0, jump, on, reduce="amax")
        jump = jump[jump]
    return cand[on[:k].bool()]


def _csv_split_enc(streams, params):
    s = streams[0]
    if s.stype != SType.SERIAL:
        raise ValueError("csv_split wants serial bytes")
    sep_b = _csv_sep_bytes(params.get("sep", ","))
    data = s.data
    trailing_nl = bool(data.numel()) and int(data[-1]) == _NL  # one scalar sync
    body = data[:-1] if trailing_nl else data
    nb, dev = body.numel(), body.device
    if nb == 0:  # body.split(b"\n") if body else []
        raise ValueError("csv_split: empty input")
    nl = torch.nonzero(body == _NL).reshape(-1)
    n_lines = nl.numel() + 1
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), nl + 1])
    ends = torch.cat([nl, torch.full((1,), nb, dtype=torch.int64, device=dev)])
    # CRLF mode: the input ends in \n and every line ends in \r; the \r then
    # leaves the fields and decode rejoins with \r\n
    crlf = trailing_nl and bool(
        ((ends > starts) & (body[(ends - 1).clamp_min(0)] == _CR)).all())
    if crlf:
        ends = ends - 1
    seps = _separators(body, sep_b)
    per_line = torch.bincount(torch.searchsorted(nl, seps), minlength=n_lines)
    least, most = (int(v) for v in torch.aminmax(per_line))
    if least != most:
        raise ValueError("csv_split: ragged rows (rectangular CSV only)")
    n_cols = most + 1
    sep_at = seps.view(n_lines, n_cols - 1)
    f_start = torch.cat([starts[:, None], sep_at + len(sep_b)], 1).t()  # (n_cols, n_lines)
    f_len = torch.cat([sep_at, ends[:, None]], 1).t() - f_start
    lens = _lengths_of(f_len)  # one device-to-host copy of every column's lengths
    col_bytes = lens.sum(1, dtype=np.int64)
    content = _gather(body, f_start.reshape(-1), f_len.reshape(-1), int(col_bytes.sum()))
    outs, off = [], 0
    for c in range(n_cols):  # each column a view of the one gathered tensor
        outs.append(Stream(content[off : off + int(col_bytes[c])], SType.STRING, 1, lens[c]))
        off += int(col_bytes[c])
    h = HeaderWriter().u8(sep_b[0]).u8(1 if trailing_nl else 0).varint(n_cols).varint(n_lines)
    flags = (_CSV_EXT_CRLF if crlf else 0) | (_CSV_EXT_MB_SEP if len(sep_b) > 1 else 0)
    if flags:
        h.u8(flags)
        if flags & _CSV_EXT_MB_SEP:
            h.bytes_(sep_b[1:])
    return outs, h.done()


def _csv_split_dec(outs, header, device):
    r = HeaderReader(header)
    sep = bytes([r.u8()])
    trailing_nl = r.u8()
    n_cols = r.varint()
    n_rows = r.varint()
    eol = b"\n"
    if r.pos < len(r.buf):  # extension byte (absent in pre-extension frames)
        flags = r.u8()
        if flags & _CSV_EXT_MB_SEP:
            sep += r.bytes_()
        if flags & _CSV_EXT_CRLF:
            eol = b"\r\n"
    r.expect_end()
    if len(outs) != n_cols or any(
        o.stype != SType.STRING or o.lengths.size != n_rows for o in outs
    ):
        raise ValueError("csv_split: corrupt columns")
    tail = torch.tensor(list(sep + eol), dtype=torch.uint8, device=device)
    n_eol = max(n_rows - 1, 0) + (1 if trailing_nl else 0)
    if n_rows == 0:  # eol.join([]), then the trailing eol
        return [Stream(tail[len(sep) :].repeat(n_eol), SType.SERIAL, 1)]
    # the output as pieces, row by row: field 0, sep, field 1, ..., field
    # n_cols - 1, eol; each piece a run of one source, joined by one gather
    lens_h = np.zeros((n_cols, n_rows), dtype=np.uint32)
    for c, o in enumerate(outs):
        lens_h[c] = o.lengths
    col_bytes = lens_h.sum(1, dtype=np.int64)
    src = torch.cat([o.data.to(device) for o in outs] + [tail])
    sep_at = int(col_bytes.sum())
    lens = _lengths_to(lens_h, device)  # one host-to-card copy
    col_base = torch.from_numpy(np.cumsum(col_bytes) - col_bytes).to(device)
    f_src = torch.cumsum(lens, 1) - lens + col_base[:, None]
    width = max(2 * n_cols, 1)
    p_len = torch.empty((n_rows, width), dtype=torch.int64, device=device)
    p_src = torch.empty_like(p_len)
    p_len[:, 0 : width - 1 : 2], p_src[:, 0 : width - 1 : 2] = lens.t(), f_src.t()
    p_len[:, 1 : width - 1 : 2], p_src[:, 1 : width - 1 : 2] = len(sep), sep_at
    p_len[:, width - 1], p_src[:, width - 1] = len(eol), sep_at + len(sep)
    if not trailing_nl:
        p_len[n_rows - 1, width - 1] = 0
    total = sep_at + n_rows * max(n_cols - 1, 0) * len(sep) + n_eol * len(eol)
    raw = _gather(src, p_src.reshape(-1), p_len.reshape(-1), total)
    return [Stream(raw, SType.SERIAL, 1)]


register_codec(
    CodecSpec(
        "csv_split",
        codec_id=20,
        encode=_csv_split_enc,
        decode=_csv_split_dec,
        n_outputs=-1,
        min_version=2,
        wants_device=True,
        doc="rectangular CSV -> per-column string streams (frontend, §IV)",
        sig=CodecSig(
            inputs=(InPort(frozenset((int(SType.SERIAL),))),),
            transfer=lambda atoms, params, n_out: [(int(SType.STRING), 1)] * n_out,
            params=(ParamSpec("sep", "str", doc="column separator (default ',')"),),
            expansion=2.0,  # per-cell u32 lengths replace the separators
        ),
    )
)


# ------------------------------------------------------------- parse_numeric
# An int64 has at most 19 digits, so a canonical rendering has at most 20
# bytes with its sign.  Its magnitude is read as hi * 10^9 + lo (lo the last
# nine digits), which never overflows, and held against 2^63 - 1 (2^63 for
# a negative) in the same halves.
_WIDTH = 20
_LO_DIGITS = 9
_HI_MAX, _LO_MAX = divmod((1 << 63) - 1, 10**_LO_DIGITS)  # 9223372036, 854775807


def _powers(n: int, device) -> torch.Tensor:
    """10^(n-1), ..., 10, 1 as int64."""
    return torch.tensor([10**k for k in range(n - 1, -1, -1)], dtype=torch.int64, device=device)


def _canonical_ints(content: torch.Tensor, off: torch.Tensor, lens: torch.Tensor):
    """For each string, whether it is a canonical decimal int64 rendering
    (``repro.codecs.parse._canonical_int``), and its value where it is.

    Each string's last 20 bytes are gathered right-aligned into an (n, 20)
    matrix: byte p of the window is byte ``lens - 20 + p`` of the string,
    padding where that is negative."""
    dev = content.device
    src = content if content.numel() else torch.zeros(1, dtype=torch.uint8, device=dev)
    p = torch.arange(_WIDTH, dtype=torch.int64, device=dev)
    first = _WIDTH - lens  # the window's column of the string's first byte
    idx = (off + lens - _WIDTH)[:, None] + p
    inside = p >= first[:, None]
    b = torch.where(inside, src[idx.clamp(0, src.numel() - 1)], 0)
    head = first.clamp(0, _WIDTH - 1)[:, None]
    neg = b.gather(1, head).squeeze(1) == _MINUS
    n_digits = lens - neg.to(torch.int64)
    lead = first + neg.to(torch.int64)  # the column of the first digit
    at_digit = p >= lead[:, None]
    is_digit = (b >= _ZERO) & (b <= _NINE)
    lead_byte = b.gather(1, lead.clamp(0, _WIDTH - 1)[:, None]).squeeze(1)
    ok = (
        (lens >= 1) & (lens <= _WIDTH) & (n_digits >= 1)
        & (is_digit | ~at_digit).all(1)
        # a leading zero does not round-trip, nor does "-0"
        & ~((lead_byte == _ZERO) & ((n_digits > 1) | neg))
    )
    digit = torch.where(at_digit & is_digit, b.to(torch.int64) - _ZERO, 0)
    lo = (digit[:, _WIDTH - _LO_DIGITS :] * _powers(_LO_DIGITS, dev)).sum(1)
    hi = (digit[:, : _WIDTH - _LO_DIGITS] * _powers(_WIDTH - _LO_DIGITS, dev)).sum(1)
    ok &= (hi < _HI_MAX) | ((hi == _HI_MAX) & (lo <= _LO_MAX + neg.to(torch.int64)))
    big = torch.where(ok, hi, 0) * 10**_LO_DIGITS
    lo = torch.where(ok, lo, 0)
    # a negative is built as a negative sum: -2^63 comes out without overflow
    return ok, torch.where(neg, -big - lo, big + lo)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``np.packbits``: 8 flags a byte, the first in the top bit; no bytes
    for no flags."""
    pad = (-bits.numel()) % 8
    b = torch.cat([bits.to(torch.int32), bits.new_zeros(pad, dtype=torch.int32)]).view(-1, 8)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b << shifts).sum(1).to(torch.uint8)


def _unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """``np.unpackbits(packed)[:n]`` as bools."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    return ((packed.to(torch.int32)[:, None] >> shifts) & 1).reshape(-1)[:n].bool()


def _parse_numeric_enc(streams, params):
    s = streams[0]
    if s.stype != SType.STRING:
        raise ValueError("parse_numeric wants a string stream")
    dev = s.data.device
    lens = _lengths_to(s.lengths, dev)  # one host-to-card copy
    off = torch.cumsum(lens, 0) - lens
    is_num, value = _canonical_ints(s.data, off, lens)
    exc = ~is_num
    exc_lens = lens[exc]
    exc_lens_h = _lengths_of(exc_lens)  # one card-to-host copy
    exceptions = _gather(s.data, off[exc], exc_lens, int(exc_lens_h.sum(dtype=np.int64)))
    h = HeaderWriter().varint(s.n_elts).done()
    return [
        Stream(_pack_bits(is_num), SType.SERIAL, 1),
        numeric_stream(value[is_num]),
        Stream(exceptions, SType.STRING, 1, exc_lens_h),
    ], h


def _digit_count(x: torch.Tensor, most: int) -> torch.Tensor:
    """Decimal digits of x in [0, 10^most), with 0 counted as one digit."""
    return 1 + (x[:, None] >= _powers(most, x.device)[:-1]).sum(1)


def _format_ints(vals: torch.Tensor):
    """Each int64's shortest decimal rendering, right-aligned in an (n, 20)
    byte matrix, and its length.  The magnitude is split as hi * 10^9 + lo
    by truncating division, so -2^63 needs no positive int64."""
    dev = vals.device
    neg = vals < 0
    q = torch.div(vals, 10**_LO_DIGITS, rounding_mode="trunc")
    hi, lo = q.abs(), (vals - q * 10**_LO_DIGITS).abs()
    n_hi = _WIDTH - 1 - _LO_DIGITS  # hi has at most 10 digits
    n_digits = torch.where(hi > 0, _LO_DIGITS + _digit_count(hi, n_hi),
                           _digit_count(lo, _LO_DIGITS))
    digits = torch.cat([hi[:, None] // _powers(n_hi, dev) % 10,
                        lo[:, None] // _powers(_LO_DIGITS, dev) % 10], 1)
    text = torch.cat([torch.zeros_like(vals)[:, None], digits], 1) + _ZERO
    p = torch.arange(_WIDTH, dtype=torch.int64, device=dev)
    sign_at = (p == (_WIDTH - 1 - n_digits)[:, None]) & neg[:, None]
    text = torch.where(sign_at, _MINUS, text).to(torch.uint8)
    return text, n_digits + neg.to(torch.int64)


def _parse_numeric_dec(outs, header):
    bitmap_s, vals_s, exc_s = outs
    r = HeaderReader(header)
    n = r.varint()
    r.expect_end()
    expect_stream(bitmap_s, SType.SERIAL, 1, "parse_numeric", "bitmap")
    expect_stream(vals_s, SType.NUMERIC, 8, "parse_numeric", "value")
    expect_stream(exc_s, SType.STRING, 1, "parse_numeric", "exception")
    bitmap, raw = bitmap_s.raw(), vals_s.raw()
    if bitmap.numel() * 8 < n:
        raise ValueError("parse_numeric: corrupt streams")
    dev = bitmap.device
    is_num = _unpack_bits(bitmap, n)
    vals = raw.view(torch.int64)
    n_num = int(is_num.sum())  # one scalar sync
    if n_num != vals.numel() or n - n_num != exc_s.lengths.size:
        raise ValueError("parse_numeric: the bitmap does not match its values and exceptions")
    text, num_lens = _format_ints(vals)
    exc_lens = _lengths_to(exc_s.lengths, dev)  # one host-to-card copy
    exc_off = torch.cumsum(exc_lens, 0) - exc_lens
    # each item from its own kind: the k-th number or the k-th exception; the
    # zero beside each keeps the lookup in range past the last of its kind
    flags = is_num.to(torch.int64)
    num_k = torch.cumsum(flags, 0) - flags
    exc_k = torch.arange(n, dtype=torch.int64, device=dev) - num_k
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    num_len = torch.cat([num_lens, zero])[num_k]
    item_len = torch.where(is_num, num_len, torch.cat([exc_lens, zero])[exc_k])
    item_src = torch.where(is_num, num_k * _WIDTH + _WIDTH - num_len,
                           n_num * _WIDTH + torch.cat([exc_off, zero])[exc_k])
    lengths = _lengths_of(item_len)  # one card-to-host copy
    src = torch.cat([text.reshape(-1), exc_s.data.to(dev)])
    items = _gather(src, item_src, item_len, int(lengths.sum(dtype=np.int64)))
    return [Stream(items, SType.STRING, 1, lengths)]


register_codec(
    CodecSpec(
        "parse_numeric",
        codec_id=19,
        encode=_parse_numeric_enc,
        decode=_parse_numeric_dec,
        n_outputs=3,
        min_version=2,
        doc="ASCII ints -> (bitmap, i64 values, exceptions); lossless always",
        sig=CodecSig(
            inputs=(InPort(frozenset((int(SType.STRING),))),),
            transfer=lambda atoms, params, n_out: [
                (int(SType.SERIAL), 1),
                (int(SType.NUMERIC), 8),
                (int(SType.STRING), 1),
            ],
            expansion=2.0,  # short digit strings widen to 8-byte values
        ),
    )
)


# -------------------------------------------------------------- sniffers
# The format sniffers behind ``detect_frontend`` and ``train --frontend``:
# copies of ``repro.codecs.parse``'s.  They read a bounded prefix of the
# sample bytes on the host, before any stream exists, so they stay numpy.


def _canonical_int(b: bytes):
    """Return int value if `b` is a canonical decimal i64 rendering, else None."""
    if not b or len(b) > 20:
        return None
    neg = b[0:1] == b"-"
    digits = b[1:] if neg else b
    if not digits or not digits.isdigit():
        return None
    if len(digits) > 1 and digits[0:1] == b"0":
        return None  # leading zeros don't round-trip
    if neg and digits == b"0":
        return None  # "-0" doesn't round-trip
    v = int(b)
    if not (-(1 << 63) <= v < (1 << 63)):
        return None
    return v


SNIFF_PROBE_BYTES = 1 << 16  # all sniffing runs on a bounded prefix

_PRINTABLE_MASK = np.zeros(256, dtype=bool)
_PRINTABLE_MASK[32:127] = True
_PRINTABLE_MASK[[9, 10, 13]] = True  # tab / newline / carriage return

_NUMERIC_SNIFF_DTYPES = {2: np.uint16, 4: np.uint32, 8: np.uint64}


def sniff_csv(
    raw: bytes,
    *,
    seps: Tuple[bytes, ...] = (b",", b"\t", b";", b"|"),
    max_probe: int = SNIFF_PROBE_BYTES,
) -> Optional[Tuple[int, str]]:
    """Detect a rectangular CSV prefix -> ``(n_cols, sep)``, else None.

    The acceptance rule is ``csv_split``'s own: every probed (complete) line
    must split into the same column count under one separator.  Of the
    separators that pass, the one yielding the most columns wins — a file
    whose fields contain no separator at all still parses as 1 column, so
    at least 2 columns are required to call it CSV.

    CRLF files are handled exactly as ``csv_split`` does: when every probed
    line ends with ``\\r`` the terminator is stripped before the
    rectangularity check, so a CRLF file no longer trains a plan whose last
    column drags a ``\\r`` suffix through every row.  A lone ``\\r`` inside
    a line (mixed endings) still counts as field bytes, matching the codec.
    """
    probe = bytes(raw[:max_probe])
    if len(probe) < 8:
        return None
    arr = np.frombuffer(probe, dtype=np.uint8)
    if float(_PRINTABLE_MASK[arr].mean()) < 0.95:
        return None
    cut = probe.rfind(b"\n")
    if cut <= 0:
        return None
    lines = probe[:cut].split(b"\n")
    if all(ln.endswith(b"\r") for ln in lines):
        lines = [ln[:-1] for ln in lines]
    if len(lines) < 2 or any(not ln for ln in lines):
        return None
    best: Optional[Tuple[int, bytes]] = None
    for sep in seps:
        n_cols = lines[0].count(sep) + 1
        if n_cols < 2:
            continue
        if any(ln.count(sep) + 1 != n_cols for ln in lines[1:]):
            continue
        if best is None or n_cols > best[0]:
            best = (n_cols, sep)
    if best is None:
        return None
    return best[0], best[1].decode()


def sniff_edge_list(
    raw: bytes,
    *,
    seps: Tuple[bytes, ...] = (b"\t", b" "),
    max_probe: int = SNIFF_PROBE_BYTES,
) -> Optional[str]:
    """Detect a SNAP-style text edge list -> separator, else None.

    Acceptance: mostly printable, >= 32 non-comment probed lines of which
    >= 95% split into exactly two canonical decimal integers under one
    separator (``#`` comment lines are ignored, as ``edge_list`` routes them
    to its exception stream).  Only whitespace separators are probed — a
    two-integer-column *comma* file keeps sniffing as CSV, which subsumes it.
    """
    probe = bytes(raw[:max_probe])
    if len(probe) < 16:
        return None
    arr = np.frombuffer(probe, dtype=np.uint8)
    if float(_PRINTABLE_MASK[arr].mean()) < 0.95:
        return None
    cut = probe.rfind(b"\n")
    if cut <= 0:
        return None
    lines = probe[:cut].split(b"\n")
    data = [ln for ln in lines if ln and not ln.startswith(b"#")]
    if len(data) < 32:
        return None
    best: Optional[Tuple[int, bytes]] = None
    for sep in seps:
        n_ok = 0
        for ln in data:
            parts = ln.split(sep)
            if (
                len(parts) == 2
                and _canonical_int(parts[0]) is not None
                and _canonical_int(parts[1]) is not None
            ):
                n_ok += 1
        if n_ok >= max(32, int(0.95 * len(data))) and (
            best is None or n_ok > best[0]
        ):
            best = (n_ok, sep)
    if best is None:
        return None
    return best[1].decode()


def sniff_edge_list_bin(
    raw: bytes,
    *,
    widths: Tuple[int, ...] = (4, 8),
    max_probe: int = SNIFF_PROBE_BYTES,
) -> Optional[int]:
    """Detect a binary interleaved (src, dst) edge array -> pair width.

    Signals, probed narrowest-first like ``sniff_numeric_width``: the src
    column is >= 98% non-decreasing (CSR dumps sort by source), src repeats
    often enough to form adjacency runs (>= 20%), and neighbors within a run
    are >= 90% increasing (sorted adjacency lists).  Plain sorted integer
    arrays fail the run test, so the numeric sniffer still claims them.
    """
    n = len(raw)
    for w in widths:
        if n % (2 * w) or n // (2 * w) < 64:
            continue
        take = (min(n, max_probe) // (2 * w)) * (2 * w)
        pairs = np.frombuffer(raw[:take], dtype=_NUMERIC_SNIFF_DTYPES[w]).reshape(
            -1, 2
        )
        src, dst = pairs[:, 0], pairs[:, 1]
        if float(np.mean(src[1:] >= src[:-1])) < 0.98:
            continue
        same = src[1:] == src[:-1]
        if float(same.mean()) < 0.2:
            continue
        if float(np.mean(dst[1:][same] > dst[:-1][same])) < 0.9:
            continue
        return w
    return None


def sniff_numeric_width(
    raw: bytes,
    *,
    widths: Tuple[int, ...] = (2, 4, 8),
    require_monotone: bool = False,
    max_probe: int = SNIFF_PROBE_BYTES,
) -> Optional[int]:
    """Detect a fixed-width little-endian integer array -> element width.

    Two independent signals, probed narrowest-first (a sorted w-wide array
    read at width 2w still looks sorted — its high halves carry the order —
    while a 2w-wide array read at w interleaves random low halves, so the
    narrowest width that fires is the true one): *sortedness* (>= 90% of
    adjacent deltas non-negative — index-like columns) and *bounded range*
    (>= 95% of the values share one top byte — measurements far narrower
    than their storage width).  ``require_monotone=True`` keeps only the
    strong first signal; the bounded-range signal also fires on multi-field
    records, so callers try struct detection in between.
    """
    n = len(raw)
    for w in widths:
        if n % w or n // w < 64:
            continue
        take = (min(n, max_probe) // w) * w
        a = np.frombuffer(raw[:take], dtype=_NUMERIC_SNIFF_DTYPES[w])
        mono = float(np.mean(a[1:] >= a[:-1]))
        if mono >= 0.9:
            return w
        if require_monotone:
            continue
        top = np.frombuffer(raw[:take], dtype=np.uint8).reshape(-1, w)[:, -1]
        counts = np.bincount(top, minlength=256)
        if (
            float(counts.max()) / top.size >= 0.95
            or int((counts > 0).sum()) <= 2
        ):
            return w
    return None


def sniff_struct_width(
    raw: bytes,
    *,
    min_width: int = 2,
    max_width: int = 16,
    max_probe: int = SNIFF_PROBE_BYTES,
) -> Optional[int]:
    """Detect a fixed-size record layout -> record width, else None.

    Signal: byte equality at lag ``w`` (same field offset, adjacent records)
    far above the lag-1 baseline — fixed-width records repeat their
    near-constant field bytes with period exactly ``w``.  The smallest width
    within 95% of the best score wins, so a ``2w`` multiple never shadows
    the true record size.
    """
    n = len(raw)
    x = np.frombuffer(raw[:max_probe], dtype=np.uint8).astype(np.int16)
    if x.size < 64:
        return None
    base = float(np.mean(x[1:] == x[:-1]))
    scores = {}
    for w in range(min_width, max_width + 1):
        if n % w or n // w < 16 or x.size <= 2 * w:
            continue
        scores[w] = float(np.mean(x[w:] == x[:-w]))
    if not scores:
        return None
    best_w = min(scores, key=lambda w: (-scores[w], w))
    if scores[best_w] < max(0.35, 1.5 * base):
        return None
    for w in sorted(scores):
        if scores[w] >= 0.95 * scores[best_w]:
            return w
    return best_w
