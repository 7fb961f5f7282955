"""Typed message streams — the edges of the compression graph.

The port's copy of ``repro.core.message``: the same 4-entry type system
(``SERIAL``, ``STRUCT``, ``NUMERIC``, ``STRING``) with the same wire tags, but
a stream's payload is a 1-D torch tensor that lives on the device the
compression runs on.  Data stays there from codec to codec and comes to the
host only where the wire needs bytes.

Carrier dtypes: SERIAL/STRUCT/STRING payloads are ``torch.uint8``.  A NUMERIC
stream of width 1/2/4/8 carries its bit patterns in ``uint8``/``int16``/
``int32``/``int64`` — PyTorch's unsigned 16/32/64-bit types lack most
arithmetic, so codecs reinterpret the signed carrier as unsigned where the
reference's numpy code uses ``view(uint*)``.
"""
from __future__ import annotations

import enum
import warnings
from dataclasses import dataclass, replace
from typing import Iterable, List, Optional, Union

import numpy as np
import torch

__all__ = [
    "SType",
    "Stream",
    "serial",
    "numeric",
    "struct",
    "strings",
    "from_wire",
    "from_numpy",
    "widen_unsigned",
    "narrow_unsigned",
    "join_u32",
    "sub_u64",
    "PACK_BITS",
]


class SType(enum.IntEnum):
    """Wire-stable message type tags (values are serialized — never renumber)."""

    SERIAL = 0
    STRUCT = 1
    NUMERIC = 2
    STRING = 3


# the bits per value that divide 32, so no value straddles a u32 word: the
# widths that K5, K6, K11 and K12 pack, and the fused codec's choices
PACK_BITS = (1, 2, 4, 8, 16, 32)
CARRIER = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NP_CARRIER = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}
UNSIGNED_NP = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_TORCH_INT_TO_CARRIER = {
    torch.uint8: torch.uint8,
    torch.int8: torch.uint8,
    torch.int16: torch.int16,
    torch.uint16: torch.int16,
    torch.float16: torch.int16,
    torch.bfloat16: torch.int16,
    torch.int32: torch.int32,
    torch.uint32: torch.int32,
    torch.float32: torch.int32,
    torch.int64: torch.int64,
    torch.uint64: torch.int64,
    torch.float64: torch.int64,
}


@dataclass(frozen=True)
class Stream:
    """One message: a typed view over a flat tensor.

    ``data`` is always 1-D and contiguous: uint8 for SERIAL/STRUCT/STRING, the
    carrier of ``width`` bytes for NUMERIC.  ``lengths`` is only present for
    STRING streams (host uint32 per-string byte lengths).
    """

    data: torch.Tensor
    stype: SType
    width: int = 1
    lengths: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        n = int(self.data.numel()) * self.data.element_size()
        if self.stype == SType.STRING and self.lengths is not None:
            n += int(self.lengths.nbytes)
        return n

    @property
    def n_elts(self) -> int:
        if self.stype == SType.STRUCT:
            return int(self.data.numel()) // self.width
        if self.stype == SType.STRING:
            return int(self.lengths.size) if self.lengths is not None else 0
        return int(self.data.numel())

    def validate(self) -> "Stream":
        if self.data.dim() != 1:
            raise ValueError(f"stream data must be 1-D, got {tuple(self.data.shape)}")
        if self.stype in (SType.SERIAL, SType.STRUCT, SType.STRING):
            if self.data.dtype != torch.uint8:
                raise ValueError(f"{self.stype.name} stream must be uint8")
        if self.stype == SType.STRUCT:
            if self.width < 1 or self.data.numel() % self.width:
                raise ValueError(
                    f"struct({self.width}) stream length {self.data.numel()} not divisible"
                )
        if self.stype == SType.NUMERIC:
            if self.width not in CARRIER:
                raise ValueError(f"numeric width must be 1/2/4/8, got {self.width}")
            if self.data.dtype != CARRIER[self.width]:
                raise ValueError(
                    f"numeric({self.width}) carries dtype {self.data.dtype}"
                )
        if self.stype == SType.STRING:
            if self.lengths is None:
                raise ValueError("string stream requires lengths")
            if int(self.lengths.sum()) != self.data.numel():
                raise ValueError("string lengths do not sum to content size")
        return self

    # ------------------------------------------------------- representations
    def raw(self) -> torch.Tensor:
        """The payload as flat uint8 bytes, on the stream's device (a view)."""
        t = self.data
        if t.stride(0) != 1:  # a slice of 0 or 1 elements may keep its step
            t = torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
        return t.contiguous().view(torch.uint8)

    def content_bytes(self) -> bytes:
        """Raw little-endian bytes of the payload, copied to the host."""
        return self.raw().cpu().numpy().tobytes()

    def as_serial(self) -> "Stream":
        """The content as opaque bytes (a lossless view change): a SERIAL
        stream over :meth:`raw`, on the stream's device, with no host trip."""
        return Stream(self.raw(), SType.SERIAL, 1)

    def numpy(self) -> np.ndarray:
        """Host copy with the reference's dtype (unsigned for NUMERIC)."""
        arr = self.data.cpu().numpy()
        if self.stype == SType.NUMERIC:
            return arr.view(UNSIGNED_NP[self.width])
        return arr

    def to_strings(self) -> List[bytes]:
        """A STRING stream's items, as host bytes (one copy of the content)."""
        if self.stype != SType.STRING:
            raise ValueError("to_strings on non-string stream")
        buf = self.content_bytes()
        ends = np.cumsum(self.lengths, dtype=np.int64).tolist()
        return [buf[a:b] for a, b in zip([0] + ends[:-1], ends)]

    def to(self, device: Union[str, torch.device]) -> "Stream":
        return replace(self, data=self.data.to(device))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"Stream({self.stype.name}, w={self.width}, n={self.n_elts},"
            f" {self.nbytes}B, {self.device})"
        )


# --------------------------------------------------- unsigned arithmetic
def widen_unsigned(t: torch.Tensor) -> torch.Tensor:
    """Carrier -> int64 holding the unsigned value (widths 1, 2, 4).

    Width 8 has no wider type: its int64 carrier is returned as is, holding
    the unsigned value's bit pattern.
    """
    w = t.element_size()
    if w == 8:
        return t
    return t.to(torch.int64) & ((1 << (8 * w)) - 1)


def narrow_unsigned(u: torch.Tensor, width: int) -> torch.Tensor:
    """int64 -> carrier of ``width`` bytes keeping the low ``8*width`` bits.

    The low bits are first moved into the carrier's signed range, so the
    final conversion never relies on out-of-range integer casts.
    """
    if width == 8:
        return u
    bits = 8 * width
    v = u & ((1 << bits) - 1)
    if width > 1:
        v = torch.where(v >= (1 << (bits - 1)), v - (1 << bits), v)
    return v.to(CARRIER[width])


def join_u32(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 halves in [0, 2^32) -> the int64 whose bits are hi:lo."""
    pair = torch.stack([narrow_unsigned(lo, 4), narrow_unsigned(hi, 4)], dim=-1)
    return pair.view(torch.int64).reshape(lo.shape)


def sub_u64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^64 on int64 bit patterns, computed in 32-bit halves."""
    m = 0xFFFFFFFF
    lo = (a & m) - (b & m)
    hi = ((a >> 32) & m) - ((b >> 32) & m) - (lo < 0).to(torch.int64)
    return join_u32(lo & m, hi & m)


# ------------------------------------------------------------------ builders
def _as_u8_tensor(data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).contiguous().view(torch.uint8)
    if isinstance(data, (bytes, bytearray, memoryview)):
        return torch.from_numpy(np.frombuffer(bytearray(data), dtype=np.uint8))
    return torch.from_numpy(np.array(data, dtype=np.uint8).reshape(-1))


def serial(data) -> Stream:
    return Stream(_as_u8_tensor(data), SType.SERIAL, 1).validate()


def struct(data, width: int) -> Stream:
    return Stream(_as_u8_tensor(data), SType.STRUCT, width).validate()


def strings(items: Iterable[bytes]) -> Stream:
    """Build a STRING stream on the CPU: the items' bytes joined, with their
    lengths as a host uint32 array."""
    items = list(items)
    lens = np.asarray([len(s) for s in items], dtype=np.uint32)
    return Stream(_as_u8_tensor(b"".join(items)), SType.STRING, 1, lens).validate()


def numeric(arr) -> Stream:
    """Build a NUMERIC stream from a numpy array or an integer/float tensor.

    Floats are bit-cast to same-width integers, as the reference does.
    """
    if isinstance(arr, torch.Tensor):
        t = arr.reshape(-1).contiguous()
        if t.dtype not in _TORCH_INT_TO_CARRIER:
            raise ValueError(f"numeric stream from dtype {t.dtype}?")
        t = t.view(_TORCH_INT_TO_CARRIER[t.dtype])
        return Stream(t, SType.NUMERIC, t.element_size()).validate()
    a = np.asarray(arr)
    if a.dtype.kind not in "iuf":
        raise ValueError(f"numeric stream from dtype {a.dtype}?")
    if a.dtype.itemsize not in _NP_CARRIER:
        raise ValueError(f"unsupported numeric width {a.dtype.itemsize}")
    return from_numpy(a, SType.NUMERIC, a.dtype.itemsize)


def from_numpy(arr: np.ndarray, stype: SType, width: int) -> Stream:
    """Wrap a host array's little-endian bytes as a CPU stream of (stype, width)."""
    a = np.ascontiguousarray(arr).reshape(-1)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    carrier = _NP_CARRIER[width] if stype == SType.NUMERIC else np.uint8
    a = a.view(np.uint8).view(carrier)
    if not a.flags.writeable:
        a = a.copy()
    return Stream(torch.from_numpy(a), stype, width).validate()


def from_wire(
    stype: SType,
    width: int,
    payload,
    lengths: Optional[np.ndarray],
    device: Union[str, torch.device] = "cpu",
) -> Stream:
    """Rebuild a stream of (stype, width) from wire bytes, on ``device``.

    ``payload`` is any buffer (bytes, or a memoryview into a frame).  For the
    CPU it is copied once into a private host tensor; for the card it goes
    from the caller's buffer to the device in one host-to-card copy.
    """
    nbytes = memoryview(payload).nbytes
    if stype == SType.NUMERIC and (width not in CARRIER or nbytes % width):
        raise ValueError(f"numeric({width}) payload of {nbytes} bytes")
    dev = torch.device(device)
    if dev.type == "cpu" or nbytes == 0:
        raw = torch.from_numpy(np.frombuffer(bytearray(payload), dtype=np.uint8)).to(dev)
    else:
        with warnings.catch_warnings():
            # a read-only view of the frame, copied to the card at once
            warnings.simplefilter("ignore", UserWarning)
            raw = torch.frombuffer(payload, dtype=torch.uint8).to(dev)
    data = raw.view(CARRIER[width]) if stype == SType.NUMERIC else raw
    return Stream(data, stype, width, lengths).validate()
