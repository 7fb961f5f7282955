"""Serialized compressors — the port's copy of ``repro.core.serialize``.

A plan (codec names, params, topology, selector references) serializes to a
small msgpack blob, the ``.ozp`` plan file that is shipped and deployed like a
config file (paper §V-D).  The wire *frame* format (``wire.py``) is
independent: frames embed resolved graphs and never need this module.

The port reads and writes the blob without ``msgpack``: :func:`packb` and
:func:`unpackb` implement the subset of the format that
``msgpack.packb(obj, use_bin_type=True)`` and ``msgpack.unpackb(blob,
raw=False)`` use for plans, byte for byte.  Each value takes the shortest
encoding msgpack picks (a non-negative integer is written unsigned at every
width, a negative one at the smallest signed width; floats as float64; ``str``
as UTF-8 fixstr/str8/16/32; ``bytes`` as bin8/16/32; lists and tuples as
arrays; dicts as maps in insertion order).  :func:`plan_digest` hashes these
bytes, so a plan's content address is the reference's.

The reader fails closed with ``ValueError`` on truncated input, trailing
bytes, a declared length past the remaining bytes (checked before anything is
allocated), a map key that is not ``str`` or ``bytes``, invalid UTF-8,
nesting deeper than msgpack's stack (1024 containers), the reserved byte
``0xc1`` and the ``ext`` family, which msgpack returns as ``ExtType`` and no
plan holds.  ``unpackb(blob, ext=True)`` (the service protocol's headers,
``repro_torch.service.protocol``) takes the ``ext`` family as msgpack does:
an :class:`ExtType`, or a :class:`Timestamp` for code -1, whose 4-, 8- or
12-byte forms and nanoseconds below 10^9 it checks as msgpack does.
"""
from __future__ import annotations

import hashlib
import struct as _struct
from typing import NamedTuple, Optional, Tuple

from .graph import KIND_CODEC, KIND_SELECTOR, Plan, PlanNode, _freeze

SERIAL_VERSION = 1

__all__ = [
    "ExtType",
    "Timestamp",
    "packb",
    "unpackb",
    "plan_to_dict",
    "plan_from_dict",
    "serialize_plan",
    "deserialize_plan",
    "plan_digest",
]

# msgpack's packer refuses an object nested deeper than this below the top
PACK_NEST_LIMIT = 511
# msgpack's unpacker holds at most this many open containers
UNPACK_MAX_DEPTH = 1024


# -------------------------------------------------------------------- write
def _pack_len(out: bytearray, n: int, fix_tag: int, fix_max: int, tags) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    tag that holds ``n`` (``tags`` lists (tag, struct format, max))."""
    if fix_tag is not None and n < fix_max:
        out.append(fix_tag | n)
        return
    for tag, fmt, top in tags:
        if n <= top:
            out.append(tag)
            out += _struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} past msgpack's 32-bit limit")


_STR_TAGS = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN_TAGS = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY_TAGS = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP_TAGS = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))


def _pack_int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + _struct.pack(">B", v)
        elif v <= 0xFFFF:
            out += b"\xcd" + _struct.pack(">H", v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + _struct.pack(">I", v)
        elif v < 1 << 64:
            out += b"\xcf" + _struct.pack(">Q", v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -(1 << 7):
        out += b"\xd0" + _struct.pack(">b", v)
    elif v >= -(1 << 15):
        out += b"\xd1" + _struct.pack(">h", v)
    elif v >= -(1 << 31):
        out += b"\xd2" + _struct.pack(">i", v)
    elif v >= -(1 << 63):
        out += b"\xd3" + _struct.pack(">q", v)
    else:
        raise OverflowError("Integer value out of range")


def _pack(out: bytearray, obj, nest: int) -> None:
    if nest < 0:
        raise ValueError("recursion limit exceeded.")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out += b"\xcb" + _struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, _STR_TAGS)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, _BIN_TAGS)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, _ARRAY_TAGS)
        for v in obj:
            _pack(out, v, nest - 1)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, _MAP_TAGS)
        for k, v in obj.items():
            _pack(out, k, nest - 1)
            _pack(out, v, nest - 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` over the plan subset."""
    out = bytearray()
    _pack(out, obj, PACK_NEST_LIMIT)
    return bytes(out)


# --------------------------------------------------------------------- read
_NO_KEY = object()  # a map entry whose key is not read yet


class ExtType(NamedTuple):
    """An ``ext`` value, as ``msgpack.ExtType`` holds it."""

    code: int
    data: bytes


class Timestamp(NamedTuple):
    """An ``ext`` value of code -1, as ``msgpack.Timestamp`` holds it."""

    seconds: int
    nanoseconds: int


def _ext_value(code: int, data: bytes):
    if code >= 0:
        return ExtType(code, data)
    if code != -1:  # msgpack reserves the other negative codes
        raise ValueError("code must be 0~127")
    if len(data) == 4:
        seconds, nanoseconds = _struct.unpack(">I", data)[0], 0
    elif len(data) == 8:
        word = _struct.unpack(">Q", data)[0]
        seconds, nanoseconds = word & ((1 << 34) - 1), word >> 34
    elif len(data) == 12:
        nanoseconds, seconds = _struct.unpack(">Iq", data)
    else:
        raise ValueError("Unpack failed: error = -1")
    if nanoseconds >= 10 ** 9:
        raise ValueError(
            "nanoseconds must be a non-negative integer less than 999999999."
        )
    return Timestamp(seconds, nanoseconds)


class _Reader:
    """An iterative msgpack reader: an explicit stack of open containers, so
    nesting as deep as msgpack's stack never meets Python's recursion limit."""

    def __init__(self, blob, ext: bool = False):
        self.buf = memoryview(bytes(blob))
        self.pos = 0
        self.ext = ext

    def take(self, n: int) -> memoryview:
        if n > len(self.buf) - self.pos:
            raise ValueError("Unpack failed: incomplete input")
        piece = self.buf[self.pos : self.pos + n]
        self.pos += n
        return piece

    def uint(self, fmt: str, n: int) -> int:
        return _struct.unpack(fmt, self.take(n))[0]

    def count(self, n: int, least: int) -> int:
        """A container or string length, refused before any allocation when
        the bytes left cannot hold ``n`` items of at least ``least`` bytes."""
        if n * least > len(self.buf) - self.pos:
            raise ValueError("Unpack failed: incomplete input")
        return n

    def text(self, n: int) -> str:
        return str(self.take(self.count(n, 1)), "utf-8")

    def head(self):
        """The next value, or ``(list | dict, n)`` for a container header."""
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0xA0 <= tag <= 0xBF:
            return self.text(tag & 0x1F)
        if 0x90 <= tag <= 0x9F:
            return list, self.count(tag & 0x0F, 1)
        if 0x80 <= tag <= 0x8F:
            return dict, self.count(tag & 0x0F, 2)
        if tag == 0xC0:
            return None
        if tag == 0xC2:
            return False
        if tag == 0xC3:
            return True
        if tag in _FIXED:
            fmt, n = _FIXED[tag]
            return _struct.unpack(fmt, self.take(n))[0]
        if tag in _STR_READ:
            return self.text(self.uint(*_STR_READ[tag]))
        if tag in _BIN_READ:
            return bytes(self.take(self.count(self.uint(*_BIN_READ[tag]), 1)))
        if tag in _ARRAY_READ:
            return list, self.count(self.uint(*_ARRAY_READ[tag]), 1)
        if tag in _MAP_READ:
            return dict, self.count(self.uint(*_MAP_READ[tag]), 2)
        if tag == 0xC1:
            raise ValueError("Unpack failed: reserved byte 0xc1")
        if not self.ext:
            raise ValueError(f"msgpack ext type (0x{tag:02x}) is not part of a plan file")
        n = _FIXEXT[tag] if tag in _FIXEXT else self.uint(*_EXT_READ[tag])
        code = _struct.unpack(">b", self.take(1))[0]
        return _ext_value(code, bytes(self.take(self.count(n, 1))))

    def value(self):
        stack: list = []  # [container, items left, pending map key]
        while True:
            v = self.head()
            if type(v) is tuple:  # a container header, not a value
                kind, n = v
                if len(stack) >= UNPACK_MAX_DEPTH:
                    raise ValueError("Unpack failed: nesting too deep")
                if n:
                    stack.append([kind(), n, _NO_KEY])
                    continue
                v = kind()
            # attach v to the innermost open container, closing full ones
            while stack:
                top = stack[-1]
                c = top[0]
                if isinstance(c, list):
                    c.append(v)
                elif top[2] is _NO_KEY:
                    if not isinstance(v, (str, bytes)):
                        raise ValueError(
                            f"{type(v).__name__} is not allowed for map key"
                            " when strict_map_key=True"
                        )
                    top[2] = v
                    break
                else:
                    c[top[2]] = v
                    top[2] = _NO_KEY
                top[1] -= 1
                if top[1]:
                    break
                v = stack.pop()[0]
            else:
                return v


_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_STR_READ = {0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4)}
_BIN_READ = {0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4)}
_ARRAY_READ = {0xDC: (">H", 2), 0xDD: (">I", 4)}
_MAP_READ = {0xDE: (">H", 2), 0xDF: (">I", 4)}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT_READ = {0xC7: (">B", 1), 0xC8: (">H", 2), 0xC9: (">I", 4)}


def unpackb(blob, *, ext: bool = False):
    """``msgpack.unpackb(blob, raw=False)`` over the plan subset; one value
    that spans the whole blob, else ``ValueError``.  ``ext=True`` also takes
    the ``ext`` family, as msgpack does."""
    r = _Reader(blob, ext)
    obj = r.value()
    if r.pos != len(r.buf):
        raise ValueError("unpack(b) received extra data.")
    return obj


# -------------------------------------------------------------------- plans
def plan_to_dict(
    plan: Plan,
    name: str = "",
    *,
    format_version: Optional[int] = None,
    level: Optional[int] = None,
) -> dict:
    d = {
        "v": SERIAL_VERSION,
        "name": name or plan.name,
        "n_inputs": plan.n_inputs,
        "nodes": [
            {
                "k": 0 if n.kind == KIND_CODEC else 1,
                "c": n.name,
                "i": list(n.inputs),
                "o": n.n_out,
                "p": n.param_dict(),
            }
            for n in plan.nodes
        ],
    }
    # the deployment knobs ride along: old readers ignore them, old blobs
    # lack them
    if format_version is not None:
        d["format_version"] = int(format_version)
    if level is not None:
        d["level"] = int(level)
    return d


def plan_from_dict(d: dict) -> Tuple[Plan, dict]:
    """Plan + deployment meta from the ``plan_to_dict`` form.

    Keys: ``v``, ``name``, ``n_inputs``, ``nodes`` (each ``k`` kind, ``c``
    codec or selector name, ``i`` inputs, ``o`` n_out, ``p`` params) and the
    optional ``format_version`` and ``level``.
    """
    if d.get("v") != SERIAL_VERSION:
        raise ValueError(f"unsupported serialized-compressor version {d.get('v')}")
    nodes = tuple(
        PlanNode(
            KIND_CODEC if nd["k"] == 0 else KIND_SELECTOR,
            nd["c"],
            tuple(nd["i"]),
            nd["o"],
            _freeze(nd.get("p") or {}),
        )
        for nd in d["nodes"]
    )
    plan = Plan(d["n_inputs"], nodes, d.get("name", "")).validate()
    meta = {"name": d.get("name", "")}
    if "format_version" in d:
        meta["format_version"] = int(d["format_version"])
    if "level" in d:
        meta["level"] = int(d["level"])
    return plan, meta


def serialize_plan(
    plan: Plan,
    name: str = "",
    *,
    format_version: Optional[int] = None,
    level: Optional[int] = None,
) -> bytes:
    return packb(plan_to_dict(plan, name, format_version=format_version, level=level))


def deserialize_plan(blob: bytes) -> Tuple[Plan, dict]:
    return plan_from_dict(unpackb(blob))


def plan_digest(
    plan: Plan,
    *,
    format_version: Optional[int] = None,
    level: Optional[int] = None,
) -> str:
    """Content address of a compression program: sha256 over the serialized
    form (topology, params and the deployment knobs that change output
    bytes).  The plan's name is not hashed, so renaming a plan keeps its
    address."""
    d = plan_to_dict(plan, format_version=format_version, level=level)
    d["name"] = ""  # plan_to_dict falls back to plan.name
    return hashlib.sha256(packb(d)).hexdigest()
