"""Plan files without msgpack: the port's ``core/serialize.py`` against
``msgpack`` and ``repro.core.serialize``.

Every tracked ``.ozp`` (the golden corpus's 50 and the 54 trained plans of
``results/trained/``) decodes to the dict ``msgpack.unpackb(..., raw=False)``
gives and re-packs to the file's bytes, and its ``plan_digest`` is the
reference's.  Seeded values of the msgpack subset, at every width boundary of
each format and with non-ASCII strings, pack byte-equal to
``msgpack.packb(..., use_bin_type=True)``.  Each malformed blob raises
``ValueError`` where msgpack does; the ``ext`` family, which msgpack returns
as ``ExtType``, is refused by the port (pinned).  All on the CPU, tolerance 0
(bytes equal).
"""
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

import repro_torch  # noqa: E402
from repro.core import serialize as ref_serialize  # noqa: E402
from repro.core.engine import Compressor as RefCompressor  # noqa: E402
from repro_torch.core import graph as port_graph  # noqa: E402
from repro_torch.core import serialize as S  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
OZP_FILES = sorted((REPO / "tests" / "golden").glob("*.ozp")) + sorted(
    (REPO / "results" / "trained").glob("*.ozp")
)
ILLTYPED = sorted((REPO / "tests" / "illtyped").glob("*.ozp"))


def _ref_pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(blob):
    return msgpack.unpackb(blob, raw=False)


def test_the_tracked_plan_files_are_all_here():
    assert len(OZP_FILES) == 104
    assert len(ILLTYPED) == 5


# ------------------------------------------------------------- tracked files
@pytest.mark.parametrize("path", OZP_FILES + ILLTYPED, ids=lambda p: p.name)
def test_tracked_plan_file_reads_and_repacks_as_msgpack(path):
    blob = path.read_bytes()
    d = S.unpackb(blob)
    assert d == _ref_unpack(blob)
    assert S.packb(d) == blob == _ref_pack(d)


@pytest.mark.parametrize("path", OZP_FILES, ids=lambda p: p.name)
def test_tracked_plan_file_loads_with_the_reference_plan_and_digest(path):
    blob = path.read_bytes()
    plan, meta = S.deserialize_plan(blob)
    ref_plan, ref_meta = ref_serialize.deserialize_plan(blob)
    assert meta == ref_meta
    assert plan.n_inputs == ref_plan.n_inputs and plan.name == ref_plan.name
    assert [(n.kind, n.name, n.inputs, n.n_out, n.params) for n in plan.nodes] == [
        (n.kind, n.name, n.inputs, n.n_out, n.params) for n in ref_plan.nodes
    ]
    knobs = dict(format_version=meta.get("format_version"), level=meta.get("level"))
    assert S.serialize_plan(plan, meta["name"], **knobs) == blob
    for kw in ({}, knobs, dict(format_version=3, level=9)):
        assert S.plan_digest(plan, **kw) == ref_serialize.plan_digest(ref_plan, **kw)
    # the facade: the reference's Compressor writes the knobs it defaults to
    comp = repro_torch.Compressor.deserialize(blob, device="cpu")
    assert comp.serialize() == RefCompressor.deserialize(blob).serialize()


def test_every_truncation_of_a_plan_file_fails_closed_in_both():
    for path in OZP_FILES[::13]:
        blob = path.read_bytes()
        for k in range(len(blob)):
            with pytest.raises(ValueError):
                _ref_unpack(blob[:k])
            with pytest.raises(ValueError):
                S.unpackb(blob[:k])


def test_plan_from_dict_is_reexported():
    assert port_graph.plan_from_dict is S.plan_from_dict
    assert repro_torch.plan_from_dict is S.plan_from_dict
    with pytest.raises(ValueError, match="serialized-compressor version"):
        S.plan_from_dict({"v": 2})


# ------------------------------------------------------------ the writer
INT_BOUNDARIES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1,
    -1, -31, -32, -33, -127, -128, -129, -32767, -32768, -32769,
    -(2**31) + 1, -(2**31), -(2**31) - 1, -(2**63) + 1, -(2**63),
]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("v", INT_BOUNDARIES)
def test_integer_at_each_width_boundary_packs_as_msgpack(v):
    assert S.packb(v) == _ref_pack(v)
    assert S.unpackb(S.packb(v)) == v


@pytest.mark.parametrize("n", LENGTHS)
def test_str_bin_array_map_at_each_length_boundary_pack_as_msgpack(n):
    rng = np.random.default_rng(n)
    ascii_ = "".join(chr(c) for c in rng.integers(32, 127, n))
    wide = "é" * (n // 2) + "x" * (n % 2)  # n UTF-8 bytes, n // 2 + n % 2 chars
    euro = "€" * (n // 3)
    raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    arr = [int(x) for x in rng.integers(-40, 300, n)]
    mapping = {f"k{i}": i for i in range(n)}
    for obj in (ascii_, wide, euro, raw, bytearray(raw), arr, tuple(arr), mapping):
        got = S.packb(obj)
        assert got == _ref_pack(obj)
        back = S.unpackb(got)
        assert back == _ref_unpack(got)


@pytest.mark.parametrize("v", [0.0, -0.0, 1.5, -2.25, 1e300, -1e-300, math.inf, -math.inf,
                               math.nan, 0.1, np.float64(3.5)])
def test_float_packs_as_float64(v):
    assert S.packb(v) == _ref_pack(v)
    back = S.unpackb(S.packb(v))
    assert (math.isnan(back) and math.isnan(v)) or back == v


def test_scalars_and_bool_before_int():
    for v in (None, True, False, [True, 1, False, 0], {"a": None}):
        assert S.packb(v) == _ref_pack(v)
        assert S.unpackb(S.packb(v)) == _ref_unpack(_ref_pack(v))
    assert S.packb(True) == b"\xc3" and S.packb(1) == b"\x01"


def _random_value(rng, depth=0):
    kind = int(rng.integers(0, 9 if depth < 4 else 5))
    if kind == 0:
        return INT_BOUNDARIES[int(rng.integers(0, len(INT_BOUNDARIES)))]
    if kind == 1:
        return int(rng.integers(-(2**40), 2**40))
    if kind == 2:
        n = int(rng.choice([0, 3, 31, 32, 200, 256]))
        return "".join(rng.choice(list("aZ0 éß€漢😀")) for _ in range(n))
    if kind == 3:
        return [None, True, False][int(rng.integers(0, 3))]
    if kind == 4:
        return float(rng.normal())
    if kind == 5:
        return rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
    if kind in (6, 7):
        return [_random_value(rng, depth + 1) for _ in range(int(rng.choice([0, 2, 15, 16, 17])))]
    return {f"key{i}é": _random_value(rng, depth + 1)
            for i in range(int(rng.choice([0, 1, 15, 16, 20])))}


@pytest.mark.parametrize("seed", range(12))
def test_seeded_random_values_pack_as_msgpack(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        obj = _random_value(rng)
        blob = S.packb(obj)
        assert blob == _ref_pack(obj)
        assert S.unpackb(blob) == _ref_unpack(blob)


def test_writer_refuses_what_msgpack_refuses():
    for v in (2**64, -(2**63) - 1):
        with pytest.raises(OverflowError):
            _ref_pack(v)
        with pytest.raises(OverflowError):
            S.packb(v)
    for v in ({1, 2}, object(), np.int64(3), {"a": 1}.keys()):
        with pytest.raises(TypeError):
            _ref_pack(v)
        with pytest.raises(TypeError):
            S.packb(v)
    with pytest.raises(UnicodeEncodeError):
        _ref_pack("\udc80")
    with pytest.raises(UnicodeEncodeError):
        S.packb("\udc80")


@pytest.mark.parametrize("inner", [0, []])
def test_writer_nesting_limit_is_msgpacks(inner):
    def nest(depth):
        x = inner
        for _ in range(depth):
            x = [x]
        return x

    assert S.packb(nest(511)) == _ref_pack(nest(511))
    with pytest.raises(ValueError):
        _ref_pack(nest(512))
    with pytest.raises(ValueError):
        S.packb(nest(512))


def test_non_str_map_keys_pack_as_msgpack_but_do_not_read():
    blob = S.packb({1: 2})
    assert blob == _ref_pack({1: 2})
    with pytest.raises(ValueError):
        _ref_unpack(blob)
    with pytest.raises(ValueError, match="not allowed for map key"):
        S.unpackb(blob)


# ------------------------------------------------------------ the reader
MALFORMED = {
    "empty": b"",
    "uint8 cut": b"\xcc",
    "uint16 cut": b"\xcd\x00",
    "int64 cut": b"\xd3\x00\x00\x00",
    "float64 cut": b"\xcb\x00\x00",
    "float32 cut": b"\xca\x00",
    "fixstr cut": b"\xa3ab",
    "str8 no length": b"\xd9",
    "str8 cut": b"\xd9\x05ab",
    "bin8 cut": b"\xc4\x05a",
    "array16 cut": b"\xdc\x00\x02\x01",
    "fixarray cut": b"\x93\x01\x02",
    "map16 cut": b"\xde\x00\x01\xa1a",
    "fixmap value missing": b"\x81\xa1a",
    "trailing byte": b"\x01\x02",
    "trailing after map": b"\x80\x80",
    "str32 past the end": b"\xdb\xff\xff\xff\xff",
    "bin32 past the end": b"\xc6\xff\xff\xff\xff",
    "array32 past the end": b"\xdd\xff\xff\xff\xff",
    "map32 past the end": b"\xdf\xff\xff\xff\xff",
    "str16 past the end": b"\xda\x01\x00abc",
    "int key": b"\x81\x01\x02",
    "nil key": b"\x81\xc0\x01",
    "array key": b"\x81\x90\x01",
    "float key": b"\x81\xcb\x00\x00\x00\x00\x00\x00\x00\x00\x01",
    "invalid utf-8": b"\xa2\xff\xfe",
    "lone continuation": b"\xa1\x80",
    "utf-8 surrogate": b"\xa3\xed\xa0\x80",
    "reserved 0xc1": b"\xc1",
    "1025 arrays": b"\x91" * 1025 + b"\x00",
    "1025 arrays, the last empty": b"\x91" * 1024 + b"\x90",
    "1025 containers, a map last": b"\x91" * 1024 + b"\x80",
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_blob_fails_closed_in_both(name):
    blob = MALFORMED[name]
    with pytest.raises(ValueError):
        _ref_unpack(blob)
    with pytest.raises(ValueError):
        S.unpackb(blob)


def test_nesting_up_to_msgpacks_stack_reads():
    for blob in (b"\x91" * 1024 + b"\x00", b"\x91" * 1023 + b"\x80",
                 b"\x91" * 1023 + b"\x81\xa1a\x01"):
        assert S.unpackb(blob) == _ref_unpack(blob)


def test_reader_takes_what_msgpack_takes_beyond_the_writer():
    # float32, bytes keys, duplicate keys (the last wins), non-shortest forms
    for blob in (b"\xca\x3f\x80\x00\x00", b"\x81\xc4\x01a\x01", b"\x82\xa1a\x01\xa1a\x02",
                 b"\xcc\x05", b"\xd0\x05", b"\xd9\x01a", b"\xdc\x00\x01\x07",
                 b"\xde\x00\x01\xa1k\xc0", b"\xc5\x00\x02ab"):
        assert S.unpackb(blob) == _ref_unpack(blob)


EXT = [b"\xd4\x01\x02", b"\xd5\x01\x02\x03", b"\xd6\x01" + b"\x00" * 4,
       b"\xd7\x01" + b"\x00" * 8, b"\xd8\x01" + b"\x00" * 16, b"\xc7\x01\x05a",
       b"\xc8\x00\x01\x05a", b"\xc9\x00\x00\x00\x01\x05a"]


@pytest.mark.parametrize("blob", EXT, ids=lambda b: f"0x{b[0]:02x}")
def test_ext_family_is_refused_where_msgpack_returns_an_ext_type(blob):
    """A difference by design: no plan holds an ext value, and the port's
    reader refuses the family (ROADMAP §3)."""
    assert isinstance(_ref_unpack(blob), (msgpack.ExtType, msgpack.Timestamp))
    with pytest.raises(ValueError, match="ext type"):
        S.unpackb(blob)


def test_declared_length_is_checked_before_allocation():
    # a 2^32 - 1 element array header over five bytes: refused at once
    with pytest.raises(ValueError, match="incomplete"):
        S.unpackb(b"\xdd\xff\xff\xff\xff\x00")
    with pytest.raises(ValueError, match="incomplete"):
        S.unpackb(b"\xdf\xff\xff\xff\xff" + b"\xa1a\x00" * 3)
