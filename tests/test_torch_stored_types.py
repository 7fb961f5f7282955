"""Every port decoder checks the type tag of each stream its encoder writes.

A frame records each stored stream's type and width.  A decoder that read a
retagged stream as bytes would rebuild its input from the wrong layout, so
each decoder of ``repro_torch`` raises ``ValueError`` (or ``FrameError``)
unless a stream is the ``(stype, width)`` its encoder writes.

Each case compresses a small input with the reference
(``backend="device"``), changes the type tag of one stored stream to another
type whose width divides its payload, reseals the CRC, and decodes the frame
in both packages.  The port fails closed on every one.  The reference
refuses some (its exception type may differ) and decodes others, sometimes
to the input and sometimes to scrambled bytes; where it decodes, the test
pins the SHA-256 of what it gives, so a change on either side shows.
"""
import hashlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import decompress as ref_decompress  # noqa: E402
from repro.core import numeric as ref_numeric  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import serial as ref_serial  # noqa: E402
from repro.core import strings as ref_strings  # noqa: E402
from repro.core import struct as ref_struct  # noqa: E402
from repro.core import wire as ref_wire  # noqa: E402
from repro.core.graph import GraphBuilder as RefGraphBuilder  # noqa: E402
from repro.core.message import SType as RefSType  # noqa: E402
from repro.core.message import from_wire as ref_from_wire  # noqa: E402
from repro_torch.core.wire import FrameError  # noqa: E402

GOLDEN_DIR = Path(__file__).parent / "golden"

# The reference's frame of pipeline("transpose") over numeric([1, 2], u16),
# its stored SERIAL(1) planes retagged NUMERIC(2) and the CRC resealed.
TRANSPOSE_27_BYTES = bytes.fromhex("4f5a4c4a0401010501000102020201010202040102000082c9f334")

_RNG = np.random.default_rng(0)
_SKEW = _RNG.geometric(0.3, 5000).clip(0, 255).astype(np.uint8).tobytes()
_F32 = _RNG.normal(0, 1, 64).astype(np.float32).view(np.uint32)


def _adj_plan():
    g = RefGraphBuilder(2)
    g.add("adj_gap", 0, 1, window=0)
    return g.build("adj")


# name -> (plan, inputs, producing codec id, which of its stored streams, new (stype, width))
CASES = {
    "transpose": (lambda: ref_pipeline("transpose"),
                  lambda: [ref_numeric(np.arange(64, dtype=np.uint32) * 977)], 5, 0, None),
    "transpose_split": (lambda: ref_pipeline(("transpose_split", {"n_out": 4})),
                        lambda: [ref_numeric(np.arange(64, dtype=np.uint32) * 977)], 22, 0, None),
    "huffman_bits": (lambda: ref_pipeline("huffman"), lambda: [ref_serial(_SKEW)], 14, 0, None),
    "huffman_offsets": (lambda: ref_pipeline("huffman"), lambda: [ref_serial(_SKEW)], 14, 1, None),
    "fse_bits": (lambda: ref_pipeline("fse"), lambda: [ref_serial(_SKEW)], 15, 0, None),
    "range_pack": (lambda: ref_pipeline("range_pack"),
                   lambda: [ref_numeric(np.arange(1000, 1100, dtype=np.uint32))], 13, 0, None),
    "bitpack": (lambda: ref_pipeline("bitpack"),
                lambda: [ref_numeric((np.arange(96) % 7).astype(np.uint8))], 6, 0, None),
    "fused_delta_bitpack": (lambda: ref_pipeline("delta", "bitpack"),
                            lambda: [ref_numeric(np.arange(0, 6000, 15, dtype=np.uint32))],
                            26, 0, None),
    "float_split_signs": (lambda: ref_pipeline("float_split"),
                          lambda: [ref_numeric(_F32)], 18, 0, None),
    "float_split_exponents": (lambda: ref_pipeline("float_split"),
                              lambda: [ref_numeric(_F32)], 18, 1, None),
    "parse_numeric": (lambda: ref_pipeline("parse_numeric"),
                      lambda: [ref_strings([b"12", b"-7", b"x", b"400", b"0012"])], 19, 1,
                      (RefSType.NUMERIC, 4)),
    "rle": (lambda: ref_pipeline("rle"),
            lambda: [ref_numeric(np.repeat(np.arange(8, dtype=np.uint16), 5))], 7, 1, None),
    "tokenize": (lambda: ref_pipeline("tokenize"),
                 lambda: [ref_numeric(np.tile(np.arange(5, dtype=np.uint16) * 300, 8))], 9, 1,
                 None),
    "lz77": (lambda: ref_pipeline("lz77"),
             lambda: [ref_serial(b"abcabcabcabcabcabcxyzxyzxyzabcabc" * 4)], 16, 1,
             (RefSType.NUMERIC, 2)),
    "zlib_backend": (lambda: ref_pipeline("zlib_backend"),
                     lambda: [ref_serial(b"hello hello hello hello")], 17, 0,
                     (RefSType.STRUCT, 1)),
    "string_split": (lambda: ref_pipeline("string_split"),
                     lambda: [ref_strings([b"ab", b"cde", b"", b"f"])], 21, 1,
                     (RefSType.NUMERIC, 2)),
    "field_split": (lambda: ref_pipeline(("field_split", {"widths": [2, 2], "n_out": 2})),
                    lambda: [ref_struct(np.arange(64, dtype=np.uint8).tobytes(), 4)], 10, 0,
                    (RefSType.NUMERIC, 2)),
    "split_n": (lambda: ref_pipeline(("split_n", {"sizes": [4, -1], "n_out": 2})),
                lambda: [ref_numeric(np.arange(12, dtype=np.uint16))], 11, 1,
                (RefSType.SERIAL, 1)),
    "dup": (lambda: ref_pipeline("dup"), lambda: [ref_numeric(np.arange(12, dtype=np.uint16))],
            2, 1, (RefSType.SERIAL, 1)),
    "interpret_numeric": (lambda: ref_pipeline(("interpret_numeric", {"width": 4})),
                          lambda: [ref_serial(bytes(range(32)))], 23, 0, (RefSType.SERIAL, 1)),
    "edge_list": (lambda: ref_pipeline("edge_list"),
                  lambda: [ref_serial(b"1\t2\n3\t4\n5\t6\n")], 27, 0, (RefSType.NUMERIC, 4)),
    "edge_list_bin": (lambda: ref_pipeline(("edge_list_bin", {"width": 4})),
                      lambda: [ref_serial(np.arange(16, dtype=np.uint32).tobytes())], 29, 1,
                      (RefSType.NUMERIC, 2)),
    "adj_gap": (_adj_plan,
                lambda: [ref_numeric(np.array([0, 0, 1, 1, 2], np.uint64)),
                         ref_numeric(np.array([1, 2, 2, 3, 3], np.uint64))], 28, 0,
                (RefSType.NUMERIC, 4)),
}
# golden vectors whose retagged stream is one a codec inside a profile writes
GOLDEN_CASES = {"profile_sao": 5, "profile_struct44": 14}

# SHA-256 of what the reference's decoder gives for each retagged frame, or
# None where it raises.
REF_GIVES = {
    "transpose": "9773bd840a91378fbf4eb060d663fd4d2dc0f93198347ce1ce785ebeaa5a3842",
    "transpose_split": None,
    "huffman_bits": "34b2f7bd7bf58a1d4286b2d9fdb7806ce04efd6fa8660c01e4d1df7f20ed74fb",
    "huffman_offsets": None,
    "fse_bits": None,
    "range_pack": None,
    "bitpack": None,
    "fused_delta_bitpack": None,
    "float_split_signs": None,
    "float_split_exponents": None,
    "parse_numeric": "3d97964b5e0a14cf70968a63f5b0d76f7413aa58646494e82ee0935898e74744",
    "rle": None,
    "tokenize": "742812050fbe995a7f85892df6f96f6eaf170afed731da0b9c4d1efc7ba84016",
    "lz77": "dbac277ae355aff0d34db81ac71a524dac4d38e453a7318dec75d8472126d253",
    "zlib_backend": "eac13dc78da3f79858440011e4db4107e9301314511e6d0073320b14c535b824",
    "string_split": "bef57ec7f53a6d40beb640a780a639c83bc29ac8a9816f1fc6c5c6dcd93c4721",
    "field_split": None,
    "split_n": "69dd740bc6bc0605e7e0d318dfc5064d0256cd6cbf075d71f5ca763d914fb3e0",
    "dup": "a46b67c8fb1c4c35fdfc8387c647f8c442a84e1520334a92a127f740b4c1dd5c",
    "interpret_numeric": "630dcd2966c4336691125448bbb25b4ff412a49c732db2c8abc1b8581bd710dd",
    "edge_list": "dbd0f93207ae6da7c7139fb0bcd97d4abe3fecd7cf66745c70c57df084c9b9c5",
    "edge_list_bin": None,
    "adj_gap": "5fd8740f5a7fed9390abfa9202c19a67986916bfb504cf6fc221a7fa6665abe3",
    "profile_sao": "7b160f596a126bac8c6f5fa7d6f80e141655c49e50a5e67cd76fc15572fdacb5",
    "profile_struct44": "1a9d0dc0caacf301ea6d2f491d43175f68e8346b7f2880111b1b0eb7280881c2",
}

_ALTERNATIVES = (
    (RefSType.NUMERIC, 2), (RefSType.NUMERIC, 4), (RefSType.SERIAL, 1),
    (RefSType.NUMERIC, 1), (RefSType.STRUCT, 2), (RefSType.NUMERIC, 8),
)


def _retag(frame: bytes, codec_id: int, k: int, to):
    """``frame`` with the k-th stored stream that ``codec_id`` writes retagged
    (to ``to``, or the first alternative type that divides its payload) and
    the CRC resealed by the reference's writer."""
    version, n_inputs, nodes, stored = ref_wire.read_frame(frame)
    producer, edge = {}, n_inputs
    for node in nodes:
        for e in range(edge, edge + node.n_out):
            producer[e] = node.codec_id
        edge += node.n_out
    eid = [e for e in sorted(stored) if producer.get(e) == codec_id][k]
    s = stored[eid]
    payload = s.data.tobytes()
    if to is None:
        to = next(a for a in _ALTERNATIVES
                  if a != (s.stype, s.width) and len(payload) % a[1] == 0)
    stored[eid] = ref_from_wire(to[0], to[1], payload, None)
    return ref_wire.write_frame(version, n_inputs, nodes, sorted(stored.items()))


def _frames(name):
    """(the untouched frame, the retagged one, the input's bytes)."""
    if name in GOLDEN_CASES:
        frame = (GOLDEN_DIR / f"{name}.ozl").read_bytes()
        return frame, _retag(frame, GOLDEN_CASES[name], 0, None), None
    plan, inputs, codec_id, k, to = CASES[name]
    ins = inputs()
    frame = ref_compress(plan(), ins, backend="device", use_resolve_cache=False)
    return frame, _retag(frame, codec_id, k, to), b"".join(s.content_bytes() for s in ins)


def _ref_gives(frame: bytes) -> str:
    return hashlib.sha256(b"".join(s.content_bytes() for s in ref_decompress(frame))).hexdigest()


ALL = sorted(CASES) + sorted(GOLDEN_CASES)


def test_the_smallest_retagged_frame_fails_closed_in_the_port():
    plan = ref_pipeline("transpose")
    frame = ref_compress(plan, [ref_numeric(np.array([1, 2], np.uint16))], backend="device",
                         use_resolve_cache=False)
    assert _retag(frame, 5, 0, (RefSType.NUMERIC, 2)) == TRANSPOSE_27_BYTES
    (out,) = ref_decompress(TRANSPOSE_27_BYTES)
    assert out.content_bytes() == bytes([1, 2, 0, 0])  # the reference's scrambled bytes
    with pytest.raises(ValueError, match="transpose: the plane stream is numeric"):
        repro_torch.decompress(TRANSPOSE_27_BYTES, device="cpu")


@pytest.mark.parametrize("name", ALL)
def test_the_untouched_frame_decodes_in_both_packages(name):
    frame, _bad, raw = _frames(name)
    outs = repro_torch.decompress(frame, device="cpu")
    got = b"".join(s.content_bytes() for s in outs)
    assert got == b"".join(s.content_bytes() for s in ref_decompress(frame))
    if raw is not None:
        assert got == raw


@pytest.mark.parametrize("name", ALL)
def test_a_retagged_stream_fails_closed_in_the_port(name):
    _frame, bad, _raw = _frames(name)
    with pytest.raises((ValueError, FrameError)):
        repro_torch.decompress(bad, device="cpu")
    if REF_GIVES[name] is None:
        with pytest.raises(Exception):
            ref_decompress(bad)
    else:
        assert _ref_gives(bad) == REF_GIVES[name]
