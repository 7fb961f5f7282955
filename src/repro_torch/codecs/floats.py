"""Floating-point plane splitting — the port's copy of ``repro.codecs.floats``.

The paper's §VIII checkpoint transform: the bit patterns of a float column
(model weights, optimizer state, embeddings) become a packed sign plane, an
exponent plane and a mantissa plane, so that the low-entropy exponents get
an entropy coder of their own.  Same codec id, header and output streams
as the reference:

  header  = u8 fmt, varint n
  outputs = [sign bits SERIAL (np.packbits order, ceil(n / 8) bytes),
             exponent NUMERIC u8 (u16 for float64),
             mantissa NUMERIC u8 / u16 / u32 / u64 (bf16 / f16 / f32 / f64)]

The encoder runs K7 and the decoder K8 on the device the streams lie on
(their plain PyTorch versions for CPU tensors), for all four formats; the
reference's device twin covered float32 only and sent the others to its
host encoder.  Everything is bit patterns on integer carriers: NaN
payloads, infinities, -0.0 and subnormals pass bit for bit.
"""
from __future__ import annotations

from ..core.codec import CodecSig, CodecSpec, InPort, ParamSpec, register_codec
from ..core.message import CARRIER, Stream, SType
from ..kernels import ops, ref
from ._util import HeaderReader, HeaderWriter, expect_stream, numeric_stream

_FMT_BY_WIDTH = {2: 0, 4: 2, 8: 3}  # default fmt per width (bf16 for w=2)


def _float_split_enc(streams, params):
    s = streams[0]
    if s.stype != SType.NUMERIC or s.width not in (2, 4, 8):
        raise ValueError("float_split wants numeric(2/4/8) bit patterns")
    fmt = int(params.get("fmt", _FMT_BY_WIDTH[s.width]))
    if fmt not in ref.FLOAT_FORMATS:
        raise ValueError(f"float_split: unknown fmt {fmt}")
    width = ref.FLOAT_FORMATS[fmt][0]
    if width != s.width:
        raise ValueError(f"float_split fmt {fmt} expects width {width}")
    sign, exp, man = ops.float_split(s.data, fmt)
    h = HeaderWriter().u8(fmt).varint(s.data.numel()).done()
    return [Stream(sign, SType.SERIAL, 1), numeric_stream(exp), numeric_stream(man)], h


def _float_split_transfer(atoms, params, n_out):
    st, w = atoms[0]
    fmt = params.get("fmt")
    if fmt is None:
        if w is None:
            return [(int(SType.SERIAL), 1), (int(SType.NUMERIC), None),
                    (int(SType.NUMERIC), None)]
        fmt = _FMT_BY_WIDTH.get(w)
    if fmt not in ref.FLOAT_FORMATS:
        return None
    fmt_w, _exp_bits, _man_bits, exp_w, man_w = ref.FLOAT_FORMATS[fmt]
    if w is not None and w != fmt_w:
        return None  # fmt tag must match the stream width
    return [(int(SType.SERIAL), 1), (int(SType.NUMERIC), exp_w), (int(SType.NUMERIC), man_w)]


def _float_split_dec(outs, header):
    signs_s, exp_s, man_s = outs
    r = HeaderReader(header)
    fmt = r.u8()
    n = r.varint()
    r.expect_end()
    if fmt not in ref.FLOAT_FORMATS:
        raise ValueError(f"float_split: unknown fmt {fmt}")
    _width, _exp_bits, _man_bits, exp_width, man_width = ref.FLOAT_FORMATS[fmt]
    # fail closed on planes that do not fit the header (before K8 reads them)
    expect_stream(signs_s, SType.SERIAL, 1, "float_split", "sign")
    for plane, w, what in ((exp_s, exp_width, "exponent"), (man_s, man_width, "mantissa")):
        if plane.stype != SType.NUMERIC or plane.data.dtype != CARRIER[w]:
            raise ValueError(f"float_split: the {what} plane is not numeric({w})")
        if plane.data.numel() != n:
            raise ValueError(f"float_split: the {what} plane holds {plane.data.numel()} of {n} values")
    sign = signs_s.raw()
    if sign.numel() < (n + 7) // 8:
        raise ValueError("float_split: the sign plane is shorter than ceil(n / 8) bytes")
    return [numeric_stream(ops.float_merge(sign, exp_s.data, man_s.data, fmt))]


register_codec(
    CodecSpec(
        "float_split",
        codec_id=18,
        encode=_float_split_enc,
        decode=_float_split_dec,
        n_outputs=3,
        min_version=3,
        doc="sign/exponent/mantissa planes (paper §VIII checkpoints; kernels K7, K8)",
        sig=CodecSig(
            inputs=(InPort(frozenset((int(SType.NUMERIC),)), frozenset((2, 4, 8))),),
            transfer=_float_split_transfer,
            params=(ParamSpec("fmt", "int", choices=(0, 1, 2, 3),
                              doc="0=bf16 1=f16 2=f32 3=f64 (default by width)"),),
            expansion=1.3,  # planes widen to whole dtypes + packed sign bits
        ),
    )
)
