"""Prebuilt compression graphs: the generic profile (one ``generic_auto``
selector over any stream: the reference CLI's default), the numeric profile
(one ``numeric_auto`` selector over a numeric column), the text profile
(``zlib_backend``) and the float checkpoint profiles of the paper's §VIII
(``float32``, ``bfloat16``, ``float64``)."""
from __future__ import annotations

from ..core.graph import GraphBuilder, Plan, pipeline


def generic_profile() -> Plan:
    g = GraphBuilder(1)
    g.select("generic_auto", g.input(0))
    return g.build("generic")


def text_profile(level: int = 6) -> Plan:
    return pipeline(("zlib_backend", {"level": level}), name="text")


def numeric_profile() -> Plan:
    g = GraphBuilder(1)
    g.select("numeric_auto", g.input(0))
    return g.build("numeric")


def _float_profile(fmt: int, name: str) -> Plan:
    """float_split -> per-plane backends (paper §VIII checkpoint trick).

    signs: usually balanced -> ``bytes_auto``.  exponents: very low entropy
    -> ``entropy_auto``.  mantissae: near-random low bytes; the numeric
    menu's transpose exposes the near-constant top byte(s).
    """
    g = GraphBuilder(1)
    signs, exp, man = g.add("float_split", g.input(0), fmt=fmt)
    g.select("bytes_auto", signs)
    g.select("entropy_auto", exp)
    g.select("numeric_auto", man)
    return g.build(name)


def float32_profile() -> Plan:
    return _float_profile(2, "float32")


def bfloat16_profile() -> Plan:
    return _float_profile(0, "bfloat16")


def float64_profile() -> Plan:
    return _float_profile(3, "float64")
