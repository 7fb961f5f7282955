"""Prebuilt compression graphs: the generic profile (one ``generic_auto``
selector over any stream: the reference CLI's default), the numeric profile
(one ``numeric_auto`` selector over a numeric column), the text profile
(``zlib_backend``), the float checkpoint profiles of the paper's §VIII
(``float32``, ``bfloat16``, ``float64``), and the record profiles: the
paper's §IV worked example (``sao``) and the generic record format
(``struct``), the CSV frontend of the paper's §VI-C (``csv``), and the
graph frontends (``graph``, ``graph:bin``).  ``named_profiles`` and
``resolve_profile_spec`` are the catalogue of names and specs the
reference's CLI and service accept."""
from __future__ import annotations

from typing import Sequence

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


# --------------------------------------------------------------- SAO (§IV)
SAO_FIELDS = [  # (name, width-bytes) — 28-byte records, 6 fields
    ("SRA0", 8),
    ("SDEC0", 8),
    ("IS", 2),
    ("MAG", 2),
    ("XRPM", 4),
    ("XDPM", 4),
]
SAO_HEADER_BYTES = 28


def sao_profile() -> Plan:
    """The paper's worked example (§IV, Table I), as a graph:

    header passthrough + field_split into the 6 star-record fields;
    SRA0 (mostly sorted)  -> interpret u64 -> delta -> transpose_split -> entropy
    SDEC0 (bounded)       -> interpret u64 -> transpose_split -> entropy/plane
    IS/MAG/XRPM/XDPM (low cardinality) -> tokenize; alphabet and indices get
    separate backends (sparse vs dense-bounded — paper §IV last bullet).
    """
    widths = [w for _, w in SAO_FIELDS]
    g = GraphBuilder(1)
    _header, body = g.add("split_n", g.input(0), n_out=2, sizes=[SAO_HEADER_BYTES, -1])
    # header: tiny, stored raw
    fields = g.add("field_split", body, n_out=len(widths), widths=widths)
    sra0, sdec0, is_f, mag, xrpm, xdpm = fields

    sra_num = g.add("interpret_numeric", sra0, width=8)
    sra_d = g.add("delta", sra_num)
    for p in g.add("transpose_split", sra_d, n_out=8):
        g.select("entropy_auto", p)

    sdec_num = g.add("interpret_numeric", sdec0, width=8)
    for p in g.add("transpose_split", sdec_num, n_out=8):
        g.select("entropy_auto", p)

    for f in (is_f, mag, xrpm, xdpm):
        alpha, idx = g.add("tokenize", f)
        g.add("transpose", alpha)  # sparse dictionary: byte planes then store
        g.select("numeric_auto", idx)  # dense bounded ints
    return g.build("sao")


def csv_profile(n_cols: int, sep: str = ",") -> Plan:
    """CSV frontend + per-column parse_numeric + auto backends (§VI-C)."""
    if n_cols < 1:
        raise ValueError(f"csv profile: column count must be >= 1, got {n_cols}")
    if not sep:
        raise ValueError("csv profile: separator must be non-empty")
    if "\n" in sep or "\r" in sep:
        raise ValueError("csv profile: separator cannot contain newlines")
    g = GraphBuilder(1)
    cols = g.add("csv_split", g.input(0), n_out=n_cols, sep=sep)
    if isinstance(cols, int):
        cols = [cols]
    for c in cols:
        bitmap, vals, exc = g.add("parse_numeric", c)
        g.select("bytes_auto", bitmap)
        g.select("numeric_auto", vals)
        exc_content, exc_lens = g.add("string_split", exc)
        g.select("bytes_auto", exc_content)
        g.select("numeric_auto", exc_lens)
    return g.build(f"csv{n_cols}")


def graph_profile(sep: str = "auto", window: int = 8) -> Plan:
    """Edge-list graph frontend: degree + delta-gap + reference coding.

    ``edge_list`` shreds ``u<sep>v`` lines into (src, dst) columns plus a
    parse bitmap and byte-exact exception lines (comments, blank lines);
    ``adjacency_auto`` then decides by trial whether Zuckerli-style
    reference/copy-list coding, plain gap coding, or raw columns wins for
    this graph's neighborhood structure.
    """
    g = GraphBuilder(1)
    src, dst, bitmap, exc = g.add("edge_list", g.input(0), sep=sep)
    g.select("adjacency_auto", src, dst, window=window)
    g.select("bytes_auto", bitmap)
    exc_content, exc_lens = g.add("string_split", exc)
    g.select("bytes_auto", exc_content)
    g.select("numeric_auto", exc_lens)
    return g.build("graph")


def graph_bin_profile(width: int = 4, window: int = 8) -> Plan:
    """CSR/binary edge-list graph frontend: interleaved fixed-width pairs."""
    if width not in (2, 4, 8):
        raise ValueError(f"graph:bin profile: width must be 2, 4 or 8, got {width}")
    g = GraphBuilder(1)
    src, dst = g.add("edge_list_bin", g.input(0), width=width)
    g.select("adjacency_auto", src, dst, window=window)
    return g.build(f"graph_bin{width}")


def struct_profile(widths: Sequence[int]) -> Plan:
    """Generic record format: field_split + per-field auto backend."""
    g = GraphBuilder(1)
    fields = g.add("field_split", g.input(0), n_out=len(widths), widths=list(widths))
    if isinstance(fields, int):
        fields = [fields]
    for f in fields:
        g.select("generic_auto", f)
    return g.build("struct" + "_".join(map(str, widths)))


# ------------------------------------------------------------ spec resolution
def named_profiles():
    """Parameterless named profiles: name -> (factory, one-line description).

    The single catalogue behind the CLI's ``--profile``/``profiles`` and the
    service registry's ``register_profile`` — add a profile here and every
    surface picks it up.
    """
    out = {}
    for name, fn, desc in [
        ("generic", generic_profile, "auto selector over any byte stream"),
        ("numeric", numeric_profile, "auto selector tuned for integer arrays"),
        ("text", text_profile, "LZ-style text graph (zlib backend)"),
        ("float32", float32_profile, "float_split fp32 checkpoint graph"),
        ("bfloat16", bfloat16_profile, "float_split bf16 embedding graph"),
        ("float64", float64_profile, "float_split fp64 graph"),
        ("sao", sao_profile, "the paper's SAO star-catalog graph (§IV)"),
        ("graph", graph_profile, "edge-list adjacency graph (Zuckerli-style)"),
    ]:
        doc = (fn.__doc__ or "").strip().splitlines()
        out[name] = (fn, doc[0] if doc and doc[0] else desc)
    return out


def resolve_profile_spec(spec: str) -> Plan:
    """Resolve a profile spec — a named profile, ``struct:W1,W2,..``,
    ``csv:N[:sep]`` or ``graph[:bin:W]`` — to a Plan.  Raises ValueError on
    an unknown or malformed spec (library-safe: callers decide how to exit)."""
    if spec.startswith("graph:"):
        parts = spec.split(":")
        if parts[1] == "bin":
            try:
                width = int(parts[2]) if len(parts) > 2 and parts[2] else 4
            except ValueError:
                raise ValueError(f"profile {spec!r}: bad pair width") from None
            if width not in (2, 4, 8) or len(parts) > 3:
                raise ValueError(
                    f"profile {spec!r}: expected graph:bin:W with W in 2/4/8"
                )
            return graph_bin_profile(width)
        sep = ":".join(parts[1:])  # "graph:::" means the separator is "::"
        if not sep or "\n" in sep or "\r" in sep:
            raise ValueError(
                f"profile {spec!r}: separator must be non-empty, newline-free"
            )
        return graph_profile(sep)
    if spec.startswith("struct:"):
        try:
            widths = [int(w) for w in spec[len("struct:") :].split(",") if w]
        except ValueError:
            raise ValueError(f"profile {spec!r}: bad field widths") from None
        if not widths or any(w < 1 for w in widths):
            raise ValueError(f"profile {spec!r}: field widths must be >= 1")
        return struct_profile(widths)
    if spec.startswith("csv:"):
        parts = spec.split(":")
        try:
            n_cols = int(parts[1])
        except (IndexError, ValueError):
            raise ValueError(f"profile {spec!r}: bad column count") from None
        # everything past the count is the separator verbatim ("csv:3::" is
        # ":"); csv_profile validates it
        sep = ":".join(parts[2:]) if len(parts) > 2 else ","
        try:
            return csv_profile(n_cols, sep)
        except ValueError as e:
            raise ValueError(f"profile {spec!r}: {e}") from None
    reg = named_profiles()
    if spec not in reg:
        raise ValueError(
            f"unknown profile {spec!r}; known: {', '.join(sorted(reg))},"
            f" struct:W1,W2,.., csv:N"
        )
    return reg[spec][0]()
