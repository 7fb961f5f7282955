"""Genetic-programming operators over compression graphs (paper §VI-C).

The port's copy of ``repro.training.gp``: from the same ``random.Random``
every operator draws the same values and builds the same genome, and
``compile_genome`` the same plan.

A backend *genome* is a typed tree: each node applies a codec to its input
stream and routes every codec output to a child subtree (terminal = store).
Because a compression graph is "just a reversible computation graph", the
classic GP crossover (swap type-compatible subtrees) and mutation (replace /
insert / delete / re-param) apply directly — the paper's observation.

Type discipline: every edge has a (SType, width) signature; codec menus are
keyed by signature so random genomes are valid by construction.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.graph import GraphBuilder, Plan
from ..core.message import SType

Sig = Tuple[int, int]  # (stype, width)


@dataclass
class GNode:
    """Genome node: codec applied to one input; children per codec output."""

    codec: str
    params: dict = field(default_factory=dict)
    children: List[Optional["GNode"]] = field(default_factory=list)  # None=store

    def copy(self) -> "GNode":
        return GNode(
            self.codec,
            dict(self.params),
            [c.copy() if c else None for c in self.children],
        )

    def size(self) -> int:
        return 1 + sum(c.size() for c in self.children if c)


# ---------------------------------------------------------------- type rules
def _out_sigs(codec: str, params: dict, sig: Sig) -> Optional[List[Sig]]:
    """Output signatures of `codec` applied to a stream of signature `sig`.
    None => inapplicable.  Mirrors the codec implementations."""
    stype, w = sig
    N, S = int(SType.NUMERIC), int(SType.SERIAL)
    T, G = int(SType.STRUCT), int(SType.STRING)
    if codec == "store":
        return []
    if codec == "delta" or codec == "zigzag":
        return [sig] if stype == N else None
    if codec == "transpose":
        return [(S, 1)] if stype in (N, T) and w > 1 else None
    if codec == "transpose_split":
        return [(S, 1)] * w if stype in (N, T) and w > 1 else None
    if codec == "bitpack" or codec == "range_pack":
        return [(S, 1)] if stype == N else None
    if codec == "rle":
        return [sig, (N, 4)] if stype in (N, S, T) else None
    if codec == "tokenize":
        if stype in (N, S, T):
            return [sig, (N, 4)]  # index width varies; 4 is the upper bound
        if stype == G:
            return [sig, (N, 4)]
        return None
    if codec == "huffman" or codec == "fse":
        return [(S, 1), (N, 8 if codec == "huffman" else 4)] if (
            stype == S or (stype == N and w == 1) or (stype == T and w == 1)
        ) else None
    if codec == "lz77":
        return [(S, 1), (N, 4), (N, 4), (N, 4)] if stype in (S, N, T) else None
    if codec in ("zlib_backend", "lzma_backend", "bz2_backend"):
        return [(S, 1)] if stype != G else None
    if codec == "float_split":
        if stype == N and w in (2, 4, 8):
            return [(S, 1), (N, 2 if w == 8 else 1), (N, {2: 1, 4: 4, 8: 8}[w])]
        return None
    if codec == "interpret_numeric":
        want = params.get("width", w)
        return [(N, want)] if stype in (S, T) and want in (1, 2, 4, 8) else None
    if codec == "string_split":
        return [(S, 1), (N, 4)] if stype == G else None
    if codec == "parse_numeric":
        return [(S, 1), (N, 8), (G, 1)] if stype == G else None
    return None


MENU: Dict[int, List[str]] = {
    int(SType.NUMERIC): [
        "store",
        "delta",
        "zigzag",
        "transpose",
        "transpose_split",
        "bitpack",
        "range_pack",
        "rle",
        "tokenize",
        "huffman",
        "fse",
        "zlib_backend",
        "lzma_backend",
        "bz2_backend",
        "float_split",
        "lz77",
    ],
    int(SType.SERIAL): ["store", "huffman", "fse", "zlib_backend", "lzma_backend", "bz2_backend", "lz77", "rle", "tokenize"],
    int(SType.STRUCT): ["store", "transpose", "transpose_split", "interpret_numeric", "tokenize", "zlib_backend", "lzma_backend", "bz2_backend"],
    int(SType.STRING): ["store", "tokenize", "string_split", "parse_numeric"],
}

_VARIADIC_OUT = {"transpose_split": lambda sig: sig[1]}
_FIXED_OUT = {
    "store": 0, "delta": 1, "zigzag": 1, "transpose": 1, "bitpack": 1,
    "range_pack": 1, "rle": 2, "tokenize": 2, "huffman": 2, "fse": 2,
    "lz77": 4, "zlib_backend": 1, "lzma_backend": 1, "bz2_backend": 1, "float_split": 3, "interpret_numeric": 1,
    "string_split": 2, "parse_numeric": 3,
}


def n_out_for(codec: str, params: dict, sig: Sig) -> int:
    if codec in _VARIADIC_OUT:
        return _VARIADIC_OUT[codec](sig)
    return _FIXED_OUT[codec]


def _default_params(codec: str, sig: Sig, rng: random.Random) -> dict:
    if codec == "zlib_backend":
        return {"level": rng.choice([1, 6, 9])}
    if codec == "lzma_backend":
        return {"preset": rng.choice([0, 6, 9])}
    if codec == "bz2_backend":
        return {"level": 9}
    if codec == "fse":
        return {"table_log": rng.choice([10, 11, 12])}
    if codec == "interpret_numeric":
        w = sig[1]
        return {"width": w if w in (1, 2, 4, 8) else 1}
    if codec == "float_split":
        return {"fmt": {2: 0, 4: 2, 8: 3}.get(sig[1], 2)}
    return {}


def random_genome(sig: Sig, rng: random.Random, depth: int = 0, max_depth: int = 3) -> Optional[GNode]:
    """Random typed genome; None = store terminal."""
    if depth >= max_depth or rng.random() < 0.25 * depth:
        return None
    menu = [c for c in MENU.get(sig[0], ["store"]) if _out_sigs(c, {}, sig) is not None]
    if not menu:
        return None
    codec = rng.choice(menu)
    if codec == "store":
        return None
    params = _default_params(codec, sig, rng)
    outs = _out_sigs(codec, params, sig)
    if outs is None:
        return None
    node = GNode(codec, params)
    node.children = [random_genome(o, rng, depth + 1, max_depth) for o in outs]
    return node


# --------------------------------------------------------- genome -> Plan
def emit_genome(g: GraphBuilder, genome: Optional[GNode], edge: int, sig: Sig) -> None:
    """Inline a genome into an existing builder, rooted at `edge`.

    Permissive: a codec applied off its `_out_sigs` menu still *emits* (with
    children typed best-effort) — the compiled plan is ill-typed, and either
    the trainer's static pruning or the trial compression rejects it.  This
    keeps "can this genome be built?" (syntax) separate from "is it typed?"
    (the analyzer's job), so pruning measurably replaces failed encodes
    instead of hiding behind a construction-time raise.
    """
    if genome is None:
        return  # terminal: stream stored as-is
    outs_sigs = _out_sigs(genome.codec, genome.params, sig)
    n_out = n_out_for(genome.codec, genome.params, sig)
    if outs_sigs is None:
        outs_sigs = [sig] * n_out
    outs = g.add(genome.codec, edge, n_out=n_out, **genome.params)
    if isinstance(outs, int):
        outs = [outs]
    kids = genome.children + [None] * (len(outs) - len(genome.children))
    for child, oe, osig in zip(kids, outs, outs_sigs):
        emit_genome(g, child, oe, osig)


def compile_genome(genome: Optional[GNode], sig: Sig, n_inputs: int = 1) -> Plan:
    g = GraphBuilder(n_inputs)
    src = g.input(0)
    if n_inputs > 1:  # cluster grouping: concat first (paper §IV grouping)
        src = g.add("concat", *[g.input(i) for i in range(n_inputs)])
    emit_genome(g, genome, src, sig)
    return g.build("genome")


# ------------------------------------------------------------- GP operators
def _collect(node: GNode, sig: Sig, path=()):
    """Yield (path, node, sig) for every genome node."""
    yield path, node, sig
    outs = _out_sigs(node.codec, node.params, sig) or []
    for k, (child, osig) in enumerate(zip(node.children, outs)):
        if child is not None:
            yield from _collect(child, osig, path + (k,))


def _get(node: GNode, path):
    for k in path:
        node = node.children[k]
    return node


def _set(root: Optional[GNode], path, value: Optional[GNode]) -> Optional[GNode]:
    if not path:
        return value
    root = root.copy()
    cur = root
    for k in path[:-1]:
        cur.children[k] = cur.children[k].copy()
        cur = cur.children[k]
    cur.children[path[-1]] = value
    return root


def mutate(genome: Optional[GNode], sig: Sig, rng: random.Random) -> Optional[GNode]:
    if genome is None:
        return random_genome(sig, rng, depth=1)
    nodes = list(_collect(genome, sig))
    path, node, nsig = rng.choice(nodes)
    op = rng.random()
    if op < 0.4:  # replace subtree with a fresh random one
        return _set(genome, path, random_genome(nsig, rng, depth=1))
    if op < 0.6:  # delete (prune to terminal)
        return _set(genome, path, None)
    if op < 0.8:  # re-param
        new = node.copy()
        new.params = _default_params(node.codec, nsig, rng)
        return _set(genome, path, new)
    # insert: wrap subtree under a new compatible node (child 0)
    menu = [c for c in MENU.get(nsig[0], []) if c != "store" and _out_sigs(c, _default_params(c, nsig, rng), nsig)]
    if not menu:
        return genome
    codec = rng.choice(menu)
    params = _default_params(codec, nsig, rng)
    outs = _out_sigs(codec, params, nsig)
    wrapper = GNode(codec, params, [None] * len(outs))
    if outs and outs[0] == nsig:
        wrapper.children[0] = node.copy()
    return _set(genome, path, wrapper)


def crossover(
    a: Optional[GNode], b: Optional[GNode], sig: Sig, rng: random.Random
) -> Optional[GNode]:
    if a is None or b is None:
        return (b or a).copy() if (b or a) else None
    na = list(_collect(a, sig))
    nb = list(_collect(b, sig))
    # pick a donor subtree from b whose signature matches a cut point in a
    rng.shuffle(na)
    for path, _node, nsig in na:
        donors = [n for _, n, s in nb if s == nsig]
        if donors:
            return _set(a, path, rng.choice(donors).copy())
    return a.copy()
