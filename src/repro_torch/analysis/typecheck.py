"""Abstract interpretation of plans over the stream-type lattice: the port's
copy of ``repro.analysis.typecheck``, over the port's registries, ``SType``
and ``Plan``.  It reads signatures and stream types only, never a tensor's
data, so a check of a plan bound for the card causes no device sync.

An *atom* is one lattice point ``(stype, width)`` — ``stype`` is an
``int(SType)`` or ``None`` (unknown), ``width`` an ``int`` or ``None``
(unknown).  An edge's abstract value is a finite set of atoms: every concrete
stream type the edge could carry.  The checker walks a plan's nodes in their
(already topological) order, filters each input edge through the consuming
codec's declared :class:`~repro_torch.core.codec.InPort`, and pushes the declared
transfer function over the cartesian product of feasible input atoms.

Diagnostics are *definite*: an error means no concrete input typing can make
the plan execute (the trainer relies on this — statically pruned genomes must
be exactly genomes that would have scored INVALID at runtime).  Anything
merely suspicious (a selector off its declared types, recompressing
entropy-packed bytes, an identity ``store`` feeding the wire) is a warning.

Diagnostic catalogue
--------------------
==========  ========  =====================================================
code        severity  meaning
==========  ========  =====================================================
E_STRUCT    error     structural validation failed (arity/edges/consumption)
E_UNKNOWN   error     unknown codec/selector name or wire codec id
E_TYPE      error     ill-typed edge: no accepted stype reaches the input
E_WIDTH     error     stypes fit but no accepted width reaches the input
E_PARAMS    error     params/cross-input conflict: transfer rejects every
                      feasible input combination
E_VERSION   error     codec ``min_version`` exceeds the plan format version
W_SELECTOR  warning   selector wired off its declared input types
                      (trial menu will degrade to ``store``)
W_PACKED    warning   selector-after-terminal: consumer re-codes the packed
                      output of an entropy/bitpacking stage
W_DEAD      warning   dead node: identity ``store`` feeding the wire
I_EXPAND    info      worst-case expansion bound for a terminal edge
==========  ========  =====================================================
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.codec import InPort, get_codec, get_codec_by_id
from ..core.graph import KIND_CODEC, KIND_SELECTOR, Plan
from ..core.message import SType
from ..core.selector import get_selector

__all__ = [
    "Diagnostic",
    "PlanCheckReport",
    "PlanTypeError",
    "annotate_resolved_nodes",
    "atoms_for_streams",
    "check_plan",
    "fmt_atoms",
]

Atom = Tuple[Optional[int], Optional[int]]

_SERIAL = int(SType.SERIAL)
_STRUCT = int(SType.STRUCT)
_NUMERIC = int(SType.NUMERIC)
_STRING = int(SType.STRING)

#: Every concrete atom shape: the lattice top after normalization.
TOP_ATOMS = frozenset(
    [(_SERIAL, 1), (_STRING, 1), (_STRUCT, None)]
    + [(_NUMERIC, w) for w in (1, 2, 4, 8)]
)

_MAX_EDGE_ATOMS = 16  # collapse wider sets to TOP (keeps products bounded)
_MAX_PRODUCT = 4096  # cap on transfer enumeration; beyond -> sound TOP


def _normalize(atoms) -> frozenset:
    """Expand unknowns into the concrete shapes they may stand for."""
    out = set()
    for st, w in atoms:
        if st is None:
            out.update(TOP_ATOMS)
        elif st == _NUMERIC:
            if w is None:
                out.update((_NUMERIC, x) for x in (1, 2, 4, 8))
            else:
                out.add((_NUMERIC, w))
        elif st == _STRUCT:
            out.add((_STRUCT, w))
        else:  # SERIAL / STRING are always width 1
            out.add((st, 1))
    if len(out) > _MAX_EDGE_ATOMS:
        return TOP_ATOMS
    return frozenset(out)


def _fmt_atom(atom: Atom) -> str:
    st, w = atom
    if st is None:
        return "any"
    name = SType(st).name.lower()
    if st in (_SERIAL, _STRING):
        return name
    return f"{name}({'*' if w is None else w})"


def fmt_atoms(atoms) -> str:
    """Human form of an abstract edge value, e.g. ``numeric(4)`` or ``any``."""
    atoms = frozenset(atoms)
    if atoms >= TOP_ATOMS:
        return "any"
    if not atoms:
        return "none"
    # fold full numeric width fans back into numeric(*)
    widths = {w for st, w in atoms if st == _NUMERIC}
    parts = []
    if widths == {1, 2, 4, 8}:
        parts.append("numeric(*)")
        atoms = {a for a in atoms if a[0] != _NUMERIC}
    return "|".join(sorted(parts + [_fmt_atom(a) for a in atoms]))


def atoms_for_streams(streams) -> List[Atom]:
    """Concrete atoms of real input streams (resolve-time debug checks).

    Reads each stream's ``stype`` and ``width`` only: no tensor data."""
    return [(int(s.stype), int(s.width)) for s in streams]


@dataclass(frozen=True)
class Diagnostic:
    code: str
    severity: str  # "error" | "warning" | "info"
    message: str
    node: Optional[int] = None
    edge: Optional[int] = None

    def to_dict(self) -> dict:
        d = {"code": self.code, "severity": self.severity, "message": self.message}
        if self.node is not None:
            d["node"] = self.node
        if self.edge is not None:
            d["edge"] = self.edge
        return d

    def __str__(self) -> str:
        where = []
        if self.node is not None:
            where.append(f"node {self.node}")
        if self.edge is not None:
            where.append(f"edge {self.edge}")
        loc = f" {' '.join(where)}:" if where else ""
        return f"{self.severity}[{self.code}]{loc} {self.message}"


class PlanCheckReport:
    """Structured outcome of one plan check."""

    def __init__(self, diagnostics: List[Diagnostic], edge_types: Dict[int, frozenset]):
        self.diagnostics = list(diagnostics)
        self.edge_types = dict(edge_types)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def infos(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "info"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def render(self) -> str:
        if not self.diagnostics:
            return "clean: no diagnostics"
        return "\n".join(str(d) for d in self.diagnostics)


class PlanTypeError(ValueError):
    """Fail-closed rejection of an ill-typed plan.

    ``extra`` matches the service error-header convention (additive keys,
    no protocol magic bump): ``error_kind="ill_typed_plan"`` plus the
    structured ``diagnostics`` list.
    """

    def __init__(self, message: str, diagnostics: Sequence[Diagnostic] = ()):
        super().__init__(message)
        self.diagnostics = list(diagnostics)
        self.extra = {
            "error_kind": "ill_typed_plan",
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }


# ------------------------------------------------------------------- walker
class _Node:
    """One walkable node: a plan node or a wire-resolved node."""

    __slots__ = ("kind", "name", "inputs", "n_out", "params", "spec", "sig",
                 "min_version")

    def __init__(self, kind, name, inputs, n_out, params, spec, sig, min_version):
        self.kind = kind
        self.name = name
        self.inputs = tuple(inputs)
        self.n_out = int(n_out)
        self.params = dict(params)
        self.spec = spec
        self.sig = sig
        self.min_version = min_version


def _port_for(sig, j: int) -> Optional[InPort]:
    if sig is None or not sig.inputs:
        return None
    return sig.inputs[j] if j < len(sig.inputs) else sig.inputs[0]


def _filter_port(atoms: frozenset, port: Optional[InPort]):
    """Split an edge's atoms into (accepted, stype_ok) for one port."""
    if port is None:
        return atoms, True
    accepted = frozenset(a for a in atoms if port.accepts(a))
    stype_ok = any(a[0] is None or a[0] in port.stypes for a in atoms)
    return accepted, stype_ok


def _walk(
    n_inputs: int,
    nodes: List[_Node],
    *,
    format_version: Optional[int],
    input_atoms: Optional[Sequence[Atom]],
) -> Tuple[List[Diagnostic], Dict[int, frozenset], List[Tuple[str, str]]]:
    diags: List[Diagnostic] = []
    edge_types: Dict[int, frozenset] = {}
    node_types: List[Tuple[str, str]] = []  # (in, out) rendered per node

    if input_atoms is not None:
        for e, atom in enumerate(input_atoms[:n_inputs]):
            edge_types[e] = _normalize([atom])
    for e in range(n_inputs):
        edge_types.setdefault(e, TOP_ATOMS)

    expansion: Dict[int, float] = {e: 1.0 for e in range(n_inputs)}
    packed_edges = set()
    consumed = set()
    store_out_edge: Dict[int, int] = {}  # node index -> its store output edge

    eid = n_inputs
    for i, node in enumerate(nodes):
        out_ids = list(range(eid, eid + node.n_out))
        eid += node.n_out
        consumed.update(node.inputs)

        if node.spec is None and node.sig is None and node.name is not None:
            # unknown codec/selector: poison nothing, outputs unknown
            diags.append(Diagnostic(
                "E_UNKNOWN", "error",
                f"unknown {node.kind} {node.name!r}", node=i,
            ))

        if (
            format_version is not None
            and node.min_version is not None
            and node.min_version > format_version
        ):
            diags.append(Diagnostic(
                "E_VERSION", "error",
                f"codec {node.name!r} requires format version"
                f" >= {node.min_version}, plan declares {format_version}",
                node=i,
            ))

        sig = node.sig
        in_sets: List[frozenset] = []
        definite_reject = False
        for j, e in enumerate(node.inputs):
            atoms = edge_types.get(e, TOP_ATOMS)
            port = _port_for(sig, j)
            accepted, stype_ok = _filter_port(atoms, port)
            if not accepted:
                want = fmt_atoms(
                    _normalize((st, None) for st in port.stypes)
                    if port.widths is None
                    else [(st, w) for st in port.stypes for w in port.widths]
                )
                if not stype_ok:
                    diags.append(Diagnostic(
                        "E_TYPE", "error",
                        f"{node.kind} {node.name!r} input {j} expects {want},"
                        f" edge carries {fmt_atoms(atoms)}",
                        node=i, edge=e,
                    ))
                else:
                    diags.append(Diagnostic(
                        "E_WIDTH", "error",
                        f"{node.kind} {node.name!r} input {j} expects {want},"
                        f" edge carries incompatible width"
                        f" ({fmt_atoms(atoms)})",
                        node=i, edge=e,
                    ))
                if node.kind == KIND_SELECTOR:
                    # selectors degrade to store at runtime: downgrade
                    diags[-1] = Diagnostic(
                        "W_SELECTOR", "warning",
                        diags[-1].message + " — trial menu degrades to store",
                        node=i, edge=e,
                    )
                else:
                    definite_reject = True
                accepted = atoms  # keep walking with the unfiltered set
            in_sets.append(accepted)
            if e in packed_edges and (
                node.kind == KIND_SELECTOR
                or getattr(sig, "packed_outputs", ())
            ):
                diags.append(Diagnostic(
                    "W_PACKED", "warning",
                    f"{node.kind} {node.name!r} re-codes entropy-packed bytes"
                    f" from edge {e} (selector-after-terminal: wasted work)",
                    node=i, edge=e,
                ))

        # transfer over the product of feasible input atoms
        out_sets: List[set] = [set() for _ in out_ids]
        if node.kind == KIND_SELECTOR or sig is None or definite_reject:
            for s in out_sets:
                s.update(TOP_ATOMS)
        else:
            combos = 1
            for s in in_sets:
                combos *= max(len(s), 1)
            if combos > _MAX_PRODUCT or not node.inputs:
                feasible = True
                for s in out_sets:
                    s.update(TOP_ATOMS)
                if not node.inputs:
                    try:
                        outs = sig.transfer((), node.params, node.n_out)
                    except Exception:
                        outs = None
                    if outs is not None and len(outs) == node.n_out:
                        out_sets = [set(_normalize([a])) for a in outs]
            else:
                feasible = False
                for combo in itertools.product(*in_sets):
                    try:
                        outs = sig.transfer(tuple(combo), node.params, node.n_out)
                    except Exception:
                        feasible = True
                        for s in out_sets:
                            s.update(TOP_ATOMS)
                        continue
                    if outs is None:
                        continue
                    if len(outs) != node.n_out:
                        continue  # this combination cannot produce the wiring
                    feasible = True
                    for s, a in zip(out_sets, outs):
                        s.update(_normalize([a]))
                if not feasible:
                    diags.append(Diagnostic(
                        "E_PARAMS", "error",
                        f"codec {node.name!r}: no feasible typing —"
                        f" params {node.params or '{}'} / input combination"
                        f" rejected for inputs"
                        f" [{', '.join(fmt_atoms(s) for s in in_sets)}]"
                        f" with {node.n_out} outputs",
                        node=i,
                    ))
                    for s in out_sets:
                        s.update(TOP_ATOMS)

        in_bound = max((expansion.get(e, 1.0) for e in node.inputs), default=1.0)
        out_bound = in_bound * getattr(sig, "expansion", 1.0)
        for k, e in enumerate(out_ids):
            edge_types[e] = frozenset(out_sets[k]) or TOP_ATOMS
            expansion[e] = out_bound
            if k in getattr(sig, "packed_outputs", ()):
                packed_edges.add(e)

        if node.kind == KIND_CODEC and node.name == "store" and out_ids:
            store_out_edge[i] = out_ids[0]

        node_types.append((
            ", ".join(fmt_atoms(edge_types.get(e, TOP_ATOMS)) for e in node.inputs),
            ", ".join(fmt_atoms(edge_types[e]) for e in out_ids),
        ))

    for i, e in store_out_edge.items():
        if e not in consumed:
            diags.append(Diagnostic(
                "W_DEAD", "warning",
                "dead node: identity 'store' feeding the wire — storing its"
                " input directly is strictly smaller",
                node=i, edge=e,
            ))

    for e in range(eid):
        if e not in consumed:
            bound = expansion.get(e, 1.0)
            diags.append(Diagnostic(
                "I_EXPAND", "info",
                f"terminal edge {e} ({fmt_atoms(edge_types.get(e, TOP_ATOMS))}):"
                f" worst-case expansion <= {bound:.2f}x of graph input",
                edge=e,
            ))

    return diags, edge_types, node_types


def _plan_nodes(plan: Plan) -> List[_Node]:
    nodes = []
    for n in plan.nodes:
        spec = sig = None
        min_version = None
        try:
            if n.kind == KIND_CODEC:
                spec = get_codec(n.name)
                sig = spec.sig
                min_version = spec.min_version
            else:
                spec = get_selector(n.name)
                sig = spec.sig
        except KeyError:
            pass
        nodes.append(_Node(
            n.kind, n.name, n.inputs, n.n_out, n.param_dict(), spec, sig,
            min_version,
        ))
    return nodes


def check_plan(
    plan: Plan,
    *,
    format_version: Optional[int] = None,
    input_atoms: Optional[Sequence[Atom]] = None,
) -> PlanCheckReport:
    """Type-check a plan; never raises.

    ``format_version`` (when known, e.g. from a deserialized ``.ozp``) enables
    the ``min_version`` conflict check.  ``input_atoms`` pins the graph input
    types (one atom per input) — omitted inputs start at lattice top.
    """
    try:
        plan.validate()
    except KeyError as err:
        # validate() resolves codec names; an unknown one surfaces here
        return PlanCheckReport(
            [Diagnostic("E_UNKNOWN", "error", str(err.args[0] if err.args else err))], {}
        )
    except ValueError as err:
        return PlanCheckReport(
            [Diagnostic("E_STRUCT", "error", str(err))], {}
        )
    diags, edge_types, _ = _walk(
        plan.n_inputs, _plan_nodes(plan),
        format_version=format_version, input_atoms=input_atoms,
    )
    return PlanCheckReport(diags, edge_types)


def annotate_resolved_nodes(
    n_inputs: int, resolved_nodes, *, format_version: Optional[int] = None
) -> Tuple[List[Tuple[str, str]], PlanCheckReport]:
    """Infer per-node input/output stream types for wire-resolved nodes.

    ``resolved_nodes`` carry only ``codec_id``/``inputs``/``n_out`` (params
    live in opaque headers), so inference starts every graph input at lattice
    top and propagates what the signatures pin down.  Returns one rendered
    ``(input types, output types)`` pair per node plus the full report.
    """
    nodes = []
    for rn in resolved_nodes:
        spec = sig = None
        name = f"#{rn.codec_id}"
        min_version = None
        try:
            spec = get_codec_by_id(rn.codec_id)
            name = spec.name
            sig = spec.sig
            min_version = spec.min_version
        except KeyError:
            pass
        nodes.append(_Node(
            KIND_CODEC, name, rn.inputs, rn.n_out, {}, spec, sig, min_version,
        ))
    diags, edge_types, node_types = _walk(
        n_inputs, nodes, format_version=format_version, input_atoms=None
    )
    return node_types, PlanCheckReport(diags, edge_types)
