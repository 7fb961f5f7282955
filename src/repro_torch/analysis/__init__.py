"""Static plan analysis (paper §III-C: edges of the graph are *typed*).

``typecheck`` abstractly interprets a :class:`~repro_torch.core.graph.Plan`
over the stream-type lattice using the signature every codec and selector
declares (:class:`~repro_torch.core.codec.CodecSig`) and emits structured
diagnostics before a byte is compressed or a kernel launched.

Fail-closed integration points:

* ``PlanRegistry.register_*`` refuses ill-typed plans (``PlanTypeError``).
* ``python -m repro_torch lint PLAN.ozp`` prints diagnostics, exit 1 on error.
* ``inspect`` annotates each frame node with ``  :: in -> out``.
* The engine's resolve gains an opt-in debug assert
  (``REPRO_RESOLVE_CHECK=1`` or ``set_resolve_check(True)``).
"""
from .typecheck import (  # noqa: F401
    Diagnostic,
    PlanCheckReport,
    PlanTypeError,
    annotate_resolved_nodes,
    atoms_for_streams,
    check_plan,
    fmt_atoms,
)

__all__ = [
    "Diagnostic",
    "PlanCheckReport",
    "PlanTypeError",
    "annotate_resolved_nodes",
    "atoms_for_streams",
    "check_plan",
    "fmt_atoms",
]
