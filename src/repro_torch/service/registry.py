"""The plan registry: named, content-addressed compression configurations,
the port's copy of ``repro.service.registry``.

The paper's deployment story (§VIII) is one universal decoder plus
*registered trained configurations*: a service operator registers ``.ozp``
plans and named profiles once, and every client addresses them by a short id
or by content digest, the sha256 of the canonical serialized plan
(``repro_torch.core.serialize.plan_digest``, the reference's bytes), so two
registries that loaded the same plan agree on its address in either package
and a client pinning a digest can never be served a silently different
compressor.

Every ``register_*`` type-checks the plan first
(``repro_torch.analysis.check_plan``), as the reference's does, and fails
closed: an ill-typed plan raises ``PlanTypeError`` (its ``extra`` carries
``error_kind="ill_typed_plan"`` and the diagnostics) and nothing is
registered.  The check reads the plan and the codecs' signatures only, so it
launches nothing on the card.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Union

from ..analysis import PlanTypeError, check_plan
from ..core.engine import Compressor
from ..core.serialize import plan_digest

__all__ = ["PlanRegistry", "RegisteredPlan"]


@dataclass(frozen=True)
class RegisteredPlan:
    """One registry entry: a deployable compressor plus its addresses."""

    plan_id: str
    digest: str
    name: str
    source: str
    compressor: Compressor = field(compare=False, repr=False)

    def describe(self) -> dict:
        return {
            "plan_id": self.plan_id,
            "digest": self.digest,
            "name": self.name,
            "source": self.source,
            "format_version": self.compressor.format_version,
            "level": self.compressor.level,
            "n_nodes": len(self.compressor.plan.nodes),
        }


class PlanRegistry:
    """Thread-safe id/digest -> compressor mapping for the service."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_id: Dict[str, RegisteredPlan] = {}
        self._by_digest: Dict[str, RegisteredPlan] = {}

    # ---------------------------------------------------------- registration
    def register_compressor(
        self,
        comp: Compressor,
        plan_id: Optional[str] = None,
        *,
        source: str = "api",
    ) -> RegisteredPlan:
        # fail closed: an ill-typed plan would die mid-request on the first
        # matching payload; refuse it at the door with the full diagnosis
        report = check_plan(comp.plan, format_version=comp.format_version)
        if not report.ok:
            raise PlanTypeError(
                f"plan {comp.name or comp.plan.name or '?'!s} is ill-typed:"
                f" {'; '.join(str(d) for d in report.errors)}",
                report.errors,
            )
        digest = plan_digest(
            comp.plan, format_version=comp.format_version, level=comp.level
        )
        plan_id = plan_id or comp.name or comp.plan.name or digest[:12]
        entry = RegisteredPlan(plan_id, digest, comp.name, source, comp)
        with self._lock:
            existing = self._by_id.get(plan_id)
            if existing is not None:
                if existing.digest == digest:
                    return existing  # idempotent re-registration
                raise ValueError(
                    f"plan id {plan_id!r} already registered with a different"
                    f" plan (digest {existing.digest[:12]} != {digest[:12]})"
                )
            self._by_id[plan_id] = entry
            # first id to register a digest wins its digest address; later
            # aliases of the same plan stay resolvable by their own id
            self._by_digest.setdefault(digest, entry)
        return entry

    def register_file(
        self, path: Union[str, Path], plan_id: Optional[str] = None
    ) -> RegisteredPlan:
        """Load and register a serialized ``.ozp`` plan (id defaults to the
        file stem)."""
        path = Path(path)
        comp = Compressor.deserialize(path.read_bytes())
        return self.register_compressor(
            comp, plan_id or path.stem, source=f"file:{path}"
        )

    def register_profile(
        self, spec: str, plan_id: Optional[str] = None
    ) -> RegisteredPlan:
        """Register a named profile spec (``text``, ``struct:W1,W2``, ...).

        Raises ValueError on an unknown/malformed spec.
        """
        from ..codecs.profiles import resolve_profile_spec

        comp = Compressor(resolve_profile_spec(spec), name=spec)
        return self.register_compressor(
            comp, plan_id or spec, source=f"profile:{spec}"
        )

    # ------------------------------------------------------------ resolution
    def resolve(self, key: str) -> RegisteredPlan:
        """Look up by plan id, full digest, or unique digest prefix (>= 8)."""
        with self._lock:
            entry = self._by_id.get(key) or self._by_digest.get(key)
            if entry is not None:
                return entry
            if len(key) >= 8:
                hits = [
                    e for d, e in self._by_digest.items() if d.startswith(key)
                ]
                if len(hits) == 1:
                    return hits[0]
                if len(hits) > 1:
                    raise KeyError(
                        f"digest prefix {key!r} is ambiguous"
                        f" ({len(hits)} plans)"
                    )
            known = ", ".join(sorted(self._by_id)) or "(none)"
        raise KeyError(f"unknown plan {key!r}; registered: {known}")

    def entries(self) -> List[dict]:
        with self._lock:
            return [
                e.describe() for _, e in sorted(self._by_id.items())
            ]

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)

    def __contains__(self, key: str) -> bool:
        try:
            self.resolve(key)
            return True
        except KeyError:
            return False
