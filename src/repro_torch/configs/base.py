"""Architecture registry: every LM arch is a selectable config (``--arch
<id>``) with its own input-shape set and a reduced smoke variant; the port
of ``repro.configs.base`` without the dry-run's ``input_specs``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode" | "serve" | "retrieval"
    dims: Dict[str, int]
    skip: Optional[str] = None  # reason string when the cell is inapplicable


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys"
    source: str  # citation tag from the assignment
    model_cfg: Any
    shapes: Tuple[ShapeSpec, ...]
    reduced_cfg: Any  # smoke-test configuration
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id}: unknown shape {name!r}")

    def runnable_shapes(self) -> List[ShapeSpec]:
        return [s for s in self.shapes if s.skip is None]


_REGISTRY: Dict[str, ArchSpec] = {}


def register_arch(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch {spec.arch_id}")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _load_all()
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}"
        ) from None


def all_archs() -> Dict[str, ArchSpec]:
    _load_all()
    return dict(_REGISTRY)


_loaded = False


def _load_all() -> None:
    global _loaded
    if not _loaded:
        _loaded = True
        from . import (  # noqa: F401
            h2o_danube3_4b,
            kimi_k2_1t_a32b,
            llama3_2_1b,
            olmoe_1b_7b,
            yi_9b,
        )
