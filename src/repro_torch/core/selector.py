"""Function graphs / selectors — the port's copy of ``repro.core.selector``.

A selector is a named function ``fn(streams, params, ctx) -> Plan`` that picks
a sub-graph for its inputs at compression time.  The frame records only the
resolved graph, so the decoder never runs selectors.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

from .codec import InPort
from .graph import Plan
from .message import Stream

__all__ = ["SelectorSig", "SelectorSpec", "register_selector", "get_selector", "all_selectors"]

SelectorFn = Callable[[Sequence[Stream], dict, "CompressionCtx"], Plan]


@dataclass(frozen=True)
class SelectorSig:
    """Declared input signature of a selector.

    Selectors expand at compression time and have no static outputs: the
    signature states which stream types the selector is designed for.  Every
    selector degrades to ``store`` when its trial menu refuses the input, so
    a mismatch is a lint warning, never a type error.  ``inputs`` holds one
    ``InPort`` per declared input.
    """

    inputs: Tuple[InPort, ...]


@dataclass(frozen=True)
class SelectorSpec:
    name: str
    fn: SelectorFn
    doc: str = ""
    sig: Optional[SelectorSig] = None  # input signature (coverage-enforced)


_SELECTORS: Dict[str, SelectorSpec] = {}


def register_selector(spec: SelectorSpec) -> SelectorSpec:
    if spec.name in _SELECTORS:
        raise ValueError(f"duplicate selector {spec.name!r}")
    _SELECTORS[spec.name] = spec
    return spec


def get_selector(name: str) -> SelectorSpec:
    _ensure_loaded()
    try:
        return _SELECTORS[name]
    except KeyError:
        raise KeyError(
            f"unknown selector {name!r}; known: {sorted(_SELECTORS)}"
        ) from None


def all_selectors() -> Dict[str, SelectorSpec]:
    _ensure_loaded()
    return dict(_SELECTORS)


_loaded = False
_load_lock = threading.RLock()


def _ensure_loaded() -> None:
    global _loaded
    if not _loaded:
        with _load_lock:  # flag only set once the import completes
            if not _loaded:
                from repro_torch import codecs as _  # noqa: F401  (registers selectors)

                _loaded = True
