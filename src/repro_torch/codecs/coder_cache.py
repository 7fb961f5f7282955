"""LRU caches for entropy-coder tables — the port's copy of
``repro.codecs.coder_cache``.

Building a tANS table is ``O(2^table_log)`` and a Huffman decode LUT is
``O(2^15)``, both larger than a small chunk's coding work, so the tables are
memoized.  They are pure functions of small wire-visible descriptors
(nibble-packed code lengths, or normalized counts and table_log):

  * huffman encode:  key = code-length bytes        -> canonical codes
  * huffman decode:  key = code-length bytes        -> packed decode LUT
  * fse enc+dec:     key = (norm bytes, table_log)  -> host tables
  * fse decode:      key = (norm bytes, table_log)  -> packed decode tables

A table the kernels read on the card is cached under a key that ends with
its device (``str(tensor.device)``), beside the host table it was copied
from, so a table on the card is never handed to a CPU call and the reverse.

Thread safety: every cache is guarded by a lock; host values are numpy
arrays marked read-only and device values are tensors no caller writes, so
one value is shared by a session's pool threads.  The engine scopes a
cache to a call (:class:`repro_torch.core.engine.ExecScratch`,
:func:`scoped`), so one call and all of its chunks share a namespace.  A
session made without a cache of its own (``compress()``'s and
``decompress()``'s throwaway ones among them) scopes the cache active where
it is made: the process-wide default at top level, the enclosing call's
inside a selector trial.  So repeated calls build a table, and copy it to
the card, once.

``coder_cache_info()`` / ``coder_cache_clear()`` mirror the engine's
``resolve_cache_info()`` counters, over the process-wide cache.
``coder_cache_disabled()`` is a test hook proving frames are bit-identical
with caching on or off: it turns every cache off, scoped ones included.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

__all__ = [
    "CoderCache",
    "active_cache",
    "scoped",
    "coder_cache_info",
    "coder_cache_clear",
    "coder_cache_disabled",
]


class CoderCache:
    """A small thread-safe LRU mapping table descriptors to built tables.

    One instance holds every coder-table family, namespaced by a string tag
    in the key, so a single object can be shared across the chunk pool.
    """

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._data: "OrderedDict[tuple, object]" = OrderedDict()
        self._hits = 0
        self._misses = 0

    def get_or_build(self, key: tuple, builder: Callable[[], object]):
        """Return the cached value for ``key``, building (and caching) on miss.

        The builder runs outside the lock: two threads racing on one key
        both build, and the last write wins, which is harmless because
        tables are value-deterministic.
        """
        if _disabled:
            return builder()
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._data.move_to_end(key)
                self._hits += 1
                return hit
            self._misses += 1
        value = builder()
        with self._lock:
            self._data[key] = value
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
        return value

    def info(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "size": len(self._data),
                "maxsize": self.maxsize,
            }

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._hits = 0
            self._misses = 0


_GLOBAL = CoderCache()

# nesting depth of ``coder_cache_disabled()``; while above 0, every cache
# builds afresh and records nothing
_disabled = 0

# Per-call override, set by the engine so one compression call (and all of
# its pool threads, each of which enters the scope itself) shares a cache.
# A contextvar, not a bare thread-local, so nested scopes unwind correctly.
_ACTIVE: "contextvars.ContextVar[Optional[CoderCache]]" = contextvars.ContextVar(
    "repro_torch_coder_cache", default=None
)


def active_cache() -> CoderCache:
    """The cache coder implementations should consult right now."""
    return _ACTIVE.get() or _GLOBAL


@contextlib.contextmanager
def scoped(cache: CoderCache):
    """Make ``cache`` the active table cache for the enclosed block."""
    token = _ACTIVE.set(cache)
    try:
        yield cache
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def coder_cache_disabled():
    """Turn every coder-table cache off, scoped ones too — test hook.

    The reference's hook turns off only its process-wide cache, which its
    engine's per-call scopes bypass; here the engine path really builds
    every table afresh, so frames made under the hook prove the cache
    changes no byte.
    """
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def coder_cache_info() -> Dict[str, int]:
    """Hit/miss counters of the process-wide default cache."""
    return _GLOBAL.info()


def coder_cache_clear() -> None:
    _GLOBAL.clear()
