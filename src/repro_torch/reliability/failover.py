"""Plan-digest quarantine for graceful degradation: the port's copy of
``repro.reliability.failover``'s :class:`Quarantine`.

:class:`Quarantine` is the serving layer's per-key circuit breaker: a plan
digest whose requests keep failing inside their session (``consecutive
failures >= threshold``) is quarantined for ``cooldown_s``, and requests for
it get a structured error instead of feeding a crash loop.  Any success
resets the count; expiry admits one probe whose outcome re-trips or clears.

The reference's ``BackendHealth`` has no counterpart: it sends a chunk to
the host after a device failure, and the port never retries a card's fault
on the host.  Standard library only, with an injectable ``clock`` for
deterministic tests.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["Quarantine"]


class Quarantine:
    """Circuit breaker keyed by an arbitrary string (the plan digest)."""

    def __init__(
        self,
        *,
        threshold: int = 3,
        cooldown_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive: Dict[str, int] = {}
        self._opened_at: Dict[str, float] = {}
        self._trips: Dict[str, int] = {}

    def blocked(self, key: str) -> Optional[float]:
        """Seconds until the quarantine on ``key`` lifts, or None when open.

        Expiry admits the next request as a probe: its outcome (via
        :meth:`record_failure` / :meth:`record_success`) re-trips or clears.
        """
        with self._lock:
            opened = self._opened_at.get(key)
            if opened is None:
                return None
            remaining = self.cooldown_s - (self._clock() - opened)
            if remaining <= 0:
                del self._opened_at[key]
                # leave the consecutive count at threshold-1: one more
                # failure re-trips immediately, one success clears
                self._consecutive[key] = self.threshold - 1
                return None
            return remaining

    def record_failure(self, key: str) -> None:
        with self._lock:
            n = self._consecutive.get(key, 0) + 1
            self._consecutive[key] = n
            if n >= self.threshold and key not in self._opened_at:
                self._opened_at[key] = self._clock()
                self._trips[key] = self._trips.get(key, 0) + 1

    def record_success(self, key: str) -> None:
        with self._lock:
            self._consecutive.pop(key, None)
            self._opened_at.pop(key, None)

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            keys = set(self._consecutive) | set(self._trips)
            return {
                k: {
                    "consecutive_failures": self._consecutive.get(k, 0),
                    "quarantined": k in self._opened_at,
                    "trips": self._trips.get(k, 0),
                }
                for k in sorted(keys)
            }
