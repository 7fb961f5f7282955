"""Per-client token-bucket rate limiting for the service, the port's copy of
``repro.service.ratelimit``.

A :class:`TokenBucket` meters one client; a :class:`RateLimiter` keeps a
bounded map of buckets keyed by client identity (a per-connection key in the
threaded server, where every Unix-socket peer is local and equally trusted).
The server consults the limiter once per *parsed request header*, before any
body byte is buffered, so a client over its budget costs one header parse
and a drained (never stored) body, not a compression slot.

Rejections are structured, not silent: the server answers with
``error_kind="rate_limited"`` and a ``retry_after`` hint computed from the
bucket's actual refill horizon, so well-behaved clients (``ServiceClient``
with ``retries=``) back off for exactly as long as the budget needs.

The clock is injectable for deterministic tests; the default is
``time.monotonic``.  Host code only.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

__all__ = ["TokenBucket", "RateLimiter"]


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second, ``burst`` capacity.

    ``try_take()`` is O(1) and lock-free (the owner serializes calls).
    """

    __slots__ = ("rate", "burst", "tokens", "updated")

    def __init__(self, rate: float, burst: float, now: float):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.updated = now

    def try_take(self, now: float, cost: float = 1.0) -> Tuple[bool, float]:
        """Spend ``cost`` tokens -> (allowed, retry_after_seconds).

        ``retry_after`` is 0 when allowed, else the time until the bucket will
        hold ``cost`` tokens again at the configured refill rate.
        """
        elapsed = max(0.0, now - self.updated)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self.updated = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True, 0.0
        return False, (cost - self.tokens) / self.rate


class RateLimiter:
    """Bounded map of per-client token buckets.

    ``max_clients`` caps the table: when full, the stalest bucket (oldest
    ``updated``) is evicted, so an idle client's budget resets, never an
    active one's.  Thread-safe: the threaded ``CompressionServer`` consults
    one from many handler threads.
    """

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        *,
        max_clients: int = 4096,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(1.0, 2.0 * rate)
        self.max_clients = max_clients
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: Dict[str, TokenBucket] = {}
        self.rejected = 0
        self.allowed = 0

    def check(self, key: str, cost: float = 1.0) -> Tuple[bool, float]:
        """Charge ``cost`` against ``key``'s bucket -> (allowed, retry_after)."""
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                if len(self._buckets) >= self.max_clients:
                    stalest = min(
                        self._buckets, key=lambda k: self._buckets[k].updated
                    )
                    del self._buckets[stalest]
                bucket = TokenBucket(self.rate, self.burst, now)
                self._buckets[key] = bucket
            ok, retry_after = bucket.try_take(now, cost)
            if ok:
                self.allowed += 1
            else:
                self.rejected += 1
            return ok, retry_after

    def stats(self) -> dict:
        with self._lock:
            return {
                "rate": self.rate,
                "burst": self.burst,
                "clients": len(self._buckets),
                "allowed": self.allowed,
                "rejected": self.rejected,
            }
