"""Prometheus-style text rendering of the daemon's stats, the port's copy of
``repro.service.metrics``: the same text, byte for byte, for the same stats
dict.

The ``stats`` verb grew a scrape format instead of a new verb: a request
header of ``{"format": "prometheus"}`` (an *additive* header key; the framed
protocol's magic, verbs and layout are untouched, per the protocol-stability
policy) returns the same counters as the dict form, rendered as Prometheus
exposition text in the response body.  Old clients that never send the key
keep getting the msgpack map header they always got.

Rendering is pure: ``render_prometheus(stats)`` takes the stats dict and
emits deterministic, sorted output; scraping twice with no traffic in
between yields identical bytes except for ``ozl_uptime_seconds``.  The
multi-process plane's keys (``workers``, ``worker_restarts``,
``per_worker``) and ``backend_health`` are rendered when present, as the
reference renders them; the port's threaded server reports
``backend_health`` as ``{}``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["render_prometheus", "CONTENT_TYPE"]

#: Exposition-format content type, reported in the response header.
CONTENT_TYPE = "text/plain; version=0.0.4"


def _esc(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float):
        return repr(value)
    return str(value)


class _Writer:
    def __init__(self):
        self.lines: List[str] = []
        self._described: set = set()

    def sample(
        self,
        name: str,
        value,
        labels: Optional[Dict[str, str]] = None,
        *,
        help_: str = "",
        type_: str = "gauge",
    ) -> None:
        if value is None:
            return
        if name not in self._described:
            self._described.add(name)
            if help_:
                self.lines.append(f"# HELP {name} {help_}")
            self.lines.append(f"# TYPE {name} {type_}")
        if labels:
            inner = ",".join(
                f'{k}="{_esc(v)}"' for k, v in sorted(labels.items())
            )
            self.lines.append(f"{name}{{{inner}}} {_fmt(value)}")
        else:
            self.lines.append(f"{name} {_fmt(value)}")

    def render(self) -> bytes:
        return ("\n".join(self.lines) + "\n").encode()


def render_prometheus(stats: dict) -> bytes:
    """Render a server/plane stats dict as Prometheus exposition text.

    Unknown keys are ignored, missing keys are skipped: the renderer accepts
    the single-process server's dict and the reference plane's aggregate
    (which adds ``workers``/``worker_restarts``/``per_worker``).
    """
    w = _Writer()
    w.sample(
        "ozl_uptime_seconds", stats.get("uptime_s"),
        help_="Seconds since the serving process started.",
    )
    w.sample(
        "ozl_plans", stats.get("plans"),
        help_="Registered compression plans.",
    )
    for verb, count in sorted((stats.get("requests") or {}).items()):
        w.sample(
            "ozl_requests_total", count, {"verb": verb},
            help_="Requests handled, by verb.", type_="counter",
        )
    w.sample(
        "ozl_errors_total", stats.get("errors"),
        help_="Requests answered with an error response.", type_="counter",
    )
    w.sample(
        "ozl_shed_total", stats.get("shed"),
        help_="Requests shed by admission control.", type_="counter",
    )
    w.sample(
        "ozl_rate_limited_total", stats.get("rate_limited"),
        help_="Requests rejected by per-client rate limiting.",
        type_="counter",
    )
    w.sample(
        "ozl_bytes_total", stats.get("bytes_in"), {"direction": "in"},
        help_="Payload bytes through the daemon.", type_="counter",
    )
    w.sample("ozl_bytes_total", stats.get("bytes_out"), {"direction": "out"})
    w.sample(
        "ozl_connections_total", stats.get("connections"),
        help_="Connections accepted.", type_="counter",
    )
    w.sample(
        "ozl_active_connections", stats.get("active_connections"),
        help_="Connections currently open.",
    )

    # latency quantiles + recent request rate, per verb
    for verb, lat in sorted((stats.get("latency") or {}).items()):
        for q_key, q_label in (("p50_ms", "0.5"), ("p99_ms", "0.99")):
            if lat.get(q_key) is not None:
                w.sample(
                    "ozl_request_duration_ms", lat[q_key],
                    {"verb": verb, "quantile": q_label},
                    help_="Recent request latency quantiles (ms), by verb.",
                    type_="summary",
                )
        w.sample(
            "ozl_requests_per_second", lat.get("req_s"), {"verb": verb},
            help_="Recent request rate over the sliding latency window.",
        )

    # session pool occupancy per plan digest
    for digest, counters in sorted((stats.get("sessions") or {}).items()):
        for state in ("created", "idle", "in_use"):
            w.sample(
                "ozl_sessions", counters.get(state),
                {"digest": digest[:12], "state": state},
                help_="Compressor-session pool occupancy, by plan digest.",
            )
        w.sample(
            "ozl_session_acquires_total", counters.get("acquires"),
            {"digest": digest[:12]},
            help_="Pool checkouts, by plan digest.", type_="counter",
        )

    # cache effectiveness
    for cache_key, metric in (
        ("resolve_cache", "ozl_resolve_cache"),
        ("coder_cache", "ozl_coder_cache"),
    ):
        info = stats.get(cache_key) or {}
        for event in ("hits", "misses"):
            w.sample(
                f"{metric}_total", info.get(event), {"event": event},
                help_=f"{cache_key} traffic.", type_="counter",
            )

    # degradation state
    for backend, health in sorted((stats.get("backend_health") or {}).items()):
        w.sample(
            "ozl_backend_quarantined",
            health.get("quarantined"),
            {"backend": backend},
            help_="1 while the backend is benched after repeated faults.",
        )
        w.sample(
            "ozl_backend_failovers_total", health.get("failovers"),
            {"backend": backend},
            help_="Requests re-executed on the host backend.", type_="counter",
        )
    quarantine = stats.get("quarantine") or {}
    w.sample(
        "ozl_quarantined_plans",
        sum(1 for q in quarantine.values() if q.get("quarantined")),
        help_="Plan digests with an open circuit breaker.",
    )
    for digest, q in sorted(quarantine.items()):
        w.sample(
            "ozl_plan_quarantine_trips_total", q.get("trips"),
            {"digest": digest[:12]},
            help_="Circuit-breaker trips, by plan digest.", type_="counter",
        )

    rl = stats.get("rate_limiter") or {}
    w.sample(
        "ozl_rate_limiter_clients", rl.get("clients"),
        help_="Client buckets currently tracked.",
    )

    # multi-process plane: per-worker liveness and counters
    if stats.get("workers") is not None:
        w.sample(
            "ozl_workers", stats.get("workers"),
            help_="Configured session-worker processes.",
        )
        w.sample(
            "ozl_workers_alive", stats.get("workers_alive"),
            help_="Session-worker processes currently alive.",
        )
        w.sample(
            "ozl_worker_restarts_total", stats.get("worker_restarts"),
            help_="Workers replaced after dying.", type_="counter",
        )
    for ident, snap in sorted((stats.get("per_worker") or {}).items()):
        labels = {"worker": str(ident)}
        for verb, count in sorted((snap.get("requests") or {}).items()):
            w.sample(
                "ozl_worker_requests_total", count, {**labels, "verb": verb},
                help_="Requests handled per worker process.", type_="counter",
            )
        in_use = sum(
            c.get("in_use", 0) for c in (snap.get("sessions") or {}).values()
        )
        w.sample(
            "ozl_worker_sessions_in_use", in_use, labels,
            help_="Checked-out sessions per worker process.",
        )
        coder = snap.get("coder_cache") or {}
        w.sample(
            "ozl_worker_coder_cache_hits_total", coder.get("hits"), labels,
            help_="Coder-table cache hits per worker process.",
            type_="counter",
        )
    return w.render()
