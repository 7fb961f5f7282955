"""Deterministic fault injection: seeded schedules of provoked failures.

The port's copy of ``repro.reliability.faults`` (standard library only).
Every durability seam of the port (the atomic sink and its source, the
checkpoint publish, the shard store's rename-aside rewrite) is a *named
fault point*, and a reproducible schedule of failures can be armed against
them:

    plan = FaultPlan().at("io.sink.write", nth=3)        # 3rd sink write fails
    with plan.arm(all_threads=True):
        compress_file(src, dst, plan_)                   # raises InjectedFault

The point names, actions, occurrence counting and the JSON form of a plan
are the reference's, so a plan serialized by either package arms the other's
victim process the same way.  The two packages keep separate planes: a plan
armed in one is not seen by the other's points.

Principles:

* **Disarmed by default, zero overhead.**  ``fault_point(name)`` is a single
  contextvar read (plus one module-global read) when no plan is armed; the
  file proxies in :func:`wrap_io` return the original object untouched.
* **Deterministic.**  Explicit rules fire on the *nth occurrence* of a named
  point (per-point counters), and seeded random rules draw from one
  ``random.Random(seed)`` in hit order -- for a deterministic workload the
  same seed yields the same fault sequence.  (Points hit concurrently from
  worker threads are counted under a lock; their relative order is the
  workload's own scheduling.)
* **Faults look real.**  Injected errors are :class:`InjectedFault`
  (an ``IOError``) for I/O points, ``ConnectionResetError`` for ``drop``
  rules, and a genuine ``SIGKILL`` for crash points -- recovery code cannot
  tell them from the failures they model.  The card's points
  (``device.encode.*``) raise :class:`InjectedDeviceFault`, an
  ``InjectedFault`` that says where it arose: a card fault is the plan's,
  not the transport's.

Actions
-------
``raise``  raise :class:`InjectedFault` (or the rule's ``exc`` factory)
``drop``   raise ``ConnectionResetError`` -- a torn connection
``short``  at a :func:`wrap_io` write: write a partial prefix, then raise
           (a torn write); at a bare fault point, same as ``raise``
``kill``   ``SIGKILL`` the current process -- for crash-recovery sweeps

Crash points are ordinary fault points hit at the named irreversible steps
(``shard.*``, ``ckpt.*``, ``sink.*``); :func:`crash_point` is an alias kept
for greppability.  A plan built with ``record=True`` fires nothing and
instead records every ``(point, occurrence)`` it sees -- the crash-kill
harness (:mod:`repro_torch.reliability.crashkill`) uses one recording run to
enumerate the kill sites it then SIGKILLs a victim subprocess at, one by one.
"""
from __future__ import annotations

import fnmatch
import json
import os
import signal
import threading
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from random import Random
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "InjectedFault",
    "InjectedDeviceFault",
    "FaultRule",
    "FaultPlan",
    "fault_point",
    "crash_point",
    "current_plan",
    "wrap_io",
    "FaultyIO",
]


class InjectedFault(IOError):
    """An error injected by an armed :class:`FaultPlan` (an I/O error to
    callers — recovery paths must treat it exactly like the real thing)."""


class InjectedDeviceFault(InjectedFault):
    """An :class:`InjectedFault` at a card's point (``device.encode.*``):
    the failure a kernel launch would raise, told apart from a file's or a
    socket's by its type."""


ACTIONS = ("raise", "drop", "short", "kill")


@dataclass
class FaultRule:
    """Fire ``action`` on the ``nth .. nth+times-1``-th occurrence of every
    point matching ``pattern`` (fnmatch; occurrences count per point name)."""

    pattern: str
    action: str = "raise"
    nth: int = 1
    times: int = 1
    exc: Optional[Callable[[str], BaseException]] = None

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.nth < 1 or self.times < 1:
            raise ValueError("nth and times are 1-based and positive")


class FaultPlan:
    """A seeded, deterministic schedule of injectable faults.

    Explicit rules (:meth:`at`) target exact occurrences; :meth:`every` adds
    a seeded random rule firing each matching hit with probability ``rate``.
    Arm with :meth:`arm` (a context manager); ``all_threads=True`` makes the
    plan visible to the engine's worker/draw threads (contextvars do not
    propagate into already-running pool threads).
    """

    def __init__(self, *, seed: Optional[int] = None, record: bool = False):
        self._rules: List[FaultRule] = []
        self._random_rules: List[Tuple[str, float, str]] = []
        self._rng = Random(seed)
        self.record = record
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self.fired: List[Tuple[str, int, str]] = []
        self.sites: List[Tuple[str, int]] = []

    # ------------------------------------------------------------- authoring
    def at(
        self,
        pattern: str,
        *,
        nth: int = 1,
        times: int = 1,
        action: str = "raise",
        exc: Optional[Callable[[str], BaseException]] = None,
    ) -> "FaultPlan":
        self._rules.append(FaultRule(pattern, action, nth, times, exc))
        return self

    def every(self, pattern: str, rate: float, *, action: str = "raise") -> "FaultPlan":
        """Seeded random rule: each matching hit fires with probability
        ``rate`` (drawn from this plan's RNG in hit order)."""
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        if not (0.0 <= rate <= 1.0):
            raise ValueError("rate must be in [0, 1]")
        self._random_rules.append((pattern, rate, action))
        return self

    # -------------------------------------------------------------- arming
    @contextmanager
    def arm(self, *, all_threads: bool = False):
        """Arm this plan for the duration of the ``with`` block.

        Default visibility is the current context (contextvar); pass
        ``all_threads=True`` when the workload spans the engine's thread
        pools or any code path outside the arming context.
        """
        global _GLOBAL
        token = None
        if all_threads:
            with _GLOBAL_LOCK:
                if _GLOBAL is not None:
                    raise RuntimeError("another FaultPlan is already armed globally")
                _GLOBAL = self
        else:
            token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            if all_threads:
                with _GLOBAL_LOCK:
                    _GLOBAL = None
            else:
                _ACTIVE.reset(token)

    # ------------------------------------------------------------- matching
    def _hit(self, name: str) -> Optional[FaultRule]:
        with self._lock:
            k = self._counts.get(name, 0) + 1
            self._counts[name] = k
            if self.record:
                self.sites.append((name, k))
                return None
            for rule in self._rules:
                if (
                    rule.nth <= k < rule.nth + rule.times
                    and fnmatch.fnmatchcase(name, rule.pattern)
                ):
                    self.fired.append((name, k, rule.action))
                    return rule
            for pattern, rate, action in self._random_rules:
                if fnmatch.fnmatchcase(name, pattern):
                    if self._rng.random() < rate:
                        self.fired.append((name, k, action))
                        return FaultRule(pattern, action, k)
            return None

    # -------------------------------------------- subprocess victim support
    def to_json(self) -> str:
        """Serialize explicit rules (for arming a victim subprocess).  Random
        rules and custom ``exc`` factories are process-local and not carried."""
        return json.dumps(
            {
                "record": self.record,
                "rules": [
                    {
                        "pattern": r.pattern,
                        "action": r.action,
                        "nth": r.nth,
                        "times": r.times,
                    }
                    for r in self._rules
                ],
            }
        )

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        spec = json.loads(blob)
        plan = cls(record=bool(spec.get("record", False)))
        for r in spec.get("rules", []):
            plan.at(
                r["pattern"],
                nth=int(r.get("nth", 1)),
                times=int(r.get("times", 1)),
                action=r.get("action", "raise"),
            )
        return plan


_ACTIVE: ContextVar[Optional[FaultPlan]] = ContextVar("repro_torch_fault_plan", default=None)
_GLOBAL: Optional[FaultPlan] = None
_GLOBAL_LOCK = threading.Lock()


def _faults_after_fork() -> None:
    """Disarm any inherited global plan in a forked child.

    A plan armed in the parent must not silently fire inside a forked child
    (its occurrence counters would diverge from the parent's, breaking
    determinism); a child that should fault arms a plan of its own.
    Crash-kill victims are unaffected -- they are spawned, not forked.
    """
    global _GLOBAL, _GLOBAL_LOCK
    _GLOBAL = None
    _GLOBAL_LOCK = threading.Lock()


if hasattr(os, "register_at_fork"):  # pragma: no branch - POSIX in CI
    os.register_at_fork(after_in_child=_faults_after_fork)


def current_plan() -> Optional[FaultPlan]:
    plan = _ACTIVE.get()
    if plan is not None:
        return plan
    return _GLOBAL  # unlocked read: arming is rare, None is the fast path


def _perform(rule: FaultRule, name: str, fault=InjectedFault) -> None:
    if rule.action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if rule.exc is not None:
        raise rule.exc(name)
    if rule.action == "drop":
        raise ConnectionResetError(f"injected connection drop at {name!r}")
    raise fault(f"injected fault at {name!r}")


def fault_point(name: str, fault=InjectedFault) -> None:
    """Hook: a named place where an armed plan may inject a failure
    (``fault``, unless the rule says otherwise).

    No-op (one contextvar read) when nothing is armed.
    """
    plan = current_plan()
    if plan is None:
        return
    rule = plan._hit(name)
    if rule is not None:
        _perform(rule, name, fault)


#: Crash points are fault points at irreversible steps (rename/replace/write
#: boundaries); the alias marks them for the crash-kill harness.
crash_point = fault_point


class FaultyIO:
    """A thin file proxy whose ``read``/``write`` hit ``<prefix>.read`` /
    ``<prefix>.write`` fault points.  A ``short`` rule on a write lands a
    partial prefix before raising — a torn write, as a crash or full disk
    would leave it."""

    def __init__(self, f, prefix: str):
        self._f = f
        self._prefix = prefix

    def write(self, data):
        plan = current_plan()
        if plan is not None:
            rule = plan._hit(self._prefix + ".write")
            if rule is not None:
                if rule.action == "short" and len(data) > 1:
                    self._f.write(data[: max(1, len(data) // 2)])
                    raise InjectedFault(
                        f"injected short write at {self._prefix + '.write'!r}"
                    )
                _perform(rule, self._prefix + ".write")
        return self._f.write(data)

    def read(self, n: int = -1):
        plan = current_plan()
        if plan is not None:
            rule = plan._hit(self._prefix + ".read")
            if rule is not None:
                _perform(rule, self._prefix + ".read")
        return self._f.read(n)

    def __getattr__(self, attr):
        return getattr(self._f, attr)


def wrap_io(f, prefix: str):
    """Wrap ``f`` in a :class:`FaultyIO` only while a plan is armed; the
    original object passes through untouched otherwise (zero overhead)."""
    if current_plan() is None:
        return f
    return FaultyIO(f, prefix)
