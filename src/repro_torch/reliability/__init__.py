"""repro_torch.reliability -- deterministic fault injection and the crash
sweeps it drives, the port's copy of ``repro.reliability``.

    Fault plane ......... repro_torch.reliability.faults    (FaultPlan, fault_point)
    Crash-kill sweeps ... repro_torch.reliability.crashkill (subprocess SIGKILL harness)

Everything here is disarmed by default: with no :class:`FaultPlan` armed the
hooks cost one contextvar read and behaviour is untouched.  The reference's
``failover`` module (backend health and quarantine for the service plane's
host failover) has no counterpart: the port never retries a card's fault on
the host.
"""
from .faults import (  # noqa: F401
    FaultPlan,
    FaultRule,
    FaultyIO,
    InjectedFault,
    crash_point,
    current_plan,
    fault_point,
    wrap_io,
)
