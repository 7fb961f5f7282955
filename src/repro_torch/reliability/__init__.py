"""repro_torch.reliability -- deterministic fault injection, the crash
sweeps it drives and the service's plan quarantine, the port's copy of
``repro.reliability``.

    Fault plane ......... repro_torch.reliability.faults    (FaultPlan, fault_point)
    Degradation ......... repro_torch.reliability.failover  (Quarantine)
    Crash-kill sweeps ... repro_torch.reliability.crashkill (subprocess SIGKILL harness)

Everything here is disarmed by default: with no :class:`FaultPlan` armed the
hooks cost one contextvar read and behaviour is untouched.  The reference's
``BackendHealth`` (host failover after a device fault) has no counterpart:
the port never retries a card's fault on the host.
"""
from .faults import (  # noqa: F401
    FaultPlan,
    FaultRule,
    FaultyIO,
    InjectedDeviceFault,
    InjectedFault,
    crash_point,
    current_plan,
    fault_point,
    wrap_io,
)
from .failover import Quarantine  # noqa: F401
