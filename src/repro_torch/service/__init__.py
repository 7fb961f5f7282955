"""repro_torch.service -- the long-lived compression daemon (paper §VIII) on
the card, the port's copy of ``repro.service``.

One universal decoder plus registered trained configurations, served: a
:class:`~repro_torch.service.server.RequestCore` keeps a checkout pool of
:class:`~repro_torch.core.engine.CompressorSession` objects per registered
plan and one shared :class:`~repro_torch.core.engine.DecompressorSession`,
all on one device (the card unless the caller names the CPU), so callers pay
plan resolution, coder-table construction and pool spin-up once per plan, not
once per call.  Frames produced through the service are byte-identical to the
offline CLI's (``python -m repro_torch compress``) and to the reference's for
the same plan and chunk settings, and the wire protocol is the reference's
byte for byte, so either package's client talks to either package's server.

Public API:
    Wire protocol ......... repro_torch.service.protocol  (framing, fail-closed)
    Plan registry ......... repro_torch.service.registry  (id + content digest)
    Verb engine ........... repro_torch.service.server    (RequestCore)
    Threaded daemon ....... repro_torch.service.server    (CompressionServer)
    Event-loop frontend ... repro_torch.service.frontend  (ServiceFrontend)
    Blocking client ....... repro_torch.service.client    (ServiceClient)
    Rate limiting ......... repro_torch.service.ratelimit (RateLimiter)
    Metrics rendering ..... repro_torch.service.metrics   (render_prometheus)

Two server embeddings share that core: the threaded
:class:`~repro_torch.service.server.CompressionServer` (a thread a
connection) and :class:`~repro_torch.service.frontend.ServiceFrontend`, one
``selectors`` event loop over every connection whose compute threads alone
run requests on the card.  The reference's pre-forked multi-process plane
(``ServicePlane``, one frontend a worker) is not ported yet: a forked child
cannot use a CUDA context made in its parent, so the port's workers will be
spawned.
"""
from .protocol import (  # noqa: F401
    PROTOCOL_VERSION,
    ProtocolError,
    parse_address,
)
from .registry import PlanRegistry, RegisteredPlan  # noqa: F401
from .server import CompressionServer, RequestCore  # noqa: F401
from .client import (  # noqa: F401
    ConnectionLost,
    ServiceClient,
    ServiceUnavailable,
)
from .frontend import ServiceFrontend  # noqa: F401
from .ratelimit import RateLimiter  # noqa: F401
from .metrics import render_prometheus  # noqa: F401
