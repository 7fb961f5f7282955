"""Core of the port: messages, wire format, codec/selector registries, plans
and the two-phase engine."""
from .engine import (  # noqa: F401
    CompressionCtx,
    Compressor,
    CompressorSession,
    DecompressorSession,
    ExecScratch,
    SessionPool,
    compress,
    decompress,
    execute,
    resolve,
    resolve_cache_clear,
    resolve_cache_info,
    set_resolve_check,
)
from .graph import GraphBuilder, Plan, pipeline, plan_from_dict  # noqa: F401
from .message import Stream, SType, numeric, serial, strings, struct  # noqa: F401
from .serialize import deserialize_plan, plan_digest, serialize_plan  # noqa: F401
