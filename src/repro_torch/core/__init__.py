"""Core of the port: messages, wire format, codec/selector registries, plans
and the two-phase engine."""
from .engine import CompressionCtx, compress, decompress, execute, resolve  # noqa: F401
from .graph import GraphBuilder, Plan, pipeline, plan_from_dict  # noqa: F401
from .message import Stream, SType, numeric, serial, strings, struct  # noqa: F401
