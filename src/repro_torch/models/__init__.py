"""The LM-family transformer in PyTorch (dense + MoE, GQA, sliding-window
attention, KV-cache decode), the port of ``repro.models``' transformer; the
GNN and RecSys models come in a later slice."""
from . import convert, layers, transformer  # noqa: F401
