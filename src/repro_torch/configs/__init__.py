"""Architecture configs: one module per LM arch (``--arch <id>``).

  LM:     olmoe-1b-7b  kimi-k2-1t-a32b  yi-9b  h2o-danube-3-4b  llama3.2-1b

The port's registry holds the LM archs only; the GNN and RecSys archs come
with their models.
"""
from .base import ArchSpec, ShapeSpec, all_archs, get_arch, register_arch  # noqa: F401
