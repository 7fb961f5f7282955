"""H2O-Danube-3-4B [arXiv:2401.16818; unverified]: llama+mistral mix with
sliding-window attention — 24L d3840 32H (kv=8) d_ff=10240 vocab 32000.
SWA (window 4096) makes decode sub-quadratic: long_500k RUNS for this arch
(ring-buffer KV cache of window size, not seq_len)."""
from ..models.transformer import TransformerConfig

from .base import ArchSpec, register_arch
from .lm_common import lm_shapes, reduced_lm

CFG = TransformerConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    sliding_window=4096,
)

SPEC = register_arch(
    ArchSpec(
        arch_id="h2o-danube-3-4b",
        family="lm",
        source="arXiv:2401.16818; unverified",
        model_cfg=CFG,
        shapes=lm_shapes(sub_quadratic=True),
        reduced_cfg=reduced_lm(CFG),
        notes="SWA window 4096; long_500k decode cache is 4096 slots (ring)",
    )
)
