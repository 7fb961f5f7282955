"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B; unverified]: 16L d2048 32H
(kv=8) d_ff=8192 vocab 128256, tied embeddings, rope theta 500k.
Full attention -> long_500k skipped."""
from ..models.transformer import TransformerConfig

from .base import ArchSpec, register_arch
from .lm_common import lm_shapes, reduced_lm

CFG = TransformerConfig(
    name="llama3.2-1b",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
)

SPEC = register_arch(
    ArchSpec(
        arch_id="llama3.2-1b",
        family="lm",
        source="hf:meta-llama/Llama-3.2-1B; unverified",
        model_cfg=CFG,
        shapes=lm_shapes(sub_quadratic=False),
        reduced_cfg=reduced_lm(CFG),
    )
)
