"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d2048 16H (GQA kv=16) d_ff=1024,
MoE 64 experts top-8, vocab 50304.  Full attention -> long_500k skipped."""
from ..models.transformer import TransformerConfig

from .base import ArchSpec, register_arch
from .lm_common import lm_shapes, reduced_lm

CFG = TransformerConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
)

SPEC = register_arch(
    ArchSpec(
        arch_id="olmoe-1b-7b",
        family="lm",
        source="arXiv:2409.02060; hf",
        model_cfg=CFG,
        shapes=lm_shapes(sub_quadratic=False),
        reduced_cfg=reduced_lm(CFG),
        notes="64-expert top-8 MoE; 1B active / 7B total params",
    )
)
