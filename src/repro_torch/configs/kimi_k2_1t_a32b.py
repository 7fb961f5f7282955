"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table]: 61L d7168
64H (GQA kv=8) d_ff=2048/expert, MoE 384 experts top-8, vocab 163840.
Trillion-param MoE: 32B active.  Full attention -> long_500k skipped."""
from ..models.transformer import TransformerConfig

from .base import ArchSpec, register_arch
from .lm_common import lm_shapes, reduced_lm

CFG = TransformerConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    top_k=8,
)

SPEC = register_arch(
    ArchSpec(
        arch_id="kimi-k2-1t-a32b",
        family="lm",
        source="arXiv:2501.kimi2; unverified",
        model_cfg=CFG,
        shapes=lm_shapes(sub_quadratic=False),
        reduced_cfg=reduced_lm(CFG),
        notes="~1T total params; Adafactor + bf16 recommended (see DESIGN.md)",
    )
)
