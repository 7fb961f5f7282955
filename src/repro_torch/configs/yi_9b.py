"""Yi-9B [arXiv:2403.04652; hf]: llama-arch dense GQA — 48L d4096 32H
(kv=4) d_ff=11008 vocab 64000.  Full attention -> long_500k skipped."""
from ..models.transformer import TransformerConfig

from .base import ArchSpec, register_arch
from .lm_common import lm_shapes, reduced_lm

CFG = TransformerConfig(
    name="yi-9b",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
)

SPEC = register_arch(
    ArchSpec(
        arch_id="yi-9b",
        family="lm",
        source="arXiv:2403.04652; hf",
        model_cfg=CFG,
        shapes=lm_shapes(sub_quadratic=False),
        reduced_cfg=reduced_lm(CFG),
    )
)
