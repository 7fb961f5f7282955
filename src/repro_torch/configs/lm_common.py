"""Shared shape set for the LM-family transformers.

Shapes (assignment): train_4k (train), prefill_32k (inference-prefill),
decode_32k (one-token step with 32k KV cache), long_500k (524288-token
decode — sub-quadratic attention only; full-attention archs carry an
explicit skip reason).
"""
from __future__ import annotations

import dataclasses

from ..models.transformer import TransformerConfig
from .base import ShapeSpec

FULL_ATTN_SKIP = (
    "long_500k requires sub-quadratic attention; this arch is pure full "
    "attention (a 512k-KV full-attention decode is quadratic-cost) — skipped "
    "per assignment, see DESIGN.md §5"
)


def lm_shapes(sub_quadratic: bool) -> tuple:
    return (
        ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
        ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
        ShapeSpec(
            "long_500k",
            "decode",
            {"seq_len": 524288, "global_batch": 1},
            skip=None if sub_quadratic else FULL_ATTN_SKIP,
        ),
    )


def reduced_lm(cfg: TransformerConfig) -> TransformerConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128,
        vocab=256,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.n_experts else cfg.top_k,
        sliding_window=16 if cfg.sliding_window else None,
        remat=False,
    )
