"""Shared layers: initializers, RMSNorm, RoPE, MLPs; the port of
``repro.models.layers``.

Parameters are plain trees (nested dicts of tensors) and models are
function pairs over them, as in the reference, so a tree crosses between
the two packages leaf for leaf (:mod:`repro_torch.models.convert`).
Initializers draw from an explicit ``torch.Generator`` on its own device:
the same distributions as the reference's, not the same values.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def dense_init(
    generator: torch.Generator,
    d_in: int,
    d_out: int,
    dtype: torch.dtype = torch.float32,
    scale: float = 1.0,
) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    return (_normal(generator, (d_in, d_out)) * std).to(dtype)


def embed_init(
    generator: torch.Generator, vocab: int, d: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    return (_normal(generator, (vocab, d)) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalised in float32, cast back to ``x``'s dtype, then scaled."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def mlp_init(
    generator: torch.Generator, sizes: Sequence[int], dtype: torch.dtype = torch.float32
) -> Params:
    p: Params = {
        f"w{i}": dense_init(generator, sizes[i], sizes[i + 1], dtype)
        for i in range(len(sizes) - 1)
    }
    for i in range(len(sizes) - 1):
        p[f"b{i}"] = torch.zeros((sizes[i + 1],), dtype=dtype, device=generator.device)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act=F.relu, final_act=None) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


# ------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, d_head: int, theta: float = 10000.0):
    """positions: (...,) int -> cos/sin of shape (..., d_head//2)."""
    exponents = torch.arange(0, d_head, 2, dtype=torch.float32, device=positions.device) / d_head
    inv_freq = 1.0 / (theta**exponents)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., d_head), rotated in split halves (not interleaved); cos/sin
    broadcastable to (..., d_head//2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------- utilities
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """logits (..., V), labels (...) int -> mean NLL (float32)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, keys sorted at each level (JAX's order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [leaf for v in tree for leaf in tree_leaves(v)]


def count_params(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)))
