"""Optimizers over parameter trees: AdamW, Adafactor, SGD; the port of
``repro.distributed.optimizer``.

Optimizer state mirrors the parameter tree (AdamW's ``{"count", "m", "v"}``,
Adafactor's ``{"count", "per_param"}``), so it checkpoints beside the params
under the reference's keys and restores into either package.  ``update``
runs under ``torch.no_grad()`` and returns new trees; it never writes the
tensors it is given.  Adafactor's factored second moment (row/col
statistics) is what makes the 1T-param kimi config trainable: m in bf16,
v factored — ~2.25 bytes/param of optimizer state instead of 8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]  # params -> state
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params) -> (params, state)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` over the tensors of ``tree`` (nested dicts); each
    tree of ``rest`` is followed down the same keys and may hold anything at
    a leaf's place (Adafactor's per-leaf state dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _count(params) -> torch.Tensor:
    leaf = params
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _split(tree: Any, n: int):
    """A tree of n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = [_split(v, n) for v in tree.values()]
        return tuple({k: p[i] for k, p in zip(tree, parts)} for i in range(n))
    return tree


# ------------------------------------------------------------------- AdamW
def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    """Decoupled weight decay after the bias-corrected Adam step, all in
    float32; ``m`` is kept in bfloat16 only where the param is bfloat16,
    ``v`` always in float32."""

    def init(params):
        return {
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": _count(params),
        }

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        c = count.float()
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)

        def upd(p, g, m, v):
            g32 = g.float()
            m = b1 * m.float() + (1 - b1) * g32
            v = b2 * v.float() + (1 - b2) * torch.square(g32)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p32 = p.float()
            newp = p32 - lr * (step + weight_decay * p32)
            m_dtype = p.dtype if p.dtype == torch.bfloat16 else torch.float32
            return newp.to(p.dtype), m.to(m_dtype), v.float()

        out = tree_map(upd, params, grads, state["m"], state["v"])
        new_p, new_m, new_v = _split(out, 3)
        return new_p, {"m": new_m, "v": new_v, "count": count}

    return Optimizer("adamw", init, update)


# --------------------------------------------------------------- Adafactor
def adafactor(
    lr: float = 1e-3,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    momentum_dtype: torch.dtype = torch.bfloat16,
) -> Optimizer:
    """Shazeer & Stern (2018): factored second moments for >=2-D params."""

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def leaf_state(p):
            shape = tuple(p.shape)
            kw = {"device": p.device}
            if _factored(shape):
                return {
                    "vr": torch.zeros(shape[:-1], dtype=torch.float32, **kw),  # row stats
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32, **kw),
                    "m": torch.zeros(shape, dtype=momentum_dtype, **kw),
                }
            return {
                "v": torch.zeros(shape, dtype=torch.float32, **kw),
                "m": torch.zeros(shape, dtype=momentum_dtype, **kw),
            }

        return {"per_param": tree_map(leaf_state, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        c = count.float()
        beta = 1.0 - torch.pow(c, -decay)  # increasing decay schedule

        def upd(p, g, s):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :] / torch.clamp(
                        torch.mean(vr, dim=-1, keepdim=True)[..., None], min=eps
                    )
                )
                step = g32 / torch.clamp(denom, min=eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                step = g32 / (torch.sqrt(v) + eps)
                new_s = {"v": v}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(step)) + eps)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            m = 0.9 * s["m"].float() + 0.1 * step
            new_s["m"] = m.to(momentum_dtype)
            newp = (p.float() - lr * m).to(p.dtype)
            return newp, new_s

        new_p, new_s = _split(tree_map(upd, params, grads, state["per_param"]), 2)
        return new_p, {"per_param": new_s, "count": count}

    return Optimizer("adafactor", init, update)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        new_p = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
        return new_p, {"count": state["count"] + 1}

    return Optimizer("sgd", init, update)


def for_arch(family: str, arch_id: str) -> Optimizer:
    """Default optimizer per arch: Adafactor for the 1T MoE, AdamW otherwise."""
    if arch_id.startswith("kimi"):
        return adafactor()
    return adamw()
