"""LM-family transformer: dense + MoE, GQA, optional sliding-window attention,
RoPE, stacked per-layer params, KV-cache decode step; the port of
``repro.models.transformer``.  Covers olmoe-1b-7b, kimi-k2-1t-a32b, yi-9b,
h2o-danube-3-4b and llama3.2-1b.

Parameters are the reference's tree: ``{"embed", "final_norm", "layers",
["lm_head"]}`` with every ``layers`` leaf stacked on a leading
``(n_layers,)`` axis, so a checkpoint written by either package restores
into the other's model.  The functions take that tree, as the reference's
do; :class:`Transformer` is an ``nn.Module`` whose parameters are the same
tree.  The reference's scan over layers is a loop over the layer index, its
``jax.checkpoint`` a non-reentrant ``torch.utils.checkpoint`` per layer.
Attention and every product are plain PyTorch ops, as the reference's are
``einsum`` outside any Pallas kernel; float32 products stay float32 (TF32
off, PyTorch's default for matmul).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import Params, apply_rope, cross_entropy_loss, rms_norm, rope_angles


@dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    # MoE (n_experts == 0 => dense)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_groups: int = 1  # dispatch groups
    # attention
    sliding_window: Optional[int] = None  # h2o-danube SWA
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: Any = torch.float32
    remat: bool = True

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


# ------------------------------------------------------------------- init
def init_params(
    cfg: TransformerConfig,
    *,
    generator: torch.Generator,
    device: Union[str, torch.device, None] = None,
) -> Params:
    """The parameter tree, drawn on ``generator``'s device (then moved to
    ``device`` if another is named) from the reference's distributions:
    normal(0, 0.02) embeddings, normal / sqrt(fan-in) matrices, unit norms."""
    D, H, KV, dh, Fd, L = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.n_layers
    )
    gdev = generator.device

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=gdev) * std).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=gdev)

    def dense(d_in, d_out):  # dense_init, stacked over the layers
        return normal((L, d_in, d_out), 1.0 / math.sqrt(d_in))

    layers: Params = {
        "attn_norm": ones(L, D),
        "mlp_norm": ones(L, D),
        "wq": dense(D, H * dh),
        "wk": dense(D, KV * dh),
        "wv": dense(D, KV * dh),
        "wo": dense(H * dh, D),
    }
    if cfg.is_moe:
        E = cfg.n_experts
        layers["router"] = dense(D, E)
        layers["w_gate"] = normal((L, E, D, Fd), 1.0 / math.sqrt(D))
        layers["w_up"] = normal((L, E, D, Fd), 1.0 / math.sqrt(D))
        layers["w_down"] = normal((L, E, Fd, D), 1.0 / math.sqrt(Fd))
    else:
        layers["w_gate"] = dense(D, Fd)
        layers["w_up"] = dense(D, Fd)
        layers["w_down"] = dense(Fd, D)
    params: Params = {
        "embed": normal((cfg.vocab, D), 0.02),
        "final_norm": ones(D),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, cfg.vocab), 1.0 / math.sqrt(D))
    if device is not None and torch.device(device) != gdev:
        params = {k: _to(v, device) for k, v in params.items()}
    return params


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -------------------------------------------------------------- attention
def _gqa_attention(
    q: torch.Tensor,  # (B, S, H, dh)
    k: torch.Tensor,  # (B, T, KV, dh)
    v: torch.Tensor,  # (B, T, KV, dh)
    *,
    sliding_window: Optional[int],
    q_positions: torch.Tensor,  # (S,) absolute positions of queries
    kv_positions: torch.Tensor,  # (T,)
) -> torch.Tensor:
    B, S, H, dh = q.shape
    KV = k.shape[2]
    # each KV head serves H // KV consecutive query heads (jnp.repeat)
    k = torch.repeat_interleave(k, H // KV, dim=2)  # (B, T, H, dh)
    v = torch.repeat_interleave(v, H // KV, dim=2)
    scores = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(dh)
    # mask: causal + optional sliding window on absolute positions
    rel = q_positions[:, None] - kv_positions[None, :]  # (S, T)
    mask = rel >= 0
    if sliding_window is not None:
        mask &= rel < sliding_window
    scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.matmul(probs, v.transpose(1, 2))  # (B, H, S, dh)
    return out.transpose(1, 2).reshape(B, S, H * dh)


# ------------------------------------------------------------------- MoE
def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (a stable descending sort)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _moe_ffn(p: Params, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Top-k routed experts, grouped scatter dispatch (GShard capacity model).

    Each of ``moe_groups`` dispatch groups has expert capacity C; a pick's
    place in its expert's queue is a cumsum over the group's flattened
    (token, k) picks, picks past C go to the overflow slot E*C.  Dispatch is
    a scatter-add into (G, E*C+1, D) buffers, combine a gather from the
    expert outputs padded with that slot's zeros.
    """
    B, S, D = x.shape
    E, K, G = cfg.n_experts, cfg.top_k, cfg.moe_groups
    N = B * S
    assert N % G == 0, f"tokens {N} not divisible by moe_groups {G}"
    Ng = N // G
    C = max(int(cfg.capacity_factor * Ng * K / E), 1)
    xt = x.reshape(G, Ng, D)
    logits = torch.matmul(xt, p["router"])  # (G, Ng, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, idx = _top_k(probs, K)  # (G, Ng, K)
    gate_vals = (gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)).to(x.dtype)
    # position of each (token, k) pick within its expert's queue (per group)
    flat_idx = idx.reshape(G, Ng * K)
    onehot = F.one_hot(flat_idx, E)
    pos = torch.cumsum(onehot, dim=1) - onehot  # (G, Ng*K, E)
    pos = torch.gather(pos, -1, flat_idx[..., None])[..., 0].reshape(G, Ng, K)
    keep = pos < C
    slot = torch.where(keep, idx * C + pos, E * C)  # overflow slot E*C
    # dispatch: scatter-add tokens into the (G, E*C+1, D) expert buffers
    rows = torch.arange(G, device=x.device)[:, None, None] * (E * C + 1) + slot
    vals = (xt[:, :, None, :] * keep[..., None].to(x.dtype)).expand(G, Ng, K, D)
    buf = torch.zeros(G * (E * C + 1), D, dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, rows.reshape(-1), vals.reshape(-1, D))
    expert_in = buf.view(G, E * C + 1, D)[:, : E * C].reshape(G, E, C, D)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"])) * torch.einsum(
        "gecd,edf->gecf", expert_in, p["w_up"]
    )
    expert_out = torch.einsum("gecf,efd->gecd", h, p["w_down"])  # (G, E, C, D)
    # combine: gather each pick's expert output, weight by gate
    flat_out = torch.cat(
        [expert_out.reshape(G, E * C, D), torch.zeros(G, 1, D, dtype=x.dtype, device=x.device)],
        dim=1,
    )
    picked = flat_out[torch.arange(G, device=x.device)[:, None, None], slot]  # (G, Ng, K, D)
    out = torch.sum(picked * gate_vals[..., None], dim=2)
    return out.reshape(B, S, D)


def _dense_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ------------------------------------------------------------------ layers
def _layer_fwd(
    p: Params,
    x: torch.Tensor,
    cfg: TransformerConfig,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One transformer block.  With a cache, the rotated keys and the values
    are written into it in place at ``cache_index`` before attention reads
    it (the reference's ``dynamic_update_slice``)."""
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, p["attn_norm"])
    q = (h @ p["wq"]).reshape(B, S, H, dh)
    k = (h @ p["wk"]).reshape(B, S, KV, dh)
    v = (h @ p["wv"]).reshape(B, S, KV, dh)
    cos_q, sin_q = rope_angles(q_positions, dh, cfg.rope_theta)
    cos_q, sin_q = cos_q[None, :, None, :], sin_q[None, :, None, :]
    q = apply_rope(q, cos_q, sin_q)
    k = apply_rope(k, cos_q, sin_q)
    if kv_cache is not None:
        ck, cv = kv_cache  # (B, T, KV, dh) ring or linear cache
        # dynamic_update_slice clamps the start so that the S entries fit
        start = torch.clamp(cache_index, 0, ck.shape[1] - S)
        index = start + torch.arange(S, device=x.device)
        k, v = ck.index_copy_(1, index, k), cv.index_copy_(1, index, v)
    attn = _gqa_attention(
        q, k, v, sliding_window=cfg.sliding_window,
        q_positions=q_positions, kv_positions=kv_positions,
    )
    x = x + attn @ p["wo"]
    h2 = rms_norm(x, p["mlp_norm"])
    ffn = _moe_ffn(p, h2, cfg) if cfg.is_moe else _dense_ffn(p, h2)
    return x + ffn


def _per_layer(layers: Params, n_layers: int) -> List[Params]:
    """The stacked layer leaves as one dict of views a layer (``unbind``,
    whose backward stacks the layers' gradients in one allocation)."""
    split = {k: torch.unbind(v, 0) for k, v in layers.items()}
    return [{k: split[k][i] for k in split} for i in range(n_layers)]


def _head(params: Params, cfg: TransformerConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ------------------------------------------------------------------ forward
def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), a loop over the stacked layers."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)

    def one_layer(p, h):
        return _layer_fwd(p, h, cfg, q_positions=positions, kv_positions=positions)

    for p in _per_layer(params["layers"], cfg.n_layers):
        if cfg.remat:
            x = checkpoint(one_layer, p, x, use_reentrant=False)
        else:
            x = one_layer(p, x)
    x = rms_norm(x, params["final_norm"])
    return x @ _head(params, cfg)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: TransformerConfig):
    logits = forward(params, batch["tokens"], cfg)
    return cross_entropy_loss(logits, batch["labels"])


# ---------------------------------------------------------------- KV cache
def init_kv_cache(
    cfg: TransformerConfig,
    batch: int,
    max_len: int,
    *,
    device: Union[str, torch.device, None] = None,
) -> Params:
    """Cache length: sliding-window archs only keep `window` entries — that is
    what makes h2o-danube's long_500k decode sub-quadratic AND sub-linear in
    memory."""
    T = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def decode_step(
    params: Params,
    cache: Params,
    tokens: torch.Tensor,  # (B, 1) the new token
    position: Union[int, torch.Tensor],  # absolute position of the new token
    cfg: TransformerConfig,
):
    """One incremental decode step -> (logits (B, V), the cache).  The
    cache's tensors are updated in place at slot ``position % T`` (a ring
    buffer for SWA; linear when T >= max_len) and returned."""
    T = cache["k"].shape[2]
    x = params["embed"][tokens.long()]  # (B, 1, D)
    position = torch.as_tensor(position, dtype=torch.int64, device=x.device)
    q_pos = position.reshape(1)
    slot = position % T
    # absolute positions held in each cache slot after this write
    slots = torch.arange(T, device=x.device)
    written = torch.where(position >= T, position - torch.remainder(slot - slots, T), slots)
    valid = written <= position
    # invalid (unwritten) slots get a FUTURE position so the causal mask
    # (rel >= 0) rejects them for full-attention archs too
    kv_positions = torch.where(valid, written, position + 1_000_000_000)
    for i, p in enumerate(_per_layer(params["layers"], cfg.n_layers)):
        x = _layer_fwd(
            p, x, cfg, q_positions=q_pos, kv_positions=kv_positions,
            kv_cache=(cache["k"][i], cache["v"][i]), cache_index=slot,
        )
    x = rms_norm(x, params["final_norm"])
    logits = (x @ _head(params, cfg))[:, 0]
    return logits, cache


# ------------------------------------------------------------------ module
class Transformer(nn.Module):
    """The transformer as an ``nn.Module`` whose parameters are the
    reference's tree: ``embed``, ``final_norm``, ``layers.<leaf>`` stacked on
    ``(n_layers, ...)``, and ``lm_head`` unless the embeddings are tied."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Optional[Params] = None,
        *,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device, None] = None,
    ):
        super().__init__()
        self.cfg = cfg
        if params is None:
            if generator is None:
                raise ValueError("Transformer needs params or a generator to draw them")
            params = init_params(cfg, generator=generator, device=device)
        self.embed = nn.Parameter(params["embed"])
        self.final_norm = nn.Parameter(params["final_norm"])
        self.layers = nn.ParameterDict({k: nn.Parameter(v) for k, v in params["layers"].items()})
        if "lm_head" in params:
            self.lm_head = nn.Parameter(params["lm_head"])

    def tree(self) -> Params:
        """The parameters as the reference's nested dict."""
        tree: Params = {
            "embed": self.embed,
            "final_norm": self.final_norm,
            "layers": dict(self.layers.items()),
        }
        if hasattr(self, "lm_head"):
            tree["lm_head"] = self.lm_head
        return tree

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.tree(), tokens, self.cfg)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return loss_fn(self.tree(), batch, self.cfg)

    def decode_step(self, cache: Params, tokens: torch.Tensor, position):
        return decode_step(self.tree(), cache, tokens, position, self.cfg)
