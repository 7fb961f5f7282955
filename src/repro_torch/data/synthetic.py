"""Synthetic dataset generators for the example drivers and benchmarks.

LM corpora are Zipf-distributed token streams with Markov bigram structure
(so entropy coding AND the LM both have signal); recsys batches follow
power-law item popularity; graphs are preferential-attachment-ish.  numpy only, a copy of
``repro.data.synthetic`` (the same seed gives the same arrays).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def zipf_tokens(n: int, vocab: int, seed: int = 0, alpha: float = 1.2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks**-alpha
    probs /= probs.sum()
    # light bigram structure: each token biases the next toward a shifted rank
    base = rng.choice(vocab, size=n, p=probs).astype(np.int32)
    shift = rng.integers(0, 7, size=n).astype(np.int32)
    out = (base + np.roll(base, 1) % 7 + shift) % vocab
    return out.astype(np.int32)


def lm_batches(
    tokens: np.ndarray, batch: int, seq: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = tokens.shape[0] - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        idx = starts[:, None] + np.arange(seq)[None, :]
        yield {"tokens": tokens[idx], "labels": tokens[idx + 1]}


def recsys_ctr_batches(
    batch: int, n_sparse: int, vocab: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        ids = (rng.pareto(1.2, size=(batch, n_sparse)) * vocab * 0.01).astype(np.int64)
        ids = np.clip(ids, 0, vocab - 1).astype(np.int32)
        w = rng.normal(size=n_sparse)
        logit = (ids * w[None, :]).sum(1) / vocab * 20 - 1.0
        labels = (rng.random(batch) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        yield {"sparse_ids": ids, "labels": labels}


def random_graph(
    n_nodes: int, n_edges: int, d_feat: int, d_out: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    # power-law-ish degree: preferential dst choice
    dst = (rng.pareto(1.0, n_edges) * n_nodes * 0.05).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, n_edges)
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    nodes = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    w = rng.normal(size=(d_feat, d_out)).astype(np.float32) / np.sqrt(d_feat)
    targets = nodes @ w
    return {
        "nodes": nodes,
        "edges": edges,
        "edge_feats": rng.normal(size=(n_edges, 4)).astype(np.float32),
        "targets": targets,
    }
