"""Greedy stream clustering (paper §VI-C, first training stage).

The port's copy of ``repro.training.cluster``.  Initially every parsed
stream is its own cluster; the trainer greedily merges the pair whose
combined compressed size is smaller than the sum of the individual sizes,
repeating until a local minimum.  Only same-signature streams may merge
(concat requires it), which also bounds the pair set.

Streams stay on their device: a merge is one ``torch.cat`` there, and each
size probe is a ``compress`` on that device, under ``core.codec.trial``
(a codec refuses there what the reference's raises on).  A probe that a
codec refuses (a ``ValueError``) is sized as the raw bytes plus 64, as the
reference does; any other error, a card fault or a ``KernelError`` among
them, propagates instead of being read as a size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.codec import trial
from ..core.engine import CompressionCtx, compress
from ..core.graph import GraphBuilder, Plan
from ..core.message import Stream, SType


def _concat_streams(streams: Sequence[Stream]) -> Stream:
    """One stream of the same signature: the payloads joined on their
    device (a NUMERIC width has one carrier dtype, so nothing promotes);
    STRING lengths stay host ``uint32``."""
    s0 = streams[0]
    if len(streams) == 1:
        return s0
    data = torch.cat([s.data for s in streams])
    if s0.stype == SType.STRING:
        lengths = np.concatenate([s.lengths for s in streams]).astype(np.uint32)
        return Stream(data, SType.STRING, 1, lengths)
    return Stream(data, s0.stype, s0.width)


def _probe_plan(sig: Tuple[int, int]) -> Plan:
    """Cheap, codec-agnostic size probe used for cluster decisions: the
    generic auto selector at a fast level."""
    g = GraphBuilder(1)
    g.select("generic_auto", g.input(0))
    return g.build("probe")


def _size_of(streams: Sequence[Stream], level: int) -> int:
    s = _concat_streams(streams)
    sig = (int(s.stype), s.width)
    try:
        # bypass the resolve cache: probes compare selector choices across
        # many same-shape streams, so each must expand on its own data
        with trial():
            return len(
                compress(
                    _probe_plan(sig),
                    [s],
                    ctx=CompressionCtx(level=level),
                    device=s.device,
                    use_resolve_cache=False,
                )
            )
    except ValueError:  # a codec's refusal; a card fault propagates
        return s.nbytes + 64


@dataclass
class Clustering:
    clusters: List[List[int]]  # stream indices per cluster
    sizes: List[int]  # probe compressed size per cluster

    def assignment(self) -> Dict[int, int]:
        return {i: c for c, idxs in enumerate(self.clusters) for i in idxs}


def cluster_streams(
    streams: Sequence[Stream],
    *,
    level: int = 5,
    max_rounds: int = 64,
    pool_map: Optional[Callable[[Callable, Sequence], List]] = None,
) -> Clustering:
    """Greedy same-signature merging; ``pool_map`` (an ordered parallel map,
    e.g. ``TrainerService.map``) fans the per-round candidate-pair probes
    out.  Probe sizes are a pure function of the streams, and the winning
    pair is picked from the ordered result list, so the clustering is
    identical with or without a pool.  The probes run on the streams'
    device."""
    pool_map = pool_map or (lambda fn, items: [fn(x) for x in items])
    sigs = [(int(s.stype), s.width) for s in streams]
    clusters: List[List[int]] = [[i] for i in range(len(streams))]
    sizes: List[int] = pool_map(
        lambda i: _size_of([streams[i]], level), range(len(streams))
    )

    for _ in range(max_rounds):
        pairs = [
            (a, b)
            for a in range(len(clusters))
            for b in range(a + 1, len(clusters))
            if sigs[clusters[a][0]] == sigs[clusters[b][0]]
        ]
        msizes = pool_map(
            lambda ab: _size_of(
                [streams[i] for i in clusters[ab[0]] + clusters[ab[1]]], level
            ),
            pairs,
        )
        best = None  # (gain, a, b, merged_size)
        for (a, b), msize in zip(pairs, msizes):
            gain = sizes[a] + sizes[b] - msize
            if gain > 0 and (best is None or gain > best[0]):
                best = (gain, a, b, msize)
        if best is None:
            break  # local minimum (paper: "repeats until local minimum")
        _, a, b, msize = best
        clusters[a] = clusters[a] + clusters[b]
        sizes[a] = msize
        del clusters[b], sizes[b]
    return Clustering(clusters, sizes)
