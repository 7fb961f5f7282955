"""NSGA-II (Deb et al. 2002) — the multi-objective engine behind the paper's
backend graph generator (§VI-C): fast nondominated sort, crowding distance,
binary tournament, elitist environmental selection.  The port's copy of
``repro.training.nsga2``, pure Python, value for value the reference's.

Evaluation is *batched*: each generation hands the full child population to
one ``evaluate_batch`` callable, which is free to fan the candidates out
across a worker pool.  Variation is driven by per-child RNG streams derived
from ``(seed, generation, child_index)`` — never from a shared sequential RNG
interleaved with evaluation — so the evolved population is a pure function of
the seed, independent of worker count or evaluation completion order.
"""
from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Callable, Generic, List, Sequence, Tuple, TypeVar

T = TypeVar("T")

Objectives = Tuple[float, ...]  # minimized


def rng_stream(seed: int, *key) -> random.Random:
    """A deterministic, independent RNG stream for ``(seed, *key)``.

    Stable across processes and Python versions (keyed blake2b, not
    ``hash()``), so identically seeded runs replay identical genomes no
    matter how evaluation is scheduled.
    """
    digest = hashlib.blake2b(
        repr((int(seed),) + tuple(key)).encode(), digest_size=8
    ).digest()
    return random.Random(int.from_bytes(digest, "big"))


def dominates(a: Objectives, b: Objectives) -> bool:
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


def nondominated_sort(objs: Sequence[Objectives]) -> List[List[int]]:
    n = len(objs)
    S = [[] for _ in range(n)]
    dom_count = [0] * n
    fronts: List[List[int]] = [[]]
    for p in range(n):
        for q in range(n):
            if p == q:
                continue
            if dominates(objs[p], objs[q]):
                S[p].append(q)
            elif dominates(objs[q], objs[p]):
                dom_count[p] += 1
        if dom_count[p] == 0:
            fronts[0].append(p)
    i = 0
    while fronts[i]:
        nxt: List[int] = []
        for p in fronts[i]:
            for q in S[p]:
                dom_count[q] -= 1
                if dom_count[q] == 0:
                    nxt.append(q)
        i += 1
        fronts.append(nxt)
    return fronts[:-1]


def crowding_distance(objs: Sequence[Objectives], front: Sequence[int]) -> dict:
    dist = {i: 0.0 for i in front}
    if len(front) <= 2:
        return {i: math.inf for i in front}
    m = len(objs[0])
    for k in range(m):
        srt = sorted(front, key=lambda i: objs[i][k])
        lo, hi = objs[srt[0]][k], objs[srt[-1]][k]
        dist[srt[0]] = dist[srt[-1]] = math.inf
        if hi == lo:
            continue
        for j in range(1, len(srt) - 1):
            dist[srt[j]] += (objs[srt[j + 1]][k] - objs[srt[j - 1]][k]) / (hi - lo)
    return dist


def pareto_prune(
    items: List[T], objs: List[Objectives], keep: int
) -> Tuple[List[T], List[Objectives]]:
    """The paper's merge step: keep `keep` items, preferring better fronts and
    within a front the highest crowding distance (§VI-C last paragraph)."""
    fronts = nondominated_sort(objs)
    out_idx: List[int] = []
    for front in fronts:
        if len(out_idx) + len(front) <= keep:
            out_idx.extend(front)
        else:
            dist = crowding_distance(objs, front)
            ranked = sorted(front, key=lambda i: -dist[i])
            out_idx.extend(ranked[: keep - len(out_idx)])
            break
    return [items[i] for i in out_idx], [objs[i] for i in out_idx]


@dataclass
class NSGA2Result(Generic[T]):
    pareto: List[T]
    pareto_objs: List[Objectives]
    evaluations: int


def nsga2(
    seed_pop: List[T],
    evaluate_batch: Callable[[List[T]], List[Objectives]],
    mutate: Callable[[T, random.Random], T],
    crossover: Callable[[T, T, random.Random], T],
    *,
    pop_size: int = 20,
    generations: int = 10,
    seed: int = 0,
) -> NSGA2Result:
    """Evolve ``seed_pop`` under batched evaluation.

    ``evaluate_batch(pop) -> [objectives]`` must be a pure function of each
    candidate (it may run candidates concurrently and in any order).  Given
    that, the returned Pareto set is byte-identical for any scheduling of the
    batch — the determinism contract ``python -m repro_torch train`` relies on.
    """
    pop: List[T] = list(seed_pop)[:pop_size]
    for i in range(len(pop), pop_size):
        r = rng_stream(seed, "fill", i)
        pop.append(mutate(r.choice(seed_pop), r))
    objs = list(evaluate_batch(pop))
    evals = len(pop)

    def tournament(r: random.Random) -> T:
        i, j = r.randrange(len(pop)), r.randrange(len(pop))
        return pop[i] if dominates(objs[i], objs[j]) or r.random() < 0.5 else pop[j]

    for gen in range(generations):
        children: List[T] = []
        for i in range(pop_size):
            r = rng_stream(seed, "child", gen, i)
            a, b = tournament(r), tournament(r)
            c = crossover(a, b, r) if r.random() < 0.7 else a
            if r.random() < 0.6:
                c = mutate(c, r)
            children.append(c)
        child_objs = list(evaluate_batch(children))
        evals += len(children)
        merged = pop + children
        merged_objs = objs + child_objs
        pop, objs = pareto_prune(merged, merged_objs, pop_size)

    fronts = nondominated_sort(objs)
    first = fronts[0] if fronts else []
    return NSGA2Result([pop[i] for i in first], [objs[i] for i in first], evals)
