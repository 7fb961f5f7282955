"""End-to-end compressor training (paper §VI-C) — the ``zli-train`` analogue.

The port's copy of ``repro.training.trainer``.  Pipeline: frontend-parse
sample files into streams -> greedy clustering -> per-cluster NSGA-II
backend search (objectives: compressed bytes, encode cost) -> iterative
Pareto merge across clusters pruned by crowding distance -> a set of
deployable tradeoff-point compressors (serializable Plans, paper §V-D).

Candidate evaluation runs through :class:`TrainerService`: a persistent
worker pool fanning genome evaluations out over long-lived
:class:`~repro_torch.core.engine.CompressorSession` objects that share one
coder-table :class:`~repro_torch.core.engine.ExecScratch` and the engine's
resolve cache.  Training is *deterministic*: the NSGA-II speed objective is
the reference's per-codec host cost model over the executed step trace — a
pure function of (genome, sample) — never a wall-clock measurement, and
variation uses per-genome RNG streams
(:func:`~repro_torch.training.nsga2.rng_stream`).  The same seed therefore
yields byte-identical Pareto plans for any worker count, and the plans and
objectives are the reference's.

Where the card changes the code:

* the samples, the parsed streams and every candidate's encode and decode
  live on ``device`` (the card unless the caller names the CPU); the
  losslessness check compares the decoded stream with the sample there
  (``torch.equal``), with no host copy;
* only a codec's or the frame reader's refusal (a ``ValueError``:
  ``FrameError`` and ``PlanTypeError`` are ones) scores a genome
  ``INVALID``.  The reference scores any exception so; here a card fault, a
  ``KernelError``, ``NoCardError`` or an ``InjectedDeviceFault`` propagates
  out of :func:`train`, since it says nothing of the genome.  A candidate's
  compression runs under ``core.codec.trial``, where a codec refuses what
  the reference's raises on;
* the evaluation threads launch on the caller's CUDA stream, as the
  session pool's do.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _device
from ..core.codec import get_codec, trial
from ..core.engine import (
    CompressionCtx,
    CompressorSession,
    DecompressorSession,
    DeviceLike,
    ExecScratch,
    on_caller_stream,
)
from ..core.graph import GraphBuilder, Plan
from ..core.message import Stream, SType
from .cluster import Clustering, _concat_streams, cluster_streams
from .gp import GNode, compile_genome, crossover, emit_genome, mutate
from .nsga2 import nsga2, pareto_prune, rng_stream

SAMPLE_LIMIT = 1 << 18  # per-cluster evaluation sample (256 KiB)

INVALID = (float("inf"), float("inf"))  # objectives of a broken genome


# ------------------------------------------------------------------ frontends
@dataclass
class Frontend:
    """How raw input bytes become typed streams + the plan prefix for it."""

    name: str = "raw"

    @property
    def n_inputs(self) -> int:
        return 1

    def parse(self, inputs: Sequence[Stream]) -> List[Stream]:
        return list(inputs)

    def emit(self, g: GraphBuilder) -> List[int]:
        return [g.input(i) for i in range(self.n_inputs)]


@dataclass
class CsvFrontend(Frontend):
    n_cols: int = 0
    sep: str = ","
    name: str = "csv"

    def parse(self, inputs):
        outs, _ = get_codec("csv_split").run_encode(
            list(inputs), {"sep": self.sep}
        )
        if len(outs) != self.n_cols:
            raise ValueError(f"csv has {len(outs)} cols, expected {self.n_cols}")
        return outs

    def emit(self, g):
        cols = g.add("csv_split", g.input(0), n_out=self.n_cols, sep=self.sep)
        return cols if isinstance(cols, list) else [cols]


@dataclass
class StructFrontend(Frontend):
    widths: Tuple[int, ...] = ()
    name: str = "struct"

    def parse(self, inputs):
        outs, _ = get_codec("field_split").run_encode(
            list(inputs), {"widths": list(self.widths)}
        )
        return outs

    def emit(self, g):
        fields = g.add(
            "field_split", g.input(0), n_out=len(self.widths), widths=list(self.widths)
        )
        return fields if isinstance(fields, list) else [fields]


@dataclass
class NumericFrontend(Frontend):
    width: int = 4
    name: str = "numeric"

    def parse(self, inputs):
        outs, _ = get_codec("interpret_numeric").run_encode(
            list(inputs), {"width": self.width}
        )
        return outs

    def emit(self, g):
        return [g.add("interpret_numeric", g.input(0), width=self.width)]


@dataclass
class GraphFrontend(Frontend):
    """Edge-list graphs: ``edge_list``/``edge_list_bin`` + ``adj_gap`` so the
    genome search runs over Zuckerli-shaped streams (nodes, degrees, refs,
    copy-bits, gaps [, parse bitmap, exception lines]) instead of raw text."""

    sep: str = "auto"
    window: int = 8
    binary_width: int = 0  # 0 = text edge list; 2/4/8 = binary (u, v) pairs
    name: str = "graph"

    def parse(self, inputs):
        if self.binary_width:
            cols, _ = get_codec("edge_list_bin").run_encode(
                list(inputs), {"width": self.binary_width}
            )
            src, dst = cols
            extra: List[Stream] = []
        else:
            outs, _ = get_codec("edge_list").run_encode(
                list(inputs), {"sep": self.sep}
            )
            src, dst, bitmap, exc = outs
            extra = [bitmap, exc]
        adj, _ = get_codec("adj_gap").run_encode([src, dst], {"window": self.window})
        return list(adj) + extra

    def emit(self, g):
        if self.binary_width:
            src, dst = g.add("edge_list_bin", g.input(0), width=self.binary_width)
            extra = []
        else:
            src, dst, bitmap, exc = g.add("edge_list", g.input(0), sep=self.sep)
            extra = [bitmap, exc]
        adj = g.add("adj_gap", src, dst, window=self.window)
        return list(adj) + extra


@dataclass
class MultiStreamFrontend(Frontend):
    """Inputs are already typed streams (e.g. Parquet-decoded columns)."""

    k: int = 1
    name: str = "multistream"

    @property
    def n_inputs(self) -> int:
        return self.k


def detect_frontend(raw: bytes) -> Frontend:
    """``--frontend auto``: pick a frontend by sniffing sample bytes.

    Detection order encodes signal strength: text edge lists first (two
    canonical integers per line under a whitespace separator is stricter
    than any CSV rule — comma edge files still sniff as CSV, which subsumes
    them), then rectangular CSV, then binary interleaved (src, dst) edge
    pairs, then *sorted* fixed-width integers, then fixed-size records
    (split into per-offset byte columns so clustering and the per-cluster
    search see each field position on its own), then bounded integers, and
    finally raw bytes.  Binary edge pairs outrank sorted-numeric because a
    source-sorted u32 pair stream re-read at width 8 *is* mostly monotone
    (the neighbor column dominates the high half); sorted-numeric outranks
    struct because a sorted array is itself lag-periodic; bounded-numeric
    ranks below struct because multi-field records also show a constant top
    byte.  The sniffers live in :mod:`repro_torch.codecs.parse` next to the
    parser codecs they route to, and read host bytes only.
    """
    from ..codecs.parse import (
        sniff_csv,
        sniff_edge_list,
        sniff_edge_list_bin,
        sniff_numeric_width,
        sniff_struct_width,
    )

    sep = sniff_edge_list(raw)
    if sep is not None:
        return GraphFrontend(sep=sep)
    csv = sniff_csv(raw)
    if csv is not None:
        return CsvFrontend(n_cols=csv[0], sep=csv[1])
    bw = sniff_edge_list_bin(raw)
    if bw is not None:
        return GraphFrontend(binary_width=bw)
    width = sniff_numeric_width(raw, require_monotone=True)
    if width is not None:
        return NumericFrontend(width=width)
    rec = sniff_struct_width(raw)
    if rec is not None:
        # a "record" of a numeric storage width whose values also read as
        # bounded integers is an integer column, not a struct
        if rec in (2, 4, 8) and sniff_numeric_width(raw, widths=(rec,)) == rec:
            return NumericFrontend(width=rec)
        return StructFrontend(widths=(1,) * rec)
    width = sniff_numeric_width(raw)
    if width is not None:
        return NumericFrontend(width=width)
    return Frontend()


# ----------------------------------------------------------- trained result
@dataclass
class TradeoffPoint:
    genomes: List[Optional[GNode]]  # one per cluster
    est_size: float  # compressed bytes of the training sample
    est_time: float  # deterministic encode-cost estimate, seconds (cost model)


@dataclass
class TrainedCompressor:
    frontend: Frontend
    clustering: Clustering
    sigs: List[Tuple[int, int]]  # signature per cluster
    points: List[TradeoffPoint]  # Pareto tradeoff points (size-ordered)
    stats: Dict[str, float] = field(default_factory=dict)

    def build_plan(self, point: TradeoffPoint) -> Plan:
        g = GraphBuilder(self.frontend.n_inputs)
        stream_edges = self.frontend.emit(g)
        for ci, idxs in enumerate(self.clustering.clusters):
            edges = [stream_edges[i] for i in idxs]
            src = edges[0] if len(edges) == 1 else g.add("concat", *edges)
            emit_genome(g, point.genomes[ci], src, self.sigs[ci])
        return g.build(f"trained_{self.frontend.name}")

    def best_ratio_plan(self) -> Plan:
        return self.build_plan(min(self.points, key=lambda p: p.est_size))

    def fastest_plan(self) -> Plan:
        return self.build_plan(min(self.points, key=lambda p: p.est_time))

    def pareto_plans(self) -> List[Tuple[Plan, float, float]]:
        return [
            (self.build_plan(p), p.est_size, p.est_time)
            for p in sorted(self.points, key=lambda p: p.est_size)
        ]


# ------------------------------------------------------------------- training
def _sample_stream(s: Stream, limit: int = SAMPLE_LIMIT) -> Stream:
    """The stream's first ``limit`` bytes, as a view on its device; a STRING
    stream is cut at a string boundary found on its host lengths."""
    if s.nbytes <= limit:
        return s
    if s.stype == SType.STRING:
        cut = int(np.searchsorted(np.cumsum(s.lengths), limit)) + 1
        cut = min(cut, int(s.lengths.size))
        nb = int(s.lengths[:cut].sum())
        return Stream(s.data[:nb], SType.STRING, 1, s.lengths[:cut])
    n_elts = max(limit // max(s.width, 1), 1)
    if s.stype == SType.NUMERIC:
        return Stream(s.data[:n_elts], s.stype, s.width)
    take = n_elts * (s.width if s.stype == SType.STRUCT else 1)
    return Stream(s.data[:take], s.stype, s.width)


def _seed_genomes(sig: Tuple[int, int]) -> List[Optional[GNode]]:
    """Paper: "population is seeded with simple but commonly effective
    compression graphs"."""
    N, S, T, G = (int(x) for x in (SType.NUMERIC, SType.SERIAL, SType.STRUCT, SType.STRING))
    stype, w = sig
    seeds: List[Optional[GNode]] = [
        None,
        GNode("zlib_backend", {"level": 6}),
    ]
    if stype != G:
        seeds.append(GNode("lzma_backend", {"preset": 6}))
        seeds.append(GNode("bz2_backend", {"level": 9}))
    if stype == N:
        seeds += [
            GNode("range_pack"),
            GNode("delta", {}, [GNode("range_pack")]),
            GNode("transpose", {}, [GNode("huffman")]),
            GNode("delta", {}, [GNode("transpose", {}, [GNode("fse", {"table_log": 11})])]),
            GNode("delta", {}, [GNode("transpose", {}, [GNode("lzma_backend", {"preset": 6})])]),
            GNode("delta", {}, [GNode("lzma_backend", {"preset": 6})]),
            GNode("tokenize", {}, [None, GNode("range_pack")]),
            # sparse/run-heavy data (era5 snow/precip): RLE first
            GNode("rle", {}, [GNode("lzma_backend", {"preset": 6}), GNode("range_pack")]),
        ]
        if w in (2, 4, 8):
            seeds.append(GNode("float_split", {"fmt": {2: 0, 4: 2, 8: 3}[w]}))
    elif stype in (S,) or (stype == T and w == 1):
        seeds += [
            GNode("huffman"),
            GNode("fse", {"table_log": 11}),
            GNode("lz77", {}, [GNode("huffman"), GNode("range_pack"), GNode("range_pack"), GNode("range_pack")]),
        ]
    elif stype == T:
        seeds += [
            GNode("transpose", {}, [GNode("huffman")]),
            GNode("interpret_numeric", {"width": w if w in (1, 2, 4, 8) else 1}),
        ]
    elif stype == G:
        seeds += [
            GNode("tokenize"),
            GNode("string_split", {}, [GNode("zlib_backend", {"level": 6}), GNode("delta", {}, [GNode("range_pack")])]),
            GNode("parse_numeric", {}, [None, GNode("delta", {}, [GNode("transpose", {}, [GNode("huffman")])]), None]),
        ]
    return seeds


# ----------------------------------------------------- deterministic cost
# Per-codec encode cost in ns/input-byte: the reference's host model,
# copied unchanged.  This is the NSGA-II *speed objective*: a pure function
# of the executed step trace, so identically seeded training runs rank
# candidates identically on any machine, device and worker count, and rank
# them as the reference does.  These are not times of the card.
COST_NS_PER_BYTE: Dict[str, float] = {
    "store": 0.05,
    "dup": 0.1,
    "constant": 0.1,
    "interpret_numeric": 0.1,
    "split_n": 0.2,
    "concat": 0.3,
    "delta": 0.3,
    "zigzag": 0.3,
    "transpose": 0.5,
    "string_split": 0.5,
    "transpose_split": 0.6,
    "fused_delta_bitpack": 0.6,
    "bitpack": 0.8,
    "range_pack": 0.9,
    "field_split": 1.0,
    "float_split": 1.0,
    "rle": 1.2,
    "tokenize": 2.0,
    "huffman": 9.0,
    "fse": 11.0,
    "zlib_backend": 30.0,
    "lz77": 45.0,
    "parse_numeric": 60.0,
    "csv_split": 80.0,
    "edge_list": 90.0,
    "edge_list_bin": 0.3,
    "adj_gap": 6.0,
    "bz2_backend": 90.0,
    "lzma_backend": 450.0,
}
COST_DEFAULT_NS_PER_BYTE = 8.0  # unlisted codecs: mid-range transform
COST_NS_PER_NODE = 20_000.0  # fixed per-node dispatch/header overhead


def trace_cost_seconds(trace: Sequence[Tuple[str, int]]) -> float:
    """Deterministic encode-cost estimate (seconds) of an executed trace."""
    ns = 0.0
    for name, nbytes in trace:
        ns += COST_NS_PER_NODE + COST_NS_PER_BYTE.get(
            name, COST_DEFAULT_NS_PER_BYTE
        ) * nbytes
    return ns / 1e9


def _same_stream(back: Stream, sample: Stream) -> bool:
    """Lossless and type-faithful: equal bytes compared on the device, equal
    type and width, equal host STRING lengths."""
    return (
        back.stype == sample.stype
        and back.width == sample.width  # type-faithfulness required
        and torch.equal(back.raw(), sample.raw())
        and (
            sample.stype != SType.STRING
            or np.array_equal(back.lengths, sample.lengths)
        )
    )


# ------------------------------------------------------------- the service
class TrainerService:
    """Parallel, session-backed genome evaluation (the trainer's engine room).

    Owns a persistent thread pool, one shared :class:`ExecScratch` so every
    candidate reuses the same coder-table cache, an LRU of per-genome
    :class:`CompressorSession` objects (elitist survivors are re-evaluated
    every generation — their sessions, and through them the engine resolve
    cache entries keyed on the compiled plan, persist across generations and
    clusters), and one :class:`DecompressorSession` for the mandatory
    losslessness check.  Every session runs on ``device`` (the card unless
    the caller names the CPU; without a card the default raises), and the
    pool's threads launch on the CUDA stream current where :meth:`map` is
    called.

    ``evaluate_batch`` is order-independent and side-effect-free w.r.t. the
    returned objectives: ``(compressed_bytes, trace_cost_seconds)`` is a pure
    function of (genome, sample).  Wall-clock per-candidate timing
    (``time.perf_counter``, taken after the frame is on the host) is
    accumulated in :attr:`stats` for reporting only.  A service instance may
    be reused across ``train()`` calls — a long-running training endpoint
    pays for pool/cache spin-up once.
    """

    def __init__(
        self,
        workers: Optional[int] = None,
        *,
        level: int = 5,
        session_cache_size: int = 1024,
        table_cache_size: int = 512,
        static_prune: bool = True,
        device: DeviceLike = "cuda",
    ):
        self.workers = int(workers) if workers else len(os.sched_getaffinity(0))
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        self.device = _device.resolve_device(device)
        self.level = level
        self.static_prune = bool(static_prune)
        self.scratch = ExecScratch(table_cache_size)
        self._dec = DecompressorSession(device=self.device, scratch=self.scratch)
        self._sessions: "OrderedDict[Plan, CompressorSession]" = OrderedDict()
        self._session_cache_size = session_cache_size
        self._check_cache: "OrderedDict[tuple, bool]" = OrderedDict()
        self._lock = threading.Lock()
        self._pool = None
        self.stats: Dict[str, float] = {
            "evaluations": 0,
            "invalid": 0,
            "pruned_static": 0,
            "eval_wall_seconds": 0.0,
            "session_hits": 0,
            "session_misses": 0,
        }

    # ------------------------------------------------------------- plumbing
    def _pool_get(self):
        from concurrent.futures import ThreadPoolExecutor

        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers, thread_name_prefix="ozl-train"
                )
            return self._pool

    def map(self, fn, items) -> list:
        """Ordered parallel map; strictly serial when ``workers == 1`` (so
        worker-count determinism tests compare genuinely different paths).
        The first error of any item propagates."""
        items = list(items)
        if self.workers <= 1 or len(items) <= 1:
            return [fn(x) for x in items]
        return list(self._pool_get().map(on_caller_stream(self.device, fn), items))

    def _session_for(self, plan: Plan) -> CompressorSession:
        with self._lock:
            sess = self._sessions.get(plan)
            if sess is not None:
                self._sessions.move_to_end(plan)
                self.stats["session_hits"] += 1
                return sess
            self.stats["session_misses"] += 1
            sess = CompressorSession(
                plan,
                ctx=CompressionCtx(level=self.level),
                device=self.device,
                scratch=self.scratch,
            )
            self._sessions[plan] = sess
            while len(self._sessions) > self._session_cache_size:
                _, old = self._sessions.popitem(last=False)
                old.close()
            return sess

    def _bump(self, **deltas: float) -> None:
        with self._lock:
            for k, v in deltas.items():
                self.stats[k] += v

    # ------------------------------------------------------------ evaluation
    def _statically_rejected(self, plan: Plan, sig: Tuple[int, int]) -> bool:
        """True when the analyzer proves the plan cannot encode a stream of
        this signature.  Cached per (plan, sig): elites recur every
        generation.  The analyzer is *definite* — it only errors on plans the
        encoder would refuse — so pruning changes which candidates get trial
        compressions, never their objectives (INVALID either way)."""
        key = (plan, tuple(sig))
        with self._lock:
            hit = self._check_cache.get(key)
            if hit is not None:
                self._check_cache.move_to_end(key)
                return hit
        from ..analysis import check_plan  # lazy: trainer has no cycle

        rejected = not check_plan(plan, input_atoms=[tuple(sig)]).ok
        with self._lock:
            self._check_cache[key] = rejected
            while len(self._check_cache) > self._session_cache_size:
                self._check_cache.popitem(last=False)
        return rejected

    def _evaluate_plan(
        self, plan: Plan, sample: Stream, sig: Tuple[int, int]
    ) -> Tuple[float, float]:
        if self.static_prune and self._statically_rejected(plan, sig):
            self._bump(evaluations=1, invalid=1, pruned_static=1)
            return INVALID
        try:
            sess = self._session_for(plan)
            with trial():
                frame, trace, wall = sess.compress_traced([sample])
        except ValueError:  # a codec refused: the genome is broken
            self._bump(evaluations=1, invalid=1)
            return INVALID
        self._bump(evaluations=1, eval_wall_seconds=wall)
        try:
            (back,) = self._dec.decompress(frame)
            ok = _same_stream(back, sample)
        except ValueError:  # FrameError and every decoder's refusal
            ok = False
        if not ok:
            self._bump(invalid=1)
            return INVALID
        return (float(len(frame)), trace_cost_seconds(trace))

    def evaluate_genome(
        self, genome: Optional[GNode], sample: Stream, sig: Tuple[int, int]
    ) -> Tuple[float, float]:
        """One candidate -> ``(compressed_bytes, deterministic cost seconds)``.

        Broken genomes (compile/encode refusals, or any losslessness or
        type-fidelity failure) score ``(inf, inf)`` and are discarded by
        selection.
        """
        try:
            plan = compile_genome(genome, sig)
        except ValueError:
            self._bump(evaluations=1, invalid=1)
            return INVALID
        return self._evaluate_plan(plan, sample.to(self.device), sig)

    def evaluate_batch(
        self,
        genomes: Sequence[Optional[GNode]],
        sample: Stream,
        sig: Tuple[int, int],
    ) -> List[Tuple[float, float]]:
        """Batch evaluation: compile, dedupe by compiled plan (elites and
        crossover clones recur every generation), fan the unique plans out
        over the pool, and scatter results back in order."""
        sample = sample.to(self.device)
        plans: List[Optional[Plan]] = []
        for g in genomes:
            try:
                plans.append(compile_genome(g, sig))
            except ValueError:
                self._bump(evaluations=1, invalid=1)
                plans.append(None)
        unique = list(OrderedDict.fromkeys(p for p in plans if p is not None))
        objs = self.map(lambda p: self._evaluate_plan(p, sample, sig), unique)
        table = dict(zip(unique, objs))
        return [INVALID if p is None else table[p] for p in plans]

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
            sessions = list(self._sessions.values())
            self._sessions.clear()
        if pool is not None:
            pool.shutdown(wait=True)
        for s in sessions:
            s.close()
        self._dec.close()

    def __enter__(self) -> "TrainerService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def train(
    sample_inputs: List[List[Stream]],
    frontend: Frontend,
    *,
    pop_size: int = 16,
    generations: int = 6,
    n_points: int = 8,
    seed: int = 0,
    workers: Optional[int] = None,
    service: Optional[TrainerService] = None,
    static_prune: bool = True,
    verbose: bool = False,
    device: DeviceLike = "cuda",
) -> TrainedCompressor:
    """Train a compressor from sample inputs (each a list of input streams).

    ``workers`` sizes the evaluation pool (default: all CPUs); pass an
    existing ``service`` instead to amortize pool/cache spin-up across calls.
    Training runs on ``device`` (the card unless the caller names the CPU),
    or on the ``service``'s device when one is passed; the samples are moved
    there first.  Identical ``seed`` ⇒ identical result — including
    serialized plan bytes, which are the reference's — for any ``workers``
    value.  Besides the reference's ``stats``, ``parse_seconds``,
    ``cluster_seconds``, ``search_seconds`` and ``merge_seconds`` split
    ``train_seconds`` by stage.
    """
    t_start = time.perf_counter()
    own_service = service is None
    if service is None:
        service = TrainerService(workers, static_prune=static_prune, device=device)
    try:
        # 1. parse every sample and concatenate slot-wise
        parsed = [
            frontend.parse([s.validate().to(service.device) for s in sample])
            for sample in sample_inputs
        ]
        n_slots = len(parsed[0])
        if any(len(p) != n_slots for p in parsed):
            raise ValueError("inconsistent stream counts across samples")
        streams = [
            _concat_streams([p[i] for p in parsed]) for i in range(n_slots)
        ]
        total_bytes = sum(s.nbytes for s in streams)
        t_parsed = time.perf_counter()

        # 2. greedy clustering (paper: trainer merges clusters while it
        # shrinks); merge-candidate probes fan out over the same pool
        clustering = cluster_streams(streams, pool_map=service.map)
        if verbose:
            print(f"[train] {n_slots} streams -> {len(clustering.clusters)} clusters")
        t_clustered = time.perf_counter()

        # 3. per-cluster NSGA-II backend search
        sigs: List[Tuple[int, int]] = []
        per_cluster: List[Tuple[List[Optional[GNode]], List[Tuple[float, float]]]] = []
        for ci, idxs in enumerate(clustering.clusters):
            merged = _concat_streams([streams[i] for i in idxs])
            sig = (int(merged.stype), merged.width)
            sigs.append(sig)
            sample = _sample_stream(merged)
            res = nsga2(
                _seed_genomes(sig),
                lambda genomes: service.evaluate_batch(genomes, sample, sig),
                lambda gno, r: mutate(gno, sig, r),
                lambda a, b, r: crossover(a, b, sig, r),
                pop_size=pop_size,
                generations=generations,
                seed=rng_stream(seed, "cluster", ci).getrandbits(32),
            )
            # drop invalid entries
            pareto = [
                (g, o)
                for g, o in zip(res.pareto, res.pareto_objs)
                if o[0] != float("inf")
            ] or [(None, service.evaluate_genome(None, sample, sig))]
            genomes, objs = zip(*pareto)
            per_cluster.append((list(genomes), list(objs)))
            if verbose:
                print(
                    f"[train] cluster {ci} ({len(idxs)} streams, sig {sig}):"
                    f" {len(genomes)} pareto pts, best {min(o[0] for o in objs):.0f}B"
                )
        t_searched = time.perf_counter()

        # 4. iterative Pareto merge across clusters (paper §VI-C last paragraph)
        points: List[TradeoffPoint] = [TradeoffPoint([], 0.0, 0.0)]
        for genomes, objs in per_cluster:
            expanded: List[TradeoffPoint] = []
            seen_objs = set()  # identical objectives => redundant tradeoff
            for pt in points:
                for gno, (sz, tm) in zip(genomes, objs):
                    key = (pt.est_size + sz, pt.est_time + tm)
                    if key in seen_objs:
                        continue
                    seen_objs.add(key)
                    expanded.append(TradeoffPoint(pt.genomes + [gno], *key))
            objs2 = [(p.est_size, p.est_time) for p in expanded]
            points, _ = pareto_prune(expanded, objs2, n_points)

        t_end = time.perf_counter()
        dt = t_end - t_start
        return TrainedCompressor(
            frontend,
            clustering,
            sigs,
            sorted(points, key=lambda p: p.est_size),
            stats={
                "train_seconds": dt,
                "train_bytes": float(total_bytes),
                "train_speed_mib_min": total_bytes / (1 << 20) / (dt / 60.0)
                if dt
                else 0.0,
                "n_clusters": float(len(clustering.clusters)),
                "n_streams": float(n_slots),
                "workers": float(service.workers),
                "evaluations": float(service.stats["evaluations"]),
                "invalid_evaluations": float(service.stats["invalid"]),
                "pruned_static": float(service.stats["pruned_static"]),
                "eval_wall_seconds": float(service.stats["eval_wall_seconds"]),
                "session_hits": float(service.stats["session_hits"]),
                "session_misses": float(service.stats["session_misses"]),
                "parse_seconds": t_parsed - t_start,
                "cluster_seconds": t_clustered - t_parsed,
                "search_seconds": t_searched - t_clustered,
                "merge_seconds": t_end - t_searched,
            },
        )
    finally:
        if own_service:
            service.close()
