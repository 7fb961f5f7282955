"""Automated compressor training (paper §VI-C): greedy stream clustering +
parallel NSGA-II genetic search over backend graphs + Pareto merge, behind a
deterministic session-backed evaluation service (``TrainerService``).

The port's copy of ``repro.training``: the candidates are encoded and
decoded on the card (``device="cuda"`` unless the caller names the CPU), and
the same seed gives the reference's Pareto points and plan bytes.
"""
from .cluster import Clustering, cluster_streams  # noqa: F401
from .gp import GNode, compile_genome, crossover, mutate, random_genome  # noqa: F401
from .nsga2 import (  # noqa: F401
    crowding_distance,
    nondominated_sort,
    nsga2,
    pareto_prune,
    rng_stream,
)
from .trainer import (  # noqa: F401
    CsvFrontend,
    Frontend,
    GraphFrontend,
    MultiStreamFrontend,
    NumericFrontend,
    StructFrontend,
    TradeoffPoint,
    TrainedCompressor,
    TrainerService,
    detect_frontend,
    train,
)
