"""The port's genetic-programming operators and NSGA-II engine
(``repro_torch.training.gp``, ``repro_torch.training.nsga2``) against the
reference's (``repro.training``).

Every case draws from the same seeded ``random.Random`` in both packages and
compares with tolerance 0: random genomes node for node, ``mutate`` and
``crossover`` chains, the type rules (``_out_sigs``, ``n_out_for``,
``MENU``), ``compile_genome`` plans as ``serialize_plan`` bytes (ill-typed
ones too: ``emit_genome`` is permissive), ``rng_stream``,
``nondominated_sort``, ``crowding_distance``, ``pareto_prune`` and whole
``nsga2`` runs on seeded and hypothesis inputs.  The invariants of
``tests/test_trainer.py`` and the NSGA-II edge cases of
``tests/test_trainer_parallel.py`` are mirrored on the port, and its random
genomes round-trip on the CPU or are refused with a ``ValueError``.
"""
import importlib
import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hyp import given, settings, st  # noqa: E402
from _torch_train_ref import genome_tree  # noqa: E402

from repro.core.serialize import serialize_plan as ref_serialize  # noqa: E402
from repro.training import gp as RG  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.message import SType, numeric, serial  # noqa: E402
from repro_torch.core.message import struct as mk_struct  # noqa: E402
from repro_torch.core.serialize import serialize_plan  # noqa: E402
from repro_torch.training import gp as PG  # noqa: E402

# the packages export the function ``nsga2`` under the module's name
RN = importlib.import_module("repro.training.nsga2")
PN = importlib.import_module("repro_torch.training.nsga2")
N, S, T, G = (int(x) for x in (SType.NUMERIC, SType.SERIAL, SType.STRUCT, SType.STRING))
SIGS = [(N, 1), (N, 2), (N, 4), (N, 8), (S, 1), (T, 1), (T, 3), (T, 4), (T, 8), (G, 1)]
CODECS = sorted(RG._FIXED_OUT) + ["transpose_split", "no_such_codec"]
SEEDS = range(40)


def _same_plan(pgen, rgen, sig, n_inputs=1):
    got = serialize_plan(PG.compile_genome(pgen, sig, n_inputs))
    want = ref_serialize(RG.compile_genome(rgen, sig, n_inputs))
    assert got == want


# ----------------------------------------------------------------- gp rules
def test_the_menus_and_output_counts_are_the_references():
    assert PG.MENU == RG.MENU
    assert PG._FIXED_OUT == RG._FIXED_OUT
    for sig in SIGS:
        for codec in sorted(RG._FIXED_OUT) + ["transpose_split"]:
            assert PG.n_out_for(codec, {}, sig) == RG.n_out_for(codec, {}, sig)


@pytest.mark.parametrize("sig", SIGS, ids=str)
def test_out_sigs_are_the_references_for_every_codec_and_param(sig):
    for codec in CODECS:
        for params in ({}, {"width": 1}, {"width": 2}, {"width": 3}, {"width": 8}):
            assert PG._out_sigs(codec, params, sig) == RG._out_sigs(codec, params, sig)


@pytest.mark.parametrize("sig", SIGS, ids=str)
def test_default_params_draw_the_references_values(sig):
    for codec in CODECS:
        rp, rr = random.Random(11), random.Random(11)
        for _ in range(5):
            assert PG._default_params(codec, sig, rp) == RG._default_params(codec, sig, rr)
        assert rp.random() == rr.random()


# ------------------------------------------------------------ gp operators
@pytest.mark.parametrize("sig", SIGS, ids=str)
def test_random_genomes_are_the_references_node_for_node(sig):
    for seed in SEEDS:
        rp, rr = random.Random(seed), random.Random(seed)
        for depth, max_depth in ((0, 3), (1, 3), (0, 5)):
            pg = PG.random_genome(sig, rp, depth, max_depth)
            rg = RG.random_genome(sig, rr, depth, max_depth)
            assert genome_tree(pg) == genome_tree(rg)
            assert (pg.size() if pg else 0) == (rg.size() if rg else 0)
            _same_plan(pg, rg, sig)
        assert rp.random() == rr.random()  # the same number of draws


@pytest.mark.parametrize("sig", SIGS, ids=str)
def test_mutate_and_crossover_chains_are_the_references(sig):
    for seed in range(12):
        rp, rr = random.Random(seed), random.Random(seed)
        pa, ra = PG.random_genome(sig, rp), RG.random_genome(sig, rr)
        pb, rb = PG.random_genome(sig, rp), RG.random_genome(sig, rr)
        for _ in range(30):
            pa, ra = PG.mutate(pa, sig, rp), RG.mutate(ra, sig, rr)
            assert genome_tree(pa) == genome_tree(ra)
            pc, rc = PG.crossover(pa, pb, sig, rp), RG.crossover(ra, rb, sig, rr)
            assert genome_tree(pc) == genome_tree(rc)
            _same_plan(pc, rc, sig)
            pb, rb = pc, rc
        assert rp.random() == rr.random()


def test_copies_are_deep_and_crossover_of_terminals_copies():
    sig = (N, 4)
    g = PG.GNode("delta", {}, [PG.GNode("transpose", {}, [PG.GNode("huffman")])])
    c = g.copy()
    c.children[0].children[0].codec = "fse"
    assert g.children[0].children[0].codec == "huffman"
    assert PG.crossover(None, None, sig, random.Random(0)) is None
    got = PG.crossover(None, g, sig, random.Random(0))
    assert genome_tree(got) == genome_tree(g) and got is not g


@pytest.mark.parametrize("n_inputs", [1, 2, 3])
def test_ill_typed_and_grouped_genomes_compile_as_the_references(n_inputs):
    """``emit_genome`` emits a codec applied off its menu (the analyzer or the
    trial rejects it later) and a cluster of n inputs concatenates first."""
    cases = [
        ((N, 4), ("huffman", {}, [])),
        ((G, 1), ("delta", {}, [("range_pack", {}, [])])),
        ((S, 1), ("float_split", {"fmt": 2}, [None, ("huffman", {}, [])])),
        ((T, 3), ("interpret_numeric", {"width": 3}, [])),
        ((N, 8), ("transpose_split", {}, [("huffman", {}, []), None, ("fse", {"table_log": 11}, [])])),
    ]

    def build(mod, spec):
        if spec is None:
            return None
        codec, params, kids = spec
        return mod.GNode(codec, dict(params), [build(mod, k) for k in kids])

    for sig, spec in cases:
        _same_plan(build(PG, spec), build(RG, spec), sig, n_inputs)


# ------------------------------------------------------------------ nsga2
def test_rng_stream_is_the_references():
    for key in [(), ("fill", 0), ("child", 3, 7), ("cluster", 2), ("a", 1.5, None)]:
        for seed in (0, 1, 7, 2 ** 31, 2 ** 40 + 3):
            p, r = PN.rng_stream(seed, *key), RN.rng_stream(seed, *key)
            assert [p.random() for _ in range(4)] == [r.random() for _ in range(4)]
            assert p.getrandbits(32) == r.getrandbits(32)


def _objective_lists(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    kind = seed % 4
    if kind == 0:  # continuous
        objs = rng.uniform(0, 100, (n, 2))
    elif kind == 1:  # few values: ties and duplicates
        objs = rng.integers(0, 4, (n, 2)).astype(float)
    elif kind == 2:  # three objectives
        objs = rng.integers(0, 10, (n, 3)).astype(float)
    else:  # INVALID entries among them
        objs = rng.uniform(0, 10, (n, 2))
        objs[rng.random(n) < 0.3] = math.inf
    return [tuple(float(v) for v in row) for row in objs]


def test_sorting_crowding_and_pruning_are_the_references_on_seeded_lists():
    for seed in range(200):
        objs = _objective_lists(seed)
        fronts = PN.nondominated_sort(objs)
        assert fronts == RN.nondominated_sort(objs)
        for front in fronts:
            assert PN.crowding_distance(objs, front) == RN.crowding_distance(objs, front)
        items = list(range(len(objs)))
        for keep in (1, 2, 5, len(objs)):
            assert PN.pareto_prune(items, objs, keep) == RN.pareto_prune(items, objs, keep)


@given(
    st.lists(st.tuples(st.floats(0, 100), st.floats(0, 100)), min_size=1, max_size=40),
    st.integers(1, 12),
)
@settings(max_examples=60, deadline=None)
def test_sorting_and_pruning_are_the_references_hypothesis(objs, keep):
    pytest.importorskip("hypothesis")
    fronts = PN.nondominated_sort(objs)
    assert fronts == RN.nondominated_sort(objs)
    assert PN.crowding_distance(objs, fronts[0]) == RN.crowding_distance(objs, fronts[0])
    items = list(range(len(objs)))
    assert PN.pareto_prune(items, objs, keep) == RN.pareto_prune(items, objs, keep)


def _toy_nsga2(mod, seed, pop_size, generations):
    """A whole run over integer genomes: every variation draw and every
    selection is the engine's own, so equal results mean equal draws."""
    calls = []

    def evaluate(pop):
        calls.append(len(pop))
        return [(float((g * 37) % 101), float(abs(g - 50))) for g in pop]

    res = mod.nsga2(
        [3, 17, 60, 88],
        evaluate,
        lambda g, r: g + r.randrange(-9, 10),
        lambda a, b, r: (a + b) // 2 + r.randrange(0, 3),
        pop_size=pop_size,
        generations=generations,
        seed=seed,
    )
    return res.pareto, res.pareto_objs, res.evaluations, calls


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("pop_size,generations", [(2, 0), (4, 1), (10, 4), (16, 6)])
def test_whole_nsga2_runs_are_the_references(seed, pop_size, generations):
    assert _toy_nsga2(PN, seed, pop_size, generations) == _toy_nsga2(RN, seed, pop_size, generations)


# ------------------------------------- mirrored invariants and edge cases
@given(st.lists(st.tuples(st.floats(0, 100), st.floats(0, 100)), min_size=1, max_size=40))
@settings(max_examples=30, deadline=None)
def test_nondominated_sort_front0_is_nondominated(objs):
    pytest.importorskip("hypothesis")
    f0 = PN.nondominated_sort(objs)[0]
    for i in f0:
        for j in f0:
            if i != j:
                assert not PN.dominates(objs[i], objs[j])


@given(
    st.lists(st.tuples(st.floats(0, 100), st.floats(0, 100)), min_size=5, max_size=40),
    st.integers(1, 10),
)
@settings(max_examples=30, deadline=None)
def test_pareto_prune_keeps_k(objs, k):
    pytest.importorskip("hypothesis")
    kept, _ = PN.pareto_prune(list(range(len(objs))), objs, k)
    assert len(kept) == min(k, len(objs))


def test_nondominated_sort_edge_cases():
    assert PN.nondominated_sort([(1.0, 1.0), (1.0, 1.0), (2.0, 2.0), (1.0, 1.0)]) == [[0, 1, 3], [2]]
    assert PN.nondominated_sort([(5.0, 5.0)]) == [[0]]
    assert PN.nondominated_sort([(3.0, 3.0), (2.0, 2.0), (1.0, 1.0)]) == [[2], [1], [0]]


def test_crowding_distance_edge_cases():
    dist = PN.crowding_distance([(1.0, 2.0), (2.0, 1.0)], [0, 1])
    assert dist[0] == math.inf and dist[1] == math.inf
    assert PN.crowding_distance([(1.0, 1.0)], [0]) == {0: math.inf}
    objs = [(1.0, 5.0), (2.0, 5.0), (3.0, 5.0), (4.0, 5.0)]
    dist = PN.crowding_distance(objs, [0, 1, 2, 3])
    assert dist[0] == math.inf and dist[3] == math.inf
    assert 0.0 <= dist[1] < math.inf and 0.0 <= dist[2] < math.inf
    dist = PN.crowding_distance([(2.0, 2.0)] * 5, list(range(5)))
    assert all(v == math.inf or v == 0.0 for v in dist.values())


def test_rng_stream_is_stable_and_keyed():
    assert PN.rng_stream(3, "a", 1).randrange(1 << 30) == PN.rng_stream(3, "a", 1).randrange(1 << 30)
    assert PN.rng_stream(3, "a", 1).random() != PN.rng_stream(3, "a", 2).random()
    assert PN.rng_stream(3, "a").random() != PN.rng_stream(4, "a").random()


_rng_np = np.random.default_rng(0)


def _sig_data(sig):
    stype, w = sig
    if stype == N:
        return numeric(_rng_np.integers(0, 1000, 500).astype(f"uint{8 * w}"))
    if stype == T:
        return mk_struct(_rng_np.integers(0, 5, 300 * w).astype(np.uint8), w)
    return serial(_rng_np.integers(0, 30, 800).astype(np.uint8).tobytes())


@pytest.mark.parametrize("sig", [(N, 4), (S, 1), (N, 8), (T, 3)], ids=str)
def test_random_genomes_compile_and_roundtrip(sig):
    r = random.Random(7)
    data = _sig_data(sig)
    for _ in range(25):
        comp = engine.Compressor(PG.compile_genome(PG.random_genome(sig, r), sig), device="cpu")
        try:
            assert comp.roundtrip_check(data), "silent corruption is never allowed"
        except ValueError:
            pass  # a data-dependent refusal, which the trainer discards


def test_mutate_and_crossover_stay_valid():
    sig = (N, 4)
    r = random.Random(3)
    data = numeric(np.cumsum(_rng_np.integers(0, 9, 400)).astype(np.uint32))
    a, b = PG.random_genome(sig, r), PG.random_genome(sig, r)
    for _ in range(30):
        a = PG.mutate(a, sig, r)
        child = PG.crossover(a, b, sig, r)
        assert engine.Compressor(PG.compile_genome(child, sig), device="cpu").roundtrip_check(data)
