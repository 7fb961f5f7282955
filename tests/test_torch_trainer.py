"""The port's trainer (``repro_torch.training``: clustering, ``TrainerService``,
``train``) against the reference's, on the CPU, tolerance 0.

The yardstick is the reference's ``train`` with its candidate sessions and
clustering probes on ``backend="device"`` (``_torch_train_ref``, a test-side
patch), whose frames the port's equal; both packages' resolve caches are
emptied before each run.  For the struct, CSV, numeric, graph-text and
graph-binary frontends, and for ``detect_frontend``'s choice, the port gives
the reference's clusters and probe sizes, Pareto ``(est_size, est_time)``
list, ``serialize_plan`` bytes, evaluation, invalid and static-prune counts
and, at ``workers=1``, session hits and misses.  ``workers`` 1 and 4 give
identical plans, and so do static pruning on and off.  A trained plan
registers in the port's registry and compresses to the same frame in the
reference's ``Compressor``.  A card fault (an ``InjectedDeviceFault``) or a
``KernelError`` propagates out of ``train`` and ``cluster_streams``, where
the reference scores the genome ``INVALID``; a codec's ``ValueError`` is
still ``INVALID``.
"""
import functools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_huffman_cap import prefix_converges_whole_refuses  # noqa: E402
from _torch_train_ref import clear_caches, ref_device_trainer  # noqa: E402

import repro.training as RT  # noqa: E402
from repro.core import Compressor as RefCompressor  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.message import numeric as ref_numeric  # noqa: E402
from repro.core.message import serial as ref_serial  # noqa: E402
from repro.core.serialize import serialize_plan as ref_serialize  # noqa: E402
from repro_torch.analysis import check_plan  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.message import Stream, SType, numeric, serial, strings  # noqa: E402
from repro_torch.core.serialize import deserialize_plan, serialize_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.reliability import FaultPlan, InjectedDeviceFault  # noqa: E402
from repro_torch.service import PlanRegistry  # noqa: E402
from repro_torch.training import cluster as PC  # noqa: E402
from repro_torch.training import trainer as PT  # noqa: E402
import repro_torch.training as P  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ILLTYPED = REPO / "tests" / "illtyped"


# ------------------------------------------------------------------- inputs
def _struct_blob(n: int, seed: int = 0) -> bytes:
    """``tests/test_trainer_parallel.py``'s records: sorted u32, small u32."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, 1 << 20, n)).astype(np.uint32)
    b = rng.integers(0, 7, n).astype(np.uint32)
    rec = np.empty((n, 8), np.uint8)
    rec[:, :4] = a.view(np.uint8).reshape(n, 4)
    rec[:, 4:] = b.view(np.uint8).reshape(n, 4)
    return rec.reshape(-1).tobytes()


def _csv_blob() -> bytes:
    """``tests/test_analysis.py``'s static-pruning CSV."""
    return b"".join(b"%d,%d,%d\n" % (i, i * 7 % 97, 1000 - i) for i in range(200))


def _animals_csv() -> bytes:
    rng = np.random.default_rng(3)
    animals = [b"cat", b"dog", b"emu"]
    rows = [b"%d,%s,%d" % (i * 5, animals[int(rng.integers(3))], int(rng.integers(50)))
            for i in range(800)]
    return b"\n".join(rows) + b"\n"


def _sorted_u32() -> bytes:
    rng = np.random.default_rng(11)
    return np.sort(rng.integers(0, 1 << 24, 3000)).astype(np.uint32).tobytes()


def _edge_text() -> bytes:
    rng = np.random.default_rng(23)
    lines = [b"# graph"]
    for u in range(250):
        for v in np.unique(rng.integers(0, 250, 6)):
            lines.append(b"%d\t%d" % (u, v))
    return b"\n".join(lines) + b"\n"


def _edge_pairs() -> bytes:
    rng = np.random.default_rng(17)
    src = np.repeat(np.arange(150, dtype=np.uint32), 5)
    dst = np.concatenate(
        [np.sort(rng.choice(5000, 5, replace=False)) for _ in range(150)]
    ).astype(np.uint32)
    return np.stack([src, dst], axis=1).tobytes()


def _frontends(mod):
    """Each case: (samples as bytes, its frontend in ``mod``, train kwargs)."""
    struct = dict(pop_size=8, generations=2, seed=7)
    return {
        "struct": ([_struct_blob(1200, s) for s in (0, 1)],
                   mod.StructFrontend(widths=(4, 4)), struct),
        "csv": ([_csv_blob()], mod.CsvFrontend(n_cols=3),
                dict(pop_size=8, generations=2, n_points=4, seed=3)),
        "csv_detected": ([_animals_csv()], mod.detect_frontend(_animals_csv()),
                         dict(pop_size=6, generations=1, seed=0)),
        "numeric_detected": ([_sorted_u32()], mod.detect_frontend(_sorted_u32()),
                             dict(pop_size=6, generations=1, seed=0)),
        "numeric8": ([np.cumsum(np.random.default_rng(5).integers(0, 9, 400)).astype(np.uint64)
                      .tobytes()], mod.NumericFrontend(width=8),
                     dict(pop_size=6, generations=1, n_points=4, seed=1)),
        "graph_text": ([_edge_text()], mod.detect_frontend(_edge_text()),
                       dict(pop_size=6, generations=1, seed=0)),
        "graph_bin": ([_edge_pairs()], mod.GraphFrontend(binary_width=4),
                      dict(pop_size=4, generations=1, seed=2)),
    }


CASES = ("struct", "csv", "csv_detected", "numeric_detected", "numeric8", "graph_text",
         "graph_bin")
COUNTS = ("evaluations", "invalid_evaluations", "pruned_static", "n_clusters", "n_streams")


def _summary(tc, serialize):
    return {
        "clusters": tc.clustering.clusters,
        "sizes": tc.clustering.sizes,
        "sigs": tc.sigs,
        "objs": [(p.est_size, p.est_time) for p in tc.points],
        "plans": [serialize(p) for p, _sz, _tm in tc.pareto_plans()],
        "counts": {k: tc.stats[k] for k in COUNTS},
        "sessions": (tc.stats["session_hits"], tc.stats["session_misses"]),
    }


@functools.lru_cache(maxsize=None)
def port_run(case: str, workers: int = 1, static_prune: bool = True):
    blobs, fe, kw = _frontends(P)[case]
    clear_caches()
    tc = P.train([[serial(b)] for b in blobs], fe, workers=workers, static_prune=static_prune,
                 device="cpu", **kw)
    return tc, _summary(tc, serialize_plan)


@functools.lru_cache(maxsize=None)
def ref_run(case: str):
    blobs, fe, kw = _frontends(RT)[case]
    with ref_device_trainer():
        tc = RT.train([[ref_serial(b)] for b in blobs], fe, workers=1, **kw)
    return tc, _summary(tc, ref_serialize)


# -------------------------------------------------------------- equalities
@pytest.mark.parametrize("case", CASES)
def test_train_is_the_references(case):
    _, got = port_run(case)
    _, want = ref_run(case)
    assert got["clusters"] == want["clusters"] and got["sizes"] == want["sizes"]
    assert got["sigs"] == want["sigs"]
    assert got["objs"] == want["objs"]
    assert got["plans"] == want["plans"]
    assert got["counts"] == want["counts"]
    assert got["sessions"] == want["sessions"]
    assert got["objs"] and got["objs"] == sorted(got["objs"])


def test_detect_frontend_picks_the_references_frontends_here():
    for case in ("csv_detected", "numeric_detected", "graph_text"):
        _, pfe, _ = _frontends(P)[case]
        _, rfe, _ = _frontends(RT)[case]
        assert (type(pfe).__name__, vars(pfe)) == (type(rfe).__name__, vars(rfe))
    assert type(_frontends(P)["graph_text"][1]).__name__ == "GraphFrontend"


@pytest.mark.parametrize("case", ["struct", "graph_text"])
def test_four_workers_give_the_plans_of_one(case):
    _, one = port_run(case, 1)
    _, four = port_run(case, 4)
    assert four["objs"] == one["objs"]
    assert four["plans"] == one["plans"]
    assert four["counts"] == one["counts"]


def test_static_pruning_is_byte_identical_and_counts():
    on_tc, on = port_run("csv", 1, True)
    off_tc, off = port_run("csv", 1, False)
    assert on["counts"]["evaluations"] == off["counts"]["evaluations"]
    assert on["counts"]["invalid_evaluations"] == off["counts"]["invalid_evaluations"]
    assert on["counts"]["pruned_static"] > 0
    assert off["counts"]["pruned_static"] == 0
    assert on["plans"] == off["plans"] and on["objs"] == off["objs"]


def test_the_ill_typed_corpus_is_pruned():
    svc = P.TrainerService(workers=1, device="cpu")
    try:
        pruned = 0
        for fname in sorted(json.loads((ILLTYPED / "manifest.json").read_text())):
            plan, _meta = deserialize_plan((ILLTYPED / fname).read_bytes())
            if check_plan(plan).ok:
                continue
            assert svc._statically_rejected(plan, (None, None))
            pruned += 1
        assert pruned
    finally:
        svc.close()


def test_a_trained_plan_registers_and_compresses_as_the_reference_would():
    tc, _ = port_run("numeric8")
    blob = engine.Compressor(tc.best_ratio_plan()).serialize()
    entry = PlanRegistry().register_compressor(engine.Compressor.deserialize(blob), "trained")
    assert entry.plan_id == "trained"
    data = np.cumsum(np.random.default_rng(9).integers(0, 9, 3000)).astype(np.uint64)
    clear_caches()
    got = engine.Compressor.deserialize(blob, device="cpu").compress(numeric(data))
    ref_comp = RefCompressor.deserialize(blob)
    ref_comp.backend = "device"
    want = ref_comp.compress(ref_numeric(data))
    assert got == want
    assert engine.Compressor.deserialize(blob, device="cpu").roundtrip_check(numeric(data))


def test_every_tradeoff_point_roundtrips_on_held_out_data():
    tc, _ = port_run("struct")
    held_out = _struct_blob(3000, seed=99)
    for plan, _sz, _tm in tc.pareto_plans():
        clone = engine.Compressor.deserialize(engine.Compressor(plan).serialize(), device="cpu")
        assert clone.roundtrip_check(held_out), "tradeoff point not lossless"


def test_trainer_service_is_reusable_and_counts():
    sample = [[serial(_struct_blob(600))]]
    with P.TrainerService(workers=2, device="cpu") as svc:
        tc1 = P.train(sample, P.StructFrontend(widths=(4, 4)), pop_size=4, generations=1,
                      seed=0, service=svc)
        first = svc.stats["evaluations"]
        tc2 = P.train(sample, P.StructFrontend(widths=(4, 4)), pop_size=4, generations=1,
                      seed=0, service=svc)
    assert first > 0 and svc.stats["evaluations"] > first
    assert svc.stats["session_hits"] > 0
    assert [(p.est_size, p.est_time) for p in tc1.points] == [
        (p.est_size, p.est_time) for p in tc2.points]
    assert set(tc1.stats) >= {"parse_seconds", "cluster_seconds", "search_seconds",
                              "merge_seconds", "train_seconds", "train_speed_mib_min"}


# ------------------------------------------------------------ the helpers
def test_sample_stream_cuts_as_the_reference_does():
    from repro.core.message import Stream as RefStream
    from repro.core.message import strings as ref_strings
    from repro.training.trainer import _sample_stream as ref_sample

    rng = np.random.default_rng(1)
    items = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8)) for k in rng.integers(0, 9, 500)]
    for limit in (0, 1, 100, 1000, 2000, 10 ** 6):
        got = PT._sample_stream(strings(items), limit)
        want = ref_sample(ref_strings(items), limit)
        assert got.content_bytes() == want.content_bytes()
        assert np.array_equal(got.lengths, want.lengths)
    vals = rng.integers(0, 1 << 40, 777).astype(np.uint64)
    for stype, width in ((SType.NUMERIC, 8), (SType.STRUCT, 3), (SType.SERIAL, 1)):
        raw = vals.tobytes()[: len(vals.tobytes()) // 24 * 24]
        if stype == SType.NUMERIC:
            port_s, ref_s = numeric(np.frombuffer(raw, np.uint64)), ref_numeric(np.frombuffer(raw, np.uint64))
        else:
            port_s = Stream(serial(raw).data, stype, width)
            ref_s = RefStream(np.frombuffer(raw, np.uint8), stype, width)
        for limit in (1, 7, 64, 1000, 10 ** 6):
            got, want = PT._sample_stream(port_s, limit), ref_sample(ref_s, limit)
            assert got.content_bytes() == want.content_bytes()
            assert got.data.data_ptr() == port_s.data.data_ptr()  # a view, no copy


def test_the_seeds_and_cost_model_are_the_references():
    from _torch_train_ref import genome_tree
    from repro.training import trainer as ref_trainer

    for sig in [(2, 1), (2, 2), (2, 4), (2, 8), (0, 1), (1, 1), (1, 3), (1, 8), (3, 1)]:
        assert [genome_tree(g) for g in PT._seed_genomes(sig)] == [
            genome_tree(g) for g in ref_trainer._seed_genomes(sig)]
    assert PT.COST_NS_PER_BYTE == ref_trainer.COST_NS_PER_BYTE
    assert PT.COST_DEFAULT_NS_PER_BYTE == ref_trainer.COST_DEFAULT_NS_PER_BYTE
    assert PT.COST_NS_PER_NODE == ref_trainer.COST_NS_PER_NODE
    trace = [("huffman", 1000), ("unknown", 7), ("lzma_backend", 3), ("store", 0)]
    assert PT.trace_cost_seconds(trace) == ref_trainer.trace_cost_seconds(trace)
    assert PT.SAMPLE_LIMIT == ref_trainer.SAMPLE_LIMIT and PT.INVALID == ref_trainer.INVALID


# -------------------------------------------------------------- clustering
def _cluster_inputs():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 1 << 16, 4000).astype(np.uint32)
    other = rng.integers(0, 1 << 30, 4000).astype(np.uint32)
    return [
        ("identical", [base, base.copy(), other]),
        ("widths", [np.arange(100, dtype=np.uint32), np.arange(100, dtype=np.uint16)]),
        ("mixed", [base[:900], (base[:900] + 1).astype(np.uint32), np.arange(300, dtype=np.uint16),
                   np.arange(300, dtype=np.uint16) * 3, other[:500]]),
    ]


@pytest.mark.parametrize("index", range(3))
def test_cluster_streams_is_the_references(index):
    _name, arrays = _cluster_inputs()[index]
    clear_caches()
    got = P.cluster_streams([numeric(a) for a in arrays])
    with ref_device_trainer():
        want = RT.cluster_streams([ref_numeric(a) for a in arrays])
    assert got.clusters == want.clusters and got.sizes == want.sizes
    assert got.assignment() == want.assignment()


def test_a_probe_whose_pick_the_whole_stream_refuses_is_sized_as_the_references():
    """Huffman wins the probe's trial on the first 64 KiB and its cap fails on
    the whole stream: the reference's probe raises and sizes the stream as
    raw bytes + 64, its service scores a Huffman genome INVALID, and its
    clusters follow; the port's probes and evaluations, run as trials, give
    the same sizes, scores and clusters."""
    from repro.training import cluster as ref_cluster

    x = prefix_converges_whole_refuses()
    y = prefix_converges_whole_refuses(seed=1)
    small = np.random.default_rng(2).integers(0, 9, 1 << 14).astype(np.uint8)
    clear_caches()
    assert PC._size_of([serial(x.tobytes())], 5) == x.size + 64
    got = P.cluster_streams([serial(x.tobytes()), serial(y.tobytes()), serial(small.tobytes())])
    svc = P.TrainerService(workers=1, static_prune=False, device="cpu")
    try:
        got_score = svc.evaluate_genome(P.GNode("huffman"), serial(x.tobytes()), (0, 1))
    finally:
        svc.close()
    with ref_device_trainer():
        assert ref_cluster._size_of([ref_serial(x.tobytes())], 5) == x.size + 64
        want = RT.cluster_streams([ref_serial(b.tobytes()) for b in (x, y, small)])
        ref_svc = RT.TrainerService(workers=1)
        try:
            want_score = ref_svc.evaluate_genome(RT.GNode("huffman"), ref_serial(x.tobytes()), (0, 1))
        finally:
            ref_svc.close()
    assert got.clusters == want.clusters and got.sizes == want.sizes
    assert got_score == want_score == PT.INVALID


def test_clustering_merges_identical_streams_and_respects_signatures():
    _name, arrays = _cluster_inputs()[0]
    asn = P.cluster_streams([numeric(a) for a in arrays]).assignment()
    assert asn[0] == asn[1] and asn[2] != asn[0]
    _name, arrays = _cluster_inputs()[1]
    assert len(P.cluster_streams([numeric(a) for a in arrays]).clusters) == 2


def test_concat_streams_joins_on_the_device_and_keeps_string_lengths():
    a, b = strings([b"ab", b"", b"c"]), strings([b"de", b"f"])
    s = PC._concat_streams([a, b])
    assert s.content_bytes() == b"abcdef" and s.lengths.dtype == np.uint32
    assert s.lengths.tolist() == [2, 0, 1, 2, 1]
    x = numeric(np.array([1, 2], np.uint64))
    y = numeric(np.array([2 ** 64 - 1], np.uint64))
    j = PC._concat_streams([x, y])
    assert j.width == 8 and j.numpy().tolist() == [1, 2, 2 ** 64 - 1]
    assert PC._concat_streams([x]) is x


# -------------------------------------------------------------- fail closed
FAULT_POINT = "device.encode.cpu.huffman"


def test_an_injected_card_fault_propagates_out_of_train():
    blobs, fe, kw = _frontends(P)["struct"]
    plan = FaultPlan().at(FAULT_POINT)
    with plan.arm(all_threads=True), pytest.raises(InjectedDeviceFault):
        P.train([[serial(b)] for b in blobs], fe, workers=2, device="cpu", **kw)
    assert plan.fired and plan.fired[0][0] == FAULT_POINT


def test_an_injected_card_fault_propagates_out_of_cluster_streams():
    _name, arrays = _cluster_inputs()[0]
    plan = FaultPlan().at(FAULT_POINT)
    with plan.arm(all_threads=True), pytest.raises(InjectedDeviceFault):
        P.cluster_streams([numeric(a) for a in arrays])


def _kernel_fault(*_args, **_kw):
    raise ops.KernelError("delta_encode: the tensor is not where the kernel can read it")


def test_a_kernel_error_propagates_out_of_train(monkeypatch):
    monkeypatch.setattr(ops, "delta_encode", _kernel_fault)
    blobs, fe, kw = _frontends(P)["numeric_detected"]
    with pytest.raises(ops.KernelError):
        P.train([[serial(b)] for b in blobs], fe, workers=1, device="cpu", **kw)


def test_a_kernel_error_propagates_out_of_cluster_streams(monkeypatch):
    monkeypatch.setattr(ops, "delta_encode", _kernel_fault)
    _name, arrays = _cluster_inputs()[0]
    with pytest.raises(ops.KernelError):
        P.cluster_streams([numeric(a) for a in arrays], pool_map=P.TrainerService(
            workers=2, device="cpu").map)


def test_the_reference_scores_the_same_error_as_a_size_or_invalid(monkeypatch):
    """Where the port propagates, the reference goes on: its probe sizes the
    stream as raw bytes + 64 and its service scores the genome INVALID."""
    from _torch_train_ref import DeviceSession
    from repro.training import cluster as ref_cluster

    def boom(*_a, **_k):
        raise OSError("a device fault")

    s = ref_serial(np.arange(0, 4000, dtype=np.uint8).tobytes())
    with ref_device_trainer():
        monkeypatch.setattr(ref_cluster, "compress", boom)
        monkeypatch.setattr(DeviceSession, "compress_traced", boom)
        assert ref_cluster._size_of([s], 5) == s.nbytes + 64
        svc = RT.TrainerService(workers=1)
        try:
            got = svc.evaluate_genome(RT.GNode("huffman"), s, (0, 1))
        finally:
            svc.close()
    assert got == (float("inf"), float("inf"))
    with pytest.raises(InjectedDeviceFault):
        with FaultPlan().at(FAULT_POINT).arm():
            PC._size_of([serial(np.arange(0, 4000, dtype=np.uint8).tobytes())], 5)


def test_a_codecs_value_error_still_scores_invalid():
    svc = P.TrainerService(workers=1, static_prune=False, device="cpu")
    try:
        sample = numeric(np.array([0, 2 ** 63 + 5, 3], np.uint64))
        # range_pack refuses a range above 57 bits: a ValueError, so INVALID
        assert svc.evaluate_genome(P.GNode("range_pack"), sample, (2, 8)) == PT.INVALID
        # an ill-typed genome the analyzer would prune, here refused by the codec
        got = svc.evaluate_genome(P.GNode("delta"), strings([b"ab", b"c"]), (3, 1))
        assert got == PT.INVALID
        assert svc.stats["invalid"] == 2 and svc.stats["pruned_static"] == 0
        ok = svc.evaluate_genome(None, sample, (2, 8))
        assert ok[0] < float("inf")
    finally:
        svc.close()
    with pytest.raises(ValueError):
        P.TrainerService(workers=-1, device="cpu")


def test_the_service_and_train_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from repro_torch._device import NoCardError

    with pytest.raises(NoCardError):
        P.TrainerService(workers=1)
    with pytest.raises(NoCardError):
        P.train([[serial(_csv_blob())]], P.CsvFrontend(n_cols=3), pop_size=2, generations=0)


# ---------------------------------------------------------------- isolation
def test_the_training_modules_are_scanned_and_import_nothing_forbidden():
    import os
    import subprocess
    import sys

    import test_torch_isolation as iso

    port = REPO / "src" / "repro_torch"
    for rel in ("training/__init__.py", "training/nsga2.py", "training/gp.py",
                "training/cluster.py", "training/trainer.py", "codecs/parse.py"):
        assert port / rel in iso.PORT_FILES
        assert not set(iso._top_level_imports(port / rel)) & set(iso.FORBIDDEN)
    code = (
        "import sys, torch, repro_torch.training, repro_torch.cli\n"
        "from repro_torch.codecs.parse import sniff_csv\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad, torch.cuda.is_initialized())\n" % (iso.FORBIDDEN,)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"
