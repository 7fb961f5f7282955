"""The port's LM drivers and what they stand on, against the reference.

Optimizers: ``adamw``, ``adafactor`` and ``sgd`` over three steps on one
numpy tree (float32 leaves stacked, flat and 1-D, and a bfloat16 leaf);
params and every state leaf within 1e-6 absolute + 1e-5 relative in float32,
and within one bfloat16 step (2^-8 relative) for bfloat16 leaves.
Synthetic data and batches: equal bit for bit.  The Prefetcher: the
reference's three tests.  The drivers: the reference's step-2 checkpoint is
resumed by both drivers to step 4 with params within 1e-4 and printed
losses within 2e-4 (they are printed to 1e-4; each package cuts the same
batches from the same shards); the port's serve
child loads the port's step 4; without a card both drivers raise
``NoCardError`` and write nothing; a ``--steps`` that is a multiple of
``--save-interval`` raises the same ``OSError`` in both (a fault of the
reference, kept) and leaves that step restorable.
"""
import contextlib
import errno
import io
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.distributed import optimizer as ref_opt  # noqa: E402
from repro.distributed.checkpoint import restore_checkpoint as ref_restore  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402

from repro_torch import _device  # noqa: E402
from repro_torch.data import CompressedShardStore, Prefetcher, Straggler  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.distributed import optimizer as opt  # noqa: E402
from repro_torch.distributed.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
F32_ATOL, F32_RTOL = 1e-6, 1e-5
BF16_RTOL = 2.0 ** -8
RESUME_ATOL = 1e-4
PRINTED_LOSS_ATOL = 2e-4  # the drivers print losses to 1e-4
BASE_FLAGS = ["--reduced", "--log-every", "1"]


# ------------------------------------------------------------- optimizers
def _tree(rng):
    return {
        "embed": rng.normal(0, 0.02, (10, 6)).astype(np.float32),
        "layers": {"w": rng.normal(0, 0.2, (2, 6, 4)).astype(np.float32),
                   "norm": np.ones((2, 6), np.float32)},
        "bias": rng.normal(0, 0.1, (4,)).astype(np.float32),
        "half": rng.normal(0, 0.2, (8, 4)).astype(np.float32),  # bfloat16 on both sides
    }


def _as_ref(tree):
    return {k: _as_ref(v) if isinstance(v, dict) else
            jnp.asarray(v, jnp.bfloat16 if k == "half" else jnp.float32) for k, v in tree.items()}


def _as_port(tree):
    return {k: _as_port(v) if isinstance(v, dict) else
            torch.from_numpy(v).to(torch.bfloat16 if k == "half" else torch.float32)
            for k, v in tree.items()}


def _pairs(got, want, path=""):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for k in got:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    else:
        yield path, got, want


def _assert_trees_close(got, want):
    for path, g, w in _pairs(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        if str(w.dtype) == "bfloat16" or "half" in path:
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-30, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=F32_ATOL, err_msg=path)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_matches_reference_over_three_steps(name):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    ref, mine = getattr(ref_opt, name)(), getattr(opt, name)()
    rp, pp = _as_ref(tree), _as_port(tree)
    rs, ps = ref.init(rp), mine.init(pp)
    _assert_trees_close(ps, rs)
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.normal(0, 0.5, x.shape).astype(np.float32), tree)
        rp, rs = ref.update(_as_ref(grads), rs, rp)
        pp, ps = mine.update(_as_port(grads), ps, pp)
        _assert_trees_close(pp, rp)
        _assert_trees_close(ps, rs)
    assert int(ps["count"]) == 3 and ps["count"].dtype == torch.int32


def test_adamw_keeps_m_in_bfloat16_only_for_bfloat16_params():
    tree = _as_port(_tree(np.random.default_rng(1)))
    adam = opt.adamw()
    params, state = adam.update(opt.tree_map(torch.ones_like, tree), adam.init(tree), tree)
    assert state["m"]["half"].dtype == torch.bfloat16 and params["half"].dtype == torch.bfloat16
    assert state["m"]["embed"].dtype == torch.float32
    assert state["v"]["half"].dtype == torch.float32


def test_update_leaves_its_inputs_alone():
    tree = _as_port(_tree(np.random.default_rng(2)))
    before = opt.tree_map(torch.clone, tree)
    adam = opt.adamw()
    state = adam.init(tree)
    adam.update(opt.tree_map(torch.ones_like, tree), state, tree)
    for _p, a, b in _pairs(tree, before):
        assert torch.equal(a, b)
    assert int(state["count"]) == 0


def test_for_arch_picks_the_references_optimizer():
    for arch in ("llama3.2-1b", "olmoe-1b-7b", "kimi-k2-1t-a32b"):
        assert opt.for_arch("lm", arch).name == ref_opt.for_arch("lm", arch).name


# ------------------------------------------------------------- synthetic data
@pytest.mark.parametrize("seed", [0, 3])
def test_zipf_tokens_equal_the_references(seed):
    got = synthetic.zipf_tokens(50_000, 32000, seed=seed)
    want = ref_synthetic.zipf_tokens(50_000, 32000, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_generators_equal_the_references():
    toks = synthetic.zipf_tokens(5000, 256, seed=1)
    for a, b in zip([next(synthetic.lm_batches(toks, 4, 16, seed=2)),
                     next(synthetic.recsys_ctr_batches(8, 5, 1000, seed=3)),
                     synthetic.random_graph(100, 400, 8, 4, seed=4)],
                    [next(ref_synthetic.lm_batches(toks, 4, 16, seed=2)),
                     next(ref_synthetic.recsys_ctr_batches(8, 5, 1000, seed=3)),
                     ref_synthetic.random_graph(100, 400, 8, 4, seed=4)]):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_batches_from_shard_equal_the_references():
    toks = synthetic.zipf_tokens(8 * 65 * 4, 256, seed=0)
    got_rng, want_rng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(3):
        got = train.batches_from_shard({"tokens": torch.from_numpy(toks)}, 8, 64, got_rng)
        want = ref_train.batches_from_shard({"tokens": toks}, 8, 64, want_rng)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), want[k])


# ------------------------------------------------------------- the Prefetcher
def test_prefetcher_orders_and_resumes(tmp_path):
    store = CompressedShardStore(tmp_path, device="cpu")
    for i in range(4):
        store.write_shard(i, {"x": torch.full((10,), i, dtype=torch.int64)})
    pf = Prefetcher(store.read_shard, store.shard_ids(), start_cursor=2)
    try:
        first = pf.next(timeout=10)
        assert first["shard"] == 2  # resumed at the checkpointed cursor
        assert torch.equal(first["data"]["x"], torch.full((10,), 2, dtype=torch.int64))
        second = pf.next(timeout=10)
        assert second["shard"] == 3
        third = pf.next(timeout=10)
        assert third["shard"] == 0  # wraps to next epoch
    finally:
        pf.stop()


def test_prefetcher_straggler_timeout():
    def slow_load(idx):
        time.sleep(5.0)
        return idx

    pf = Prefetcher(slow_load, [0, 1], depth=1)
    try:
        with pytest.raises(Straggler):
            pf.next(timeout=0.2)
    finally:
        pf.stop()


def test_prefetcher_skips_damaged_shard():
    def load(idx):
        if idx == 1:
            raise IOError("corrupt")
        return idx

    pf = Prefetcher(load, [0, 1, 2])
    try:
        got = [pf.next(timeout=10)["shard"] for _ in range(3)]
        assert 1 not in got[:2]
        assert 1 in pf.state()["skipped"]
    finally:
        pf.stop()


# ------------------------------------------------------------- the drivers
def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _dirs(root):
    return ["--ckpt-dir", str(root / "ckpt"), "--data-dir", str(root / "data")]


def _losses(text):
    return {int(s): float(v) for s, v in re.findall(r"^step\s+(\d+) loss (\S+)", text, re.M)}


@pytest.fixture(scope="module")
def step2(tmp_path_factory):
    """The reference's run to step 2 (one save, at the end)."""
    root = tmp_path_factory.mktemp("ref-step2")
    rc, out = _run(ref_train.main, BASE_FLAGS + ["--steps", "2", "--save-interval", "100"]
                   + _dirs(root))
    assert rc == 0, out
    return root


def test_both_drivers_resume_the_references_checkpoint_alike(step2, tmp_path):
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    for root in (ref_root, port_root):
        shutil.copytree(step2, root)
    flags = BASE_FLAGS + ["--steps", "4", "--save-interval", "100"]
    rc, ref_out = _run(ref_train.main, flags + _dirs(ref_root))
    assert rc == 0, ref_out
    rc, port_out = _run(train.main, flags + ["--device", "cpu"] + _dirs(port_root))
    assert rc == 0, port_out
    resumed = re.search(r"\[resume\] restored step 2 .* data cursor (\d+)", port_out)
    assert resumed, port_out
    assert resumed.group(0).split(")")[-1] == re.search(
        r"\[resume\] restored step 2 .* data cursor (\d+)", ref_out).group(0).split(")")[-1]
    ref_losses, port_losses = _losses(ref_out), _losses(port_out)
    assert sorted(port_losses) == sorted(ref_losses) == [3, 4]
    for s in (3, 4):
        assert abs(port_losses[s] - ref_losses[s]) < PRINTED_LOSS_ATOL, (s, port_losses,
                                                                         ref_losses)
    want, want_m = ref_restore(ref_root / "ckpt", 4)
    got, got_m = restore_checkpoint(port_root / "ckpt", 4, device="cpu")
    assert sorted(got) == sorted(want)
    assert got_m["metadata"] == want_m["metadata"]
    for key, w in want.items():
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_allclose(g, w, atol=RESUME_ATOL, rtol=0, err_msg=key)


def test_serve_child_loads_the_ports_checkpoint(step2, tmp_path):
    root = tmp_path / "port"
    shutil.copytree(step2, root)
    rc, out = _run(train.main, BASE_FLAGS + ["--steps", "4", "--save-interval", "100",
                                             "--device", "cpu"] + _dirs(root))
    assert rc == 0, out
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    child = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced", "--device", "cpu",
         "--ckpt-dir", str(root / "ckpt"), "--batch", "2", "--prompt-len", "8", "--gen", "8"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert child.returncode == 0, child.stderr
    assert "[serve] loaded checkpoint step 4" in child.stdout
    assert re.search(r"decode:\s+14 tokens in", child.stdout), child.stdout
    assert "kv-cache:" in child.stdout


def test_fail_at_step_exits_42_and_the_rerun_resumes(step2, tmp_path):
    root = tmp_path / "port"
    shutil.copytree(step2, root)
    flags = BASE_FLAGS + ["--steps", "4", "--save-interval", "3", "--device", "cpu"]
    rc, out = _run(train.main, flags + ["--fail-at-step", "4"] + _dirs(root))
    assert rc == 42 and "[failure-sim] crashing at step 4" in out and "saved step 3" in out
    rc, out = _run(train.main, flags + _dirs(root))
    assert rc == 0 and "[resume] restored step 3" in out and "[done] 4 steps" in out


@pytest.mark.parametrize("which", ["train", "serve"])
def test_driver_without_a_card_raises_and_writes_nothing(which, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "dirs"
    root.mkdir()
    argv = ["--reduced", "--ckpt-dir", str(root / "ckpt")]
    if which == "train":
        argv += ["--data-dir", str(root / "data"), "--steps", "1"]
    with pytest.raises(_device.NoCardError):
        (train if which == "train" else serve).main(argv)
    assert list(root.iterdir()) == []


def test_saving_the_last_step_twice_raises_in_both_packages(step2, tmp_path):
    """``--steps 3 --save-interval 3``: the loop saves step 3, the final save
    saves it again and its ``os.replace`` onto the published directory
    fails (a fault of the reference, kept); step 3 stays restorable."""
    flags = BASE_FLAGS + ["--steps", "3", "--save-interval", "3"]
    raised = {}
    for name, main, extra in (("ref", ref_train.main, []),
                              ("port", train.main, ["--device", "cpu"])):
        root = tmp_path / name
        shutil.copytree(step2, root)
        with pytest.raises(OSError) as err:
            _run(main, flags + extra + _dirs(root))
        raised[name] = err.value.errno
        assert sorted(p.name for p in (root / "ckpt").iterdir() if not p.name.endswith(".tmp")
                      ) == ["step_0000000002", "step_0000000003"]
    assert raised["ref"] == raised["port"] == errno.ENOTEMPTY
    want, _ = ref_restore(tmp_path / "ref" / "ckpt", 3)
    got, _ = restore_checkpoint(tmp_path / "port" / "ckpt", 3, device="cpu")
    assert sorted(got) == sorted(want)
    mine, _ = ref_restore(tmp_path / "port" / "ckpt", 3)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), mine[key])
