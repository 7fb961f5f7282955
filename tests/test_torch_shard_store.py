"""The port's compressed shard store (``repro_torch.data.shard_store``)
against the reference's, on the CPU, tolerance 0.

Mirrors the shard-store tests of ``tests/test_data_pipeline.py``: round trip,
rewrite, the rename-aside recovery, the age-gated stale sweep, orphan
entries, and each package reading the other's shards (the same entry files
and ``meta.json`` byte for byte).
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as ref_engine  # noqa: E402
from repro.data import CompressedShardStore as RefStore  # noqa: E402
from repro.data.synthetic import zipf_tokens  # noqa: E402
from repro_torch import _device  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import CompressedShardStore  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True)
def _empty_caches():
    ref_engine.resolve_cache_clear()
    engine.resolve_cache_clear()
    yield


def store(path):
    return CompressedShardStore(path, device=CPU)


def arange64(n):
    return torch.arange(n, dtype=torch.int64)


def shard_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": zipf_tokens(20_000, vocab=32000, seed=seed),
        "weights": rng.normal(0, 0.02, 3000).astype(np.float32),
        "mask": rng.random(777) > 0.5,
        "ids": rng.integers(0, 1 << 40, (40, 25)).astype(np.uint64),
    }


def test_roundtrip_and_ratio(tmp_path):
    s = store(tmp_path)
    toks = zipf_tokens(100_000, vocab=32000, seed=1)
    meta = s.write_shard(0, {"tokens": torch.from_numpy(toks)})
    assert meta["compressed_bytes"] < meta["raw_bytes"] * 0.7  # zipf compresses
    back = s.read_shard(0)
    assert back["tokens"].dtype == torch.int32 and np.array_equal(back["tokens"].numpy(), toks)
    assert s.stats()["ratio"] > 1.4


def test_corruption_detected(tmp_path):
    s = store(tmp_path)
    s.write_shard(0, {"x": arange64(1000)})
    f = tmp_path / "shard_000000" / "x.ozl"
    blob = bytearray(f.read_bytes())
    blob[10] ^= 0xFF
    f.write_bytes(bytes(blob))
    with pytest.raises((IOError, ValueError)):
        s.read_shard(0)


def test_rewrite_replaces_the_shard(tmp_path):
    s = store(tmp_path)
    s.write_shard(0, {"x": arange64(100)})
    meta = s.write_shard(0, {"y": arange64(50), "z": torch.ones(8)})
    assert [e["name"] for e in meta["entries"]] == ["y", "z"]
    back = s.read_shard(0)
    assert set(back) == {"y", "z"} and torch.equal(back["y"], arange64(50))
    assert not (tmp_path / "shard_000000" / "x.ozl").exists()
    assert s.shard_ids() == [0] and not list(tmp_path.glob("*.tmp"))


def test_stale_tmp_sweep_spares_a_live_writer(tmp_path):
    s = store(tmp_path)
    old = time.time() - s.STALE_TMP_SECONDS - 60
    legacy = tmp_path / "shard_000000.tmp"
    legacy.mkdir()
    (legacy / "orphan.ozl").write_bytes(b"stale bytes from a dead writer")
    stale = tmp_path / "shard_000000.abc123.tmp"
    stale.mkdir()
    (stale / "meta.json").write_text("{}")
    for d in (legacy, stale):
        os.utime(d, (old, old))
    live = tmp_path / "shard_000000.def456.tmp"  # a concurrent writer, now
    live.mkdir()
    meta = s.write_shard(0, {"tokens": arange64(64)})
    assert [e["name"] for e in meta["entries"]] == ["tokens"]
    assert set(s.read_shard(0)) == {"tokens"}
    assert not legacy.exists() and not stale.exists() and live.exists()
    assert s.shard_ids() == [0]


def test_crash_between_renames_recovers_from_the_aside(tmp_path):
    s = store(tmp_path)
    s.write_shard(0, {"a": arange64(20)})
    final = tmp_path / "shard_000000"
    aside = tmp_path / "shard_000000.old.crash.tmp"
    os.replace(final, aside)  # as a crash after the rename aside leaves it
    old = time.time() - s.STALE_TMP_SECONDS - 60
    os.utime(aside, (old, old))
    assert s._stale_tmps(0) == []  # never swept while the canonical dir is missing
    back = s.read_shard(0)
    assert torch.equal(back["a"], arange64(20))
    assert final.exists() and not aside.exists()
    os.replace(final, aside)
    s.write_shard(0, {"b": arange64(3)})  # a write promotes it too, then rewrites
    assert set(s.read_shard(0)) == {"b"} and not list(tmp_path.glob("*.tmp"))


def test_newest_aside_wins(tmp_path):
    s = store(tmp_path)
    s.write_shard(0, {"a": arange64(20)})
    final = tmp_path / "shard_000000"
    keep = tmp_path / "shard_000000.old.keep.tmp"
    os.replace(final, keep)
    older = tmp_path / "shard_000000.old.older.tmp"
    older.mkdir()
    now = time.time()
    os.utime(older, (now - 100, now - 100))
    assert torch.equal(s.read_shard(0)["a"], arange64(20))
    assert not keep.exists() and older.exists()


def test_read_ignores_orphan_entries(tmp_path):
    s = store(tmp_path)
    s.write_shard(3, {"a": arange64(10)})
    (tmp_path / "shard_000003" / "rogue.ozl").write_bytes(b"not in meta")
    assert set(s.read_shard(3)) == {"a"}
    assert s.stats()["raw_bytes"] == 80


def _torch_arrays(arrays):
    return {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}


@pytest.mark.parametrize("seed", (0, 1))
def test_each_package_reads_the_others_shards(tmp_path, seed):
    arrays = shard_arrays(seed)
    ref = RefStore(tmp_path / "ref")
    ref.write_shard(seed, arrays)
    ref_engine.resolve_cache_clear()
    engine.resolve_cache_clear()
    port = store(tmp_path / "port")
    port.write_shard(seed, _torch_arrays(arrays))
    d_ref = tmp_path / "ref" / f"shard_{seed:06d}"
    d_port = tmp_path / "port" / f"shard_{seed:06d}"
    names = sorted(p.name for p in d_ref.iterdir())
    assert names == sorted(p.name for p in d_port.iterdir())
    for name in names:  # the entries and meta.json, byte for byte
        assert (d_ref / name).read_bytes() == (d_port / name).read_bytes(), name
    got = store(tmp_path / "ref").read_shard(seed)
    back = RefStore(tmp_path / "port").read_shard(seed)
    for k, a in arrays.items():
        assert got[k].dtype == _torch_arrays({k: a})[k].dtype
        assert np.array_equal(got[k].numpy(), a) and np.array_equal(back[k], a)
    assert store(tmp_path / "ref").stats() == RefStore(tmp_path / "port").stats()
    assert port.shard_ids() == ref.shard_ids() == [seed]


def test_store_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(_device.NoCardError):
        CompressedShardStore(tmp_path)
