"""The checkpoint leaf path and its manager against the reference, on the CPU,
tolerance 0.

Mirrors ``tests/test_checkpoint.py``.  Every dtype route's leaf frame of the
port (``device="cpu"``) is held byte for byte against the reference's
``compress_leaf`` on the same numpy values (bfloat16 through ``ml_dtypes`` on
the reference's side only); trees flatten in JAX's order with JAX's keys;
checkpoint directories written by either package are restored by the other;
and the manager's keep-K, resume and async snapshot hold.  Both packages'
resolve caches are emptied before every test and every cross-package save.
"""
import collections
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

import repro_torch  # noqa: E402
from repro.configs.llama3_2_1b import SPEC as LLAMA  # noqa: E402
from repro.core import compress as ref_compress  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import numeric as ref_numeric  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.distributed import checkpoint as rck  # noqa: E402
from repro.models.transformer import init_params  # noqa: E402
from repro_torch import _device  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.message import Stream  # noqa: E402
from repro_torch.distributed import checkpoint as tck  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from _torch_huffman_cap import prefix_converges_whole_refuses  # noqa: E402

CPU = "cpu"


def _clear():
    ref_engine.resolve_cache_clear()
    engine.resolve_cache_clear()


@pytest.fixture(autouse=True)
def _fresh():
    _clear()
    yield
    tck.set_checkpoint_plan("*", None)
    rck.set_checkpoint_plan("*", None)
    for name in ("uint8", "int32", "float32"):
        tck.set_checkpoint_plan(name, None)
        rck.set_checkpoint_plan(name, None)


def to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a private, writable, contiguous copy
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def same(t: torch.Tensor, a: np.ndarray) -> bool:
    """Bit-exact: dtype name, shape and bytes."""
    return (
        tck.dtype_name(t.dtype) == str(a.dtype)
        and tuple(t.shape) == a.shape
        and to_numpy(t.contiguous()).tobytes() == np.ascontiguousarray(a).tobytes()
    )


def route_arrays(seed: int = 0, n: int = 1500):
    """One array per dtype route, with values each route's codecs act on."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.02, n)
    return {
        "float32": w.astype(np.float32),
        "float64": w,
        "bfloat16": w.astype(ml_dtypes.bfloat16),
        "float16": w.astype(np.float16),
        "int8": rng.integers(-128, 128, n).astype(np.int8),
        "uint8": np.clip(rng.normal(7.5, 2.5, n), 0, 15).astype(np.uint8),
        "bool": rng.random(n) > 0.3,
        "int16": rng.integers(-3000, 3000, n).astype(np.int16),
        "uint16": rng.integers(0, 1 << 12, n).astype(np.uint16),
        "int32": rng.integers(0, 40, n).cumsum().astype(np.int32),
        "uint32": rng.zipf(1.3, n).astype(np.uint32),
        "int64": (1_700_000_000_000 + rng.integers(900, 1100, n).cumsum()).astype(np.int64),
        "uint64": rng.integers(0, 1 << 40, n).astype(np.uint64),
    }


ROUTES = tuple(route_arrays())


# --------------------------------------------------------------- leaf codec
@pytest.mark.parametrize("name", ROUTES)
@pytest.mark.parametrize("shape", [(1500,), (30, 50)])
def test_leaf_frame_equals_reference(name, shape):
    a = route_arrays()[name].reshape(shape)
    want = rck.compress_leaf(a)
    got = tck.compress_leaf(to_torch(a), device=CPU)
    assert got == want
    back = tck.decompress_leaf(want, shape, name, device=CPU)
    assert same(back, a)
    assert np.array_equal(rck.decompress_leaf(got, shape, name).view(np.uint8), a.view(np.uint8))


@pytest.mark.parametrize("name", ("float32", "bfloat16", "int64", "bool"))
def test_non_contiguous_leaf_equals_reference(name):
    a = route_arrays()[name].reshape(30, 50)
    t = to_torch(np.ascontiguousarray(a.T)).t()  # a's values, transposed strides
    assert not t.is_contiguous()
    assert tck.compress_leaf(t, device=CPU) == rck.compress_leaf(a)


def test_zero_dim_and_empty_leaves_equal_reference():
    for a in (np.float32(3.5).reshape(()), np.int32(7).reshape(()), np.zeros(0, np.float32)):
        _clear()
        want = rck.compress_leaf(a)
        assert tck.compress_leaf(to_torch(a), device=CPU) == want
        assert same(tck.decompress_leaf(want, a.shape, str(a.dtype), device=CPU), a)


def test_dtype_without_route_raises_type_error():
    with pytest.raises(TypeError):
        rck.compress_leaf(np.zeros(4, np.complex64))
    with pytest.raises(TypeError):
        tck.compress_leaf(torch.zeros(4, dtype=torch.complex64), device=CPU)
    with pytest.raises(TypeError):
        tck.decompress_leaf(b"", (4,), "complex64", device=CPU)
    assert tck.dtype_name(torch.bfloat16) == "bfloat16"
    assert tck.dtype_name("int64") == "int64"


def test_decompress_leaf_fails_closed_on_a_wrong_size():
    a = route_arrays()["float32"]
    frame = rck.compress_leaf(a)
    with pytest.raises(ValueError):
        tck.decompress_leaf(frame, (a.size + 1,), "float32", device=CPU)
    with pytest.raises(ValueError):
        tck.decompress_leaf(frame, (a.size,), "float64", device=CPU)


def test_bool_leaf_restores_nonzero_bytes_as_true():
    frame = rck.compress_leaf(np.array([0, 1, 2, 255], np.uint8))
    back = tck.decompress_leaf(frame, (4,), "bool", device=CPU)
    assert back.dtype == torch.bool and back.tolist() == [False, True, True, True]


# ------------------------------------------------------------- tree order
def _x(i):
    return np.full(3, i, np.float32)


def _trees():
    od = collections.OrderedDict([("z", _x(3)), ("y", _x(4))])
    sd = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.LayerNorm(2)).state_dict()
    return {
        "mixed": {"b": [_x(0), (_x(1), None)], "a": {"x": _x(2)}, "od": od},
        "state_dict": {k: v.detach().numpy() for k, v in sd.items()},
        "state_dict_ordered": collections.OrderedDict(
            (k, v.detach().numpy()) for k, v in sd.items()),
        "list": [_x(0), [_x(1), _x(2)], ()],
        "tuple": (_x(0), None, {"k": _x(1)}),
        "int_keys": {10: _x(0), 2: _x(1)},
        "nested_od": {"m": collections.OrderedDict([("b", {"z": _x(0), "a": _x(1)}),
                                                    ("a", [None, _x(2)])])},
        "leaf": _x(5),
        "none": {"a": None, "b": []},
    }


def _torch_tree(tree):
    if isinstance(tree, np.ndarray):
        return to_torch(tree)
    if type(tree) is collections.OrderedDict:
        return collections.OrderedDict((k, _torch_tree(v)) for k, v in tree.items())
    if type(tree) is dict:
        return {k: _torch_tree(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_torch_tree(v) for v in tree)
    return tree


@pytest.mark.parametrize("name", tuple(_trees()))
def test_tree_keys_and_order_match_jax(name):
    tree = _trees()[name]
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [(rck._leaf_key(path), leaf) for path, leaf in flat]
    got = tck.flatten_tree(_torch_tree(tree))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(same(t, a) for (_, t), (_, a) in zip(got, want))


def test_state_dict_keeps_insertion_order():
    sd = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.LayerNorm(2)).state_dict()
    assert [k for k, _ in tck.flatten_tree(sd)] == list(sd)
    assert list(sd) != sorted(sd)


def test_unsortable_dict_keys_raise_in_both():
    with pytest.raises(ValueError):
        jax.tree_util.tree_flatten_with_path({1: _x(0), "a": _x(1)})
    with pytest.raises(ValueError):
        tck.flatten_tree({1: torch.zeros(1), "a": torch.zeros(1)})


def test_non_tensor_leaf_raises_type_error():
    with pytest.raises(TypeError):
        tck.flatten_tree({"a": 3})


def test_restore_rebuilds_the_containers(tmp_path):
    tree = _torch_tree(_trees()["nested_od"])
    tree["t"] = (torch.ones(2), None, [torch.zeros(1, dtype=torch.int64)])
    tck.save_checkpoint(tmp_path, 1, tree, device=CPU)
    back, _ = tck.restore_tree(tmp_path, tree, 1, device=CPU)
    assert type(back["m"]) is collections.OrderedDict and list(back["m"]) == ["b", "a"]
    assert list(back["m"]["b"]) == ["a", "z"]  # a dict comes back sorted, as from JAX
    assert back["m"]["a"][0] is None and type(back["t"]) is tuple and back["t"][1] is None
    for (k1, a), (k2, b) in zip(tck.flatten_tree(tree), tck.flatten_tree(back)):
        assert k1 == k2 and torch.equal(a, b)


# ------------------------------------------------------ cross-package dirs
def llama_tree(dtype: str = "float32"):
    """The reduced llama3.2-1b parameter tree from the reference's
    ``init_params`` (its config's float32, or bfloat16 as a serving
    checkpoint holds it), as numpy (ml_dtypes bfloat16) leaves."""
    cfg = dataclasses.replace(LLAMA.reduced_cfg, dtype=getattr(jax.numpy, dtype))
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))


def _manifest(d):
    m = json.loads((d / "manifest.json").read_text())
    return {k: v for k, v in m.items() if k not in ("created", "save_seconds")}


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("writer", ("port", "reference"))
def test_llama_checkpoint_restores_across_packages(tmp_path, writer, dtype):
    tree = llama_tree(dtype)
    assert {a.dtype.name for a in jax.tree.leaves(tree)} == {dtype}
    ttree = _torch_tree(tree)
    _clear()
    rck.save_checkpoint(tmp_path / "ref", 3, tree, metadata={"arch": "llama3.2-1b"})
    _clear()
    tck.save_checkpoint(tmp_path / "port", 3, ttree, metadata={"arch": "llama3.2-1b"},
                        device=CPU)
    ref_dir, port_dir = tmp_path / "ref" / "step_0000000003", tmp_path / "port" / "step_0000000003"
    assert _manifest(ref_dir) == _manifest(port_dir)
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    assert len(names) == len(jax.tree.leaves(tree)) + 1
    for name in names[:-1]:  # the leaf files; the manifests are compared above
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    if writer == "port":
        back, manifest = rck.restore_tree(tmp_path / "port", tree, 3)
        flat = jax.tree_util.tree_flatten_with_path(back)[0]
        for (path, got), (_, want) in zip(flat, jax.tree_util.tree_flatten_with_path(tree)[0]):
            assert got.dtype == want.dtype and np.array_equal(
                got.view(np.uint8), want.view(np.uint8)), rck._leaf_key(path)
    else:
        back, manifest = tck.restore_tree(tmp_path / "ref", ttree, 3, device=CPU)
        for (k, got), (_, want) in zip(tck.flatten_tree(back), tck.flatten_tree(ttree)):
            assert got.dtype == want.dtype and torch.equal(got, want), k
    assert manifest["metadata"] == {"arch": "llama3.2-1b"}
    assert tck.latest_step(tmp_path / "ref") == rck.latest_step(tmp_path / "port") == 3


def test_route_tree_restores_across_packages(tmp_path):
    arrays = route_arrays(1)
    rck.save_checkpoint(tmp_path / "ref", 1, arrays)
    _clear()
    tck.save_checkpoint(tmp_path / "port", 1, {k: to_torch(a) for k, a in arrays.items()},
                        device=CPU)
    got, _ = tck.restore_checkpoint(tmp_path / "ref", device=CPU)
    assert set(got) == set(arrays) and all(same(got[k], arrays[k]) for k in arrays)
    back, _ = rck.restore_checkpoint(tmp_path / "port")
    assert all(back[k].dtype == arrays[k].dtype
               and back[k].tobytes() == arrays[k].tobytes() for k in arrays)
    m_ref, m_port = _manifest(tmp_path / "ref" / "step_0000000001"), _manifest(
        tmp_path / "port" / "step_0000000001")
    assert m_ref == m_port
    assert {leaf["dtype"] for leaf in m_port["leaves"]} == set(ROUTES)


# ----------------------------------------------------- durability, manager
def small_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": to_torch(rng.normal(size=(64, 32)).astype(np.float32)),
            "emb": to_torch(rng.normal(size=(100, 16)).astype(np.float32)),
            "steps": torch.arange(50, dtype=torch.int32),
        },
        "opt": {"m": to_torch(rng.normal(size=(64, 32)).astype(np.float32)),
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def tree_eq(a, b):
    fa, fb = tck.flatten_tree(a), tck.flatten_tree(b)
    return len(fa) == len(fb) and all(
        ka == kb and x.dtype == y.dtype and torch.equal(x, y) for (ka, x), (kb, y) in zip(fa, fb))


def test_save_restore_roundtrip(tmp_path):
    tree = small_tree()
    m = tck.save_checkpoint(tmp_path, 10, tree, device=CPU)
    assert m["ratio"] > 1.0
    restored, manifest = tck.restore_tree(tmp_path, tree, 10, device=CPU)
    assert tree_eq(tree, restored) and manifest["step"] == 10


def test_atomicity_no_tmp_visible(tmp_path):
    tck.save_checkpoint(tmp_path, 5, small_tree(), device=CPU)
    assert not list(tmp_path.glob("*.tmp"))
    assert tck.latest_step(tmp_path) == 5


def test_partial_checkpoint_ignored(tmp_path):
    tck.save_checkpoint(tmp_path, 5, small_tree(), device=CPU)
    tck.save_checkpoint(tmp_path, 10, small_tree(), device=CPU)
    next((tmp_path / "step_0000000010").glob("leaf_*.ozl")).unlink()
    assert tck.latest_step(tmp_path) == 5
    (tmp_path / "step_0000000020.tmp").mkdir()  # a crashed writer's staging
    assert tck.latest_step(tmp_path) == 5
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(tmp_path, 10, device=CPU)


def test_crc_detects_bitrot(tmp_path):
    tck.save_checkpoint(tmp_path, 5, small_tree(), device=CPU)
    victim = next((tmp_path / "step_0000000005").glob("leaf_*.ozl"))
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    victim.write_bytes(bytes(blob))
    with pytest.raises(IOError, match="crc"):
        tck.restore_checkpoint(tmp_path, 5, device=CPU)
    with pytest.raises((IOError, ValueError)):
        tck.restore_checkpoint(tmp_path, 5, device=CPU, verify_crc=False)


def test_manager_keep_k_and_resume(tmp_path):
    tree = small_tree()
    mgr = tck.CheckpointManager(tmp_path, save_interval=10, keep=2, device=CPU)
    assert mgr.restore_or_none(tree) is None
    assert mgr.should_save(20) and not mgr.should_save(15) and not mgr.should_save(0)
    for step in (10, 20, 30):
        mgr.save(step, small_tree(step))
    mgr.wait()
    steps = sorted(d.name for d in tmp_path.iterdir() if d.name.startswith("step_"))
    assert steps == ["step_0000000020", "step_0000000030"]
    step, back, manifest = tck.CheckpointManager(tmp_path, device=CPU).restore_or_none(tree)
    assert step == 30 and manifest["step"] == 30 and tree_eq(back, small_tree(30))
    assert [m["step"] for m in mgr.history] == [10, 20, 30]


def test_async_save_then_in_place_update_keeps_the_saved_values(tmp_path):
    tree = small_tree()
    want = tck._tree_map(lambda _k, t: t.clone(), tree)
    mgr = tck.CheckpointManager(tmp_path, async_save=True, device=CPU)
    mgr.save(7, tree)
    for _k, t in tck.flatten_tree(tree):
        t.neg_() if t.is_floating_point() else t.add_(1)  # the next train step
    mgr.wait()
    assert mgr.latest_step() == 7
    _, back, _ = mgr.restore_or_none(tree)
    assert tree_eq(back, want) and not tree_eq(back, tree)


def test_async_save_error_is_raised_by_wait(tmp_path):
    from repro_torch.reliability import FaultPlan, InjectedFault

    mgr = tck.CheckpointManager(tmp_path, async_save=True, device=CPU)
    with FaultPlan().at("ckpt.manifest").arm(all_threads=True):
        mgr.save(3, small_tree())
        with pytest.raises(InjectedFault):
            mgr.wait()
    mgr.wait()  # raised once
    assert mgr.latest_step() is None


@pytest.mark.parametrize("src,dst", [("float32", "bfloat16"), ("float32", "float64"),
                                     ("int64", "int32"), ("float64", "float16"),
                                     ("bool", "int8")])
def test_restore_tree_casts_like_the_reference(tmp_path, src, dst):
    a = route_arrays()[src]
    rck.save_checkpoint(tmp_path, 1, {"a": a})
    want = rck.restore_tree(tmp_path, {"a": np.zeros(a.shape, ml_dtypes.bfloat16
                                                     if dst == "bfloat16" else dst)}, 1)[0]["a"]
    like = {"a": torch.empty(a.shape, dtype=tck._DTYPES[dst], device="meta")}
    got = tck.restore_tree(tmp_path, like, 1, device=CPU)[0]["a"]
    assert got.device.type == CPU and same(got, want)


def test_restore_tree_missing_leaf_raises(tmp_path):
    tck.save_checkpoint(tmp_path, 1, {"a": torch.zeros(3)}, device=CPU)
    with pytest.raises(KeyError):
        tck.restore_tree(tmp_path, {"b": torch.zeros(3)}, 1, device=CPU)


# ------------------------------------------------------ sessions, overrides
def test_a_leaf_whose_exponents_refuse_the_trials_pick_still_saves(tmp_path):
    """float32 weights whose exponent plane's prefix picks Huffman while the
    whole plane's counts refuse it (as an optimizer state leaf's did at
    Llama-3.2-1B's full width): the reference's save raises, the port's
    codes the plane with Huffman lengths under the cap from package-merge,
    and the leaf restores bit for bit in both packages."""
    exps = prefix_converges_whole_refuses().astype(np.uint32)
    mant = np.random.default_rng(1).integers(0, 1 << 23, exps.size, dtype=np.uint32)
    w = ((exps << np.uint32(23)) | mant).view(np.float32)
    with pytest.raises(AssertionError, match="length cap"):
        rck.compress_leaf(w)
    frame = tck.compress_leaf(torch.from_numpy(w), device=CPU)
    got = tck.decompress_leaf(frame, w.shape, "float32", device=CPU)
    assert torch.equal(got.view(torch.int32), torch.from_numpy(w.view(np.int32)))
    np.testing.assert_array_equal(rck.decompress_leaf(frame, w.shape, "float32").view(np.int32),
                                  w.view(np.int32))
    tck.save_checkpoint(tmp_path, 1, {"w": torch.from_numpy(w)}, device=CPU)
    leaves, _ = rck.restore_checkpoint(tmp_path, 1)
    np.testing.assert_array_equal(leaves["w"].view(np.int32), w.view(np.int32))


def test_session_registry_is_keyed_by_plan_and_device():
    tck.close_codec_sessions()
    arrays = route_arrays()
    for name in ("float32", "float32", "int64", "int32", "uint8"):
        tck.compress_leaf(to_torch(arrays[name]), device=CPU)
    keys = list(tck._ENC_SESSIONS)
    assert all(dev == torch.device(CPU) for _plan, dev in keys)
    # float32_profile; numeric_profile for both int64 and int32; zlib_backend
    assert len(keys) == 3
    assert keys[0][0] == repro_torch.float32_profile()
    frame = tck.compress_leaf(to_torch(arrays["float32"]), device=CPU)
    tck.decompress_leaf(frame, (1500,), "float32", device=CPU)
    tck.decompress_leaf(frame, (1500,), "float32", device=CPU)
    assert list(tck._DEC_SESSIONS) == [torch.device(CPU)]
    stats = tck.codec_session_stats()
    assert stats["enc_plans"] == 3 and stats["enc_calls"] == 6 and stats["dec_calls"] == 2
    assert stats["dec_bytes_out"] == 2 * 1500 * 4
    tck.close_codec_sessions()
    assert tck.codec_session_stats()["enc_plans"] == 0


def test_override_plan_that_refuses_numeric_is_retried_as_serial():
    text = np.frombuffer(b"".join(b"%d\t%d\n" % (i, 3 * i + 1) for i in range(400)), np.uint8)
    rck.set_checkpoint_plan("uint8", ref_pipeline("edge_list"))
    tck.set_checkpoint_plan("uint8", repro_torch.pipeline("edge_list"))
    want = rck.compress_leaf(text)
    got = tck.compress_leaf(to_torch(text), device=CPU)
    assert got == want
    assert same(tck.decompress_leaf(got, text.shape, "uint8", device=CPU), text)


def test_override_plan_that_fuses_matches_the_device_backend():
    a = route_arrays()["uint32"]
    plan = ("delta", "bitpack")
    tck.set_checkpoint_plan("*", repro_torch.pipeline(*plan))
    want = ref_compress(ref_pipeline(*plan), ref_numeric(a), backend="device",
                        use_resolve_cache=False)
    assert tck.compress_leaf(to_torch(a), device=CPU) == want


def test_kernel_error_in_an_override_is_not_retried(monkeypatch):
    calls = []

    def broken(x):
        raise ops.KernelError("delta_encode: injected")

    monkeypatch.setattr(ops, "delta_encode", broken)
    monkeypatch.setattr(Stream, "as_serial", lambda self: calls.append(self))
    tck.set_checkpoint_plan("int32", repro_torch.pipeline("delta", "zlib_backend"))
    with pytest.raises(ops.KernelError):
        tck.compress_leaf(to_torch(route_arrays()["int32"]), device=CPU)
    assert calls == []


def test_as_serial_is_a_view_on_the_device():
    t = to_torch(route_arrays()["int64"])
    s = repro_torch.numeric(t).as_serial()
    assert s.stype == repro_torch.SType.SERIAL and s.width == 1
    assert s.data.data_ptr() == t.data_ptr() and s.data.dtype == torch.uint8
    assert s.data.numel() == t.numel() * 8


def test_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = torch.zeros(8)
    with pytest.raises(_device.NoCardError):
        tck.compress_leaf(t)
    with pytest.raises(_device.NoCardError):
        tck.decompress_leaf(b"", (8,), "float32")
    with pytest.raises(_device.NoCardError):
        tck.save_checkpoint(tmp_path, 1, {"t": t})
    with pytest.raises(_device.NoCardError):
        tck.restore_checkpoint(tmp_path, 1)
    with pytest.raises(_device.NoCardError):
        tck.CheckpointManager(tmp_path)


# ------------------------------------------------- chip_smoke's checkpoint tree
def test_chip_smoke_llama_tree_is_init_params_tree(monkeypatch):
    """chip_smoke's Llama-3.2-1B tree has the keys, order, shapes and dtypes
    of the reference's ``init_params`` (at the reduced config's sizes), and
    its weight count is the full config's."""
    import chip_smoke

    cfg = LLAMA.reduced_cfg
    for name, value in (("LLAMA_LAYERS", cfg.n_layers), ("LLAMA_D", cfg.d_model),
                        ("LLAMA_HEADS", cfg.n_heads), ("LLAMA_KV_HEADS", cfg.n_kv_heads),
                        ("LLAMA_FF", cfg.d_ff), ("LLAMA_VOCAB", cfg.vocab)):
        monkeypatch.setattr(chip_smoke, name, value)
    got = tck.flatten_tree({"params": chip_smoke.llama_params(0, device=CPU)})
    flat = jax.tree_util.tree_flatten_with_path({"params": llama_tree()})[0]
    assert [(k, tuple(t.shape)) for k, t in got] == [(rck._leaf_key(p), a.shape)
                                                     for p, a in flat]
    assert {t.dtype for _, t in got} == {torch.bfloat16}  # the serving checkpoint's
    full = jax.eval_shape(lambda key: init_params(key, LLAMA.model_cfg), jax.random.PRNGKey(0))
    monkeypatch.undo()
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(full)) == chip_smoke.LLAMA_WEIGHTS
    assert chip_smoke.LLAMA_VOCAB == LLAMA.model_cfg.vocab


def test_chip_smoke_zipf_tokens_is_the_references():
    import chip_smoke
    from repro.data.synthetic import zipf_tokens

    for seed in (0, 3):
        assert np.array_equal(chip_smoke.zipf_tokens(5000, 128256, seed),
                              zipf_tokens(5000, 128256, seed))
