"""The port's LM transformer (``repro_torch.models``) against the reference.

Weights come from the reference's ``init_params`` and cross with
``repro_torch.models.convert``; inputs are made from a numpy seed.  Stated
tolerances, float32 throughout: logits and loss 1e-4 absolute; every
gradient 1e-4 relative to the largest magnitude of its leaf; the port's
decode steps 1e-4 absolute against the reference's.  The reference's own
invariants hold for the port at the reference's tolerances: decode matches
forward within 3e-4 (2e-3 for MoE), remat changes the loss by under 1e-6
and no gradient by more than 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402

from repro_torch.configs import all_archs, get_arch  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402

LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-4
GRAD_RTOL = 1e-4
DECODE_ATOL = 1e-4

CONFIGS = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=97),
    "tied": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=97,
                 tie_embeddings=True),
    "swa": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=97,
                sliding_window=8),
    "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=97,
                n_experts=8, top_k=2, capacity_factor=1.25),
}
LM_ARCHS = ("llama3.2-1b", "h2o-danube-3-4b", "yi-9b", "olmoe-1b-7b", "kimi-k2-1t-a32b")


def _pair(name, **over):
    kw = dict(CONFIGS[name], remat=False, **over)
    return RT.TransformerConfig(**kw), PT.TransformerConfig(**kw)


def _ref_params(rcfg, seed=0):
    return jax.tree.map(np.asarray, RT.init_params(jax.random.PRNGKey(seed), rcfg))


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _leaf_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_grads(params_np, batch, pcfg):
    params = params_from_numpy(params_np, device="cpu")
    leaves = [t.requires_grad_() for _p, t in _leaf_items(params)]
    loss = PT.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, pcfg)
    grads = torch.autograd.grad(loss, leaves)
    paths = [p for p, _t in _leaf_items(params)]
    return float(loss.detach()), dict(zip(paths, (g.numpy() for g in grads)))


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    g = rng.normal(1.0, 0.1, 64).astype(np.float32)
    want = RL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(g, dtype))
    got = PL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(g).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(dtype)
    tol = 1e-6 if dtype == "float32" else 0.0  # bf16 rounds the same f32 value
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(3, 10)
    rc, rs = RL.rope_angles(jnp.asarray(pos), 16, theta)
    pc, ps = PL.rope_angles(torch.from_numpy(pos), 16, theta)
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), atol=1e-6)
    want = RL.apply_rope(jnp.asarray(x), rc[None, :, None, :], rs[None, :, None, :])
    got = PL.apply_rope(torch.from_numpy(x), pc[None, :, None, :], ps[None, :, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, size=(4, 6, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (4, 6)).astype(np.int32)
    mask = (rng.random((4, 6)) < 0.6).astype(np.float32) if masked else None
    want = RL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = PL.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                None if mask is None else torch.from_numpy(mask))
    assert abs(float(got) - float(want)) < LOSS_ATOL


def test_mlp_apply_matches_reference():
    p = jax.tree.map(np.asarray, RL.mlp_init(jax.random.PRNGKey(3), [16, 32, 8]))
    x = np.random.default_rng(3).normal(size=(5, 16)).astype(np.float32)
    want = RL.mlp_apply(p, jnp.asarray(x), final_act=jax.nn.sigmoid)
    got = PL.mlp_apply(params_from_numpy(p, device="cpu"), torch.from_numpy(x),
                       final_act=torch.sigmoid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mlp_init_shapes_and_count_params():
    gen = torch.Generator().manual_seed(0)
    p = PL.mlp_init(gen, [16, 32, 8])
    want = jax.eval_shape(lambda: RL.mlp_init(jax.random.PRNGKey(0), [16, 32, 8]))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in want.items()}
    assert PL.count_params(p) == RL.count_params(want) == 16 * 32 + 32 + 32 * 8 + 8


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_loss_and_grads_match_reference(name):
    rcfg, pcfg = _pair(name)
    params = _ref_params(rcfg)
    toks = _tokens(rcfg.vocab, (2, 20))
    labels = _tokens(rcfg.vocab, (2, 20), seed=2)
    want_logits = np.asarray(RT.forward(params, jnp.asarray(toks), rcfg))
    got_logits = PT.forward(params_from_numpy(params, device="cpu"), torch.from_numpy(toks),
                            pcfg).detach().numpy()
    assert np.abs(got_logits - want_logits).max() < LOGIT_ATOL
    batch = {"tokens": toks, "labels": labels}
    ref_loss, ref_grads = jax.value_and_grad(RT.loss_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rcfg)
    loss, grads = _port_grads(params, batch, pcfg)
    assert abs(loss - float(ref_loss)) < LOSS_ATOL
    ref_grads = dict(_leaf_items(jax.tree.map(np.asarray, ref_grads)))
    assert sorted(grads) == sorted(ref_grads)
    for path, g in grads.items():
        want = ref_grads[path]
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g - want).max()) / scale < GRAD_RTOL, path


@pytest.mark.parametrize("name", ["dense", "swa", "moe"])
def test_decode_step_matches_reference_step_by_step(name):
    """20 tokens; the SWA cache holds 8 slots, so its ring wraps twice."""
    rcfg, pcfg = _pair(name, **({"capacity_factor": 4.0} if name == "moe" else {}))
    params = _ref_params(rcfg)
    toks = _tokens(rcfg.vocab, (2, 20))
    rcache = RT.init_kv_cache(rcfg, 2, 4096)
    pcache = PT.init_kv_cache(pcfg, 2, 4096)
    if name == "swa":
        assert pcache["k"].shape[2] == rcache["k"].shape[2] == 8
    pparams = params_from_numpy(params, device="cpu")
    step = jax.jit(lambda pr, c, tk, pos: RT.decode_step(pr, c, tk, pos, rcfg))
    with torch.no_grad():
        for t in range(20):
            want, rcache = step(params, rcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            got, pcache = PT.decode_step(pparams, pcache, torch.from_numpy(toks[:, t:t + 1]),
                                         t, pcfg)
            assert np.abs(got.numpy() - np.asarray(want)).max() < DECODE_ATOL, t
            for key in ("k", "v"):
                np.testing.assert_allclose(pcache[key].numpy(), np.asarray(rcache[key]),
                                           atol=DECODE_ATOL)


def test_decode_step_takes_a_tensor_position():
    _rcfg, pcfg = _pair("swa")
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(pcfg, generator=gen)
    toks = torch.from_numpy(_tokens(pcfg.vocab, (2, 12)))
    a = PT.init_kv_cache(pcfg, 2, 64)
    b = PT.init_kv_cache(pcfg, 2, 64)
    with torch.no_grad():
        for t in range(12):
            la, a = PT.decode_step(params, a, toks[:, t:t + 1], t, pcfg)
            lb, b = PT.decode_step(params, b, toks[:, t:t + 1], torch.tensor(t), pcfg)
            assert torch.equal(la, lb)


# ------------------------------------------------- the reference's invariants
def _decode_matches_forward(pcfg, atol=3e-4, seq=16):
    gen = torch.Generator().manual_seed(0)
    p = PT.init_params(pcfg, generator=gen)
    toks = torch.randint(0, pcfg.vocab, (2, seq), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full = PT.forward(p, toks, pcfg)
        cache = PT.init_kv_cache(pcfg, 2, 4096)
        outs = []
        for t in range(seq):
            lg, cache = PT.decode_step(p, cache, toks[:, t:t + 1], t, pcfg)
            outs.append(lg)
    dec = torch.stack(outs, dim=1)
    err = float((dec - full).abs().max())
    assert err < atol, err
    return cache


def test_decode_matches_forward_dense():
    _decode_matches_forward(PT.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                                 n_kv_heads=2, d_ff=128, vocab=97, remat=False))


def test_decode_matches_forward_swa_ring_buffer():
    cfg = PT.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                               vocab=97, sliding_window=8, remat=False)
    cache = _decode_matches_forward(cfg, seq=20)
    assert cache["k"].shape[2] == 8  # ring = window size


def test_decode_matches_forward_moe():
    _decode_matches_forward(
        PT.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
                             vocab=97, n_experts=8, top_k=2, capacity_factor=4.0,
                             remat=False),
        atol=2e-3,  # decode re-dispatches one token: capacity never drops it
    )


def test_tied_embeddings_share_weights():
    cfg = PT.TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                               vocab=50, tie_embeddings=True, remat=False)
    p = PT.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert "lm_head" not in p
    model = PT.Transformer(cfg, generator=torch.Generator().manual_seed(0))
    assert "lm_head" not in dict(model.named_parameters())
    assert "lm_head" not in model.tree()


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_remat_equals_no_remat(name):
    _rcfg, base = _pair(name)
    rem = dataclasses.replace(base, remat=True)
    params = _ref_params(_rcfg)
    batch = {"tokens": _tokens(base.vocab, (2, 8)), "labels": _tokens(base.vocab, (2, 8))}
    l1, g1 = _port_grads(params, batch, base)
    l2, g2 = _port_grads(params, batch, rem)
    assert abs(l1 - l2) < 1e-6
    for path in g1:
        np.testing.assert_allclose(g1[path], g2[path], atol=1e-5)


def test_moe_top_k_breaks_ties_by_the_lower_index():
    probs = np.array([[[0.25, 0.25, 0.1, 0.25, 0.15]], [[0.2, 0.2, 0.2, 0.2, 0.2]]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = PT._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_overflow_matches_reference_when_capacity_drops_tokens():
    """capacity_factor 0.5 with 40 tokens: most picks overflow to slot E*C."""
    rcfg, pcfg = _pair("moe", capacity_factor=0.5, n_layers=1)
    params = _ref_params(rcfg, seed=4)
    toks = _tokens(rcfg.vocab, (2, 20), seed=5)
    want = np.asarray(RT.forward(params, jnp.asarray(toks), rcfg))
    got = PT.forward(params_from_numpy(params, device="cpu"), torch.from_numpy(toks), pcfg)
    assert np.abs(got.detach().numpy() - want).max() < LOGIT_ATOL


# ------------------------------------------------------------ init, configs
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_shapes_and_dtypes_match_reference(arch):
    pcfg = get_arch(arch).reduced_cfg
    rcfg = ref_get_arch(arch).reduced_cfg
    want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
    got = PT.init_params(pcfg, generator=torch.Generator().manual_seed(0))
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _leaf_items(want)}
    got = {p: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for p, v in _leaf_items(got)}
    assert got == want
    assert PL.count_params(PT.init_params(pcfg, generator=torch.Generator())) == \
        RL.count_params(jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg)))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_arch_config_matches_reference(arch):
    spec, ref = get_arch(arch), ref_get_arch(arch)
    assert (spec.family, spec.source, spec.notes) == (ref.family, ref.source, ref.notes)
    assert [dataclasses.astuple(s) for s in spec.shapes] == \
        [dataclasses.astuple(s) for s in ref.shapes]
    hints = {"dtype", "act_dp", "act_tp", "logits_pspec", "scan_unroll"}
    for mine, theirs in ((spec.model_cfg, ref.model_cfg), (spec.reduced_cfg, ref.reduced_cfg)):
        fields = {f.name for f in dataclasses.fields(mine)}
        assert fields == {f.name for f in dataclasses.fields(theirs)} - hints | {"dtype"}
        for f in fields - {"dtype"}:
            assert getattr(mine, f) == getattr(theirs, f), f
        assert mine.dtype == torch.float32 and theirs.dtype == jnp.float32


def test_registry_holds_the_lm_archs():
    assert sorted(all_archs()) == sorted(LM_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("sasrec")


def test_init_draws_the_reference_distributions():
    cfg = PT.TransformerConfig(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                               vocab=1000, n_experts=4, top_k=2)
    p = PT.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert abs(float(p["embed"].std()) - 0.02) < 0.001
    assert abs(float(p["layers"]["wq"].std()) * 16 - 1) < 0.02
    assert abs(float(p["layers"]["w_down"].std()) * np.sqrt(512) - 1) < 0.02
    assert abs(float(p["lm_head"].std()) * 16 - 1) < 0.02
    assert torch.equal(p["layers"]["attn_norm"], torch.ones(2, 256))
    again = PT.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for (_p, a), (_q, b) in zip(_leaf_items(p), _leaf_items(again)))


# ------------------------------------------------------------- module, convert
def test_transformer_module_parameters_are_the_tree():
    rcfg, pcfg = _pair("dense")
    params = _ref_params(rcfg)
    model = PT.Transformer(pcfg, params_from_numpy(params, device="cpu"))
    names = {n: tuple(t.shape) for n, t in model.named_parameters()}
    want = {".".join(p): v.shape for p, v in _leaf_items(params)}
    assert names == want
    toks = torch.from_numpy(_tokens(pcfg.vocab, (2, 9)))
    with torch.no_grad():
        assert torch.equal(model(toks), PT.forward(model.tree(), toks, pcfg))
    batch = {"tokens": toks, "labels": toks}
    model.loss(batch).backward()
    assert all(t.grad is not None for t in model.parameters())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_convert_round_trip(dtype):
    rcfg, _pcfg = _pair("moe")
    params = _ref_params(rcfg)
    tree = params_from_numpy(params, device="cpu", dtype=dtype)
    back = params_to_numpy(tree)
    for path, want in _leaf_items(params):
        got = _get(back, path)
        assert got.dtype == np.float32 and got.shape == want.shape
        if dtype is None:
            np.testing.assert_array_equal(got, want)
        else:
            assert _get(tree, path).dtype == torch.bfloat16
            np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_chip_smoke_lm_tree_has_the_reference_shapes(arch):
    """chip_smoke's numpy tree (its lm phase's weights) is init_params's tree."""
    import chip_smoke

    rcfg = ref_get_arch(arch).reduced_cfg
    tree = chip_smoke.lm_numpy_tree(get_arch(arch).reduced_cfg, np.random.default_rng(0))
    want = jax.eval_shape(lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
    assert {p: (v.shape, str(v.dtype)) for p, v in _leaf_items(tree)} == \
        {p: (tuple(v.shape), str(v.dtype)) for p, v in _leaf_items(want)}
