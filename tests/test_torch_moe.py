"""Port differential: the MoE family (``repro_torch.models.moe`` and the
transformer's MoE layers) against ``repro`` on the CPU, float32.

Same numpy inputs through both packages, the reference's parameters
carried across by ``params_from_numpy``.  Outputs within ``F32_TOL`` of
max |ref|; router indices, the capacity and the set of dropped
(token, expert) pairs exactly equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from test_torch_models import F32_TOL, _serve_both, reference_tree, rel_err, t  # noqa: E402

MOE = ["olmoe-1b-7b", "mixtral-8x7b"]


@pytest.fixture(scope="module")
def zoo():
    """Per MoE arch at SMOKE size in float32: (reference cfg, port cfg,
    numpy tree, reference params, port params)."""
    out = {}
    for i, arch in enumerate(MOE):
        cfg_r = rconfigs.get_config(arch, smoke=True, dtype="float32")
        cfg_t = configs.get_config(arch, smoke=True, dtype="float32")
        tree = reference_tree(cfg_r, 10 + i)
        out[arch] = (cfg_r, cfg_t, tree, jax.tree.map(jnp.asarray, tree),
                     model.params_from_numpy(cfg_t, tree, device="cpu"))
    return out


def _moe_pair(seed, d=32, f=48, E=8):
    """One expert stack, as the reference's dict and as the port's module."""
    rng = np.random.default_rng(seed)
    arrs = {"router": rng.standard_normal((d, E)), "w1": rng.standard_normal((E, d, f)),
            "w3": rng.standard_normal((E, d, f)), "w2": rng.standard_normal((E, f, d))}
    arrs = {k: (0.2 * v).astype(np.float32) for k, v in arrs.items()}
    p = moe.MoE(d, f, E, device="cpu")
    for k, v in arrs.items():
        getattr(p, k).data.copy_(t(v))
    return {k: jnp.asarray(v) for k, v in arrs.items()}, p


def test_router_topk_breaks_ties_as_the_reference():
    """Logits with many exact ties (integer logits through an identity
    router): the same experts in the same order, then the same weights."""
    rng = np.random.default_rng(0)
    E = 8
    x = rng.integers(-2, 3, (64, E)).astype(np.float32)
    eye = np.eye(E, dtype=np.float32)
    for k in (1, 2, 3):
        want_idx, want_w = rmoe.router_topk(jnp.asarray(x), jnp.asarray(eye), k)
        got_idx, got_w = moe.router_topk(t(x), t(eye), k)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        assert rel_err(want_w, got_w) <= 1e-6
    # random logits through a random router
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    w = rng.standard_normal((32, E)).astype(np.float32)
    want_idx, want_w = rmoe.router_topk(jnp.asarray(x), jnp.asarray(w), 2)
    got_idx, got_w = moe.router_topk(t(x), t(w), 2)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert rel_err(want_w, got_w) <= 1e-6


def test_moe_dense():
    rp, tp = _moe_pair(1)
    x = np.random.default_rng(2).standard_normal((2, 9, 32)).astype(np.float32)
    want = rmoe.moe_dense(rp, jnp.asarray(x), 2)
    assert rel_err(want, moe.moe_dense(tp, t(x), 2)) <= F32_TOL


def _reference_dropped(rp, x, top_k, C):
    """The (token, expert) pairs past capacity, recounted in numpy from the
    reference's router indices: pairs in (token, k) order, stably sorted by
    expert, rank ≥ C."""
    idx, _ = rmoe.router_topk(jnp.asarray(x).reshape(-1, x.shape[-1]), rp["router"], top_k)
    idx = np.asarray(idx)
    seen = np.zeros(rp["router"].shape[-1], np.int64)
    dropped = set()
    for tok, k in np.ndindex(*idx.shape):  # (token, k) order = a stable sort's
        e = int(idx[tok, k])
        if seen[e] >= C:
            dropped.add((tok, e))
        seen[e] += 1
    return dropped


@pytest.mark.parametrize("capacity_factor,drops", [
    (4.0, False),  # C = N: nothing drops
    (0.5, True),   # N*k/E*cf = 2.5: banker's rounding gives C = 2
])
def test_moe_sort_with_and_without_drops(capacity_factor, drops):
    rp, tp = _moe_pair(3)
    x = np.random.default_rng(4).standard_normal((2, 10, 32)).astype(np.float32)
    N, k, E = 20, 2, 8
    C = moe.capacity(N, k, E, capacity_factor)
    assert C == int(max(1, round(N * k / E * capacity_factor)))
    want = rmoe.moe_sort(rp, jnp.asarray(x), k, capacity_factor)
    got = moe.moe_sort(tp, t(x), k, capacity_factor)
    assert got.shape == x.shape and rel_err(want, got) <= F32_TOL
    idx, _ = moe.router_topk(t(x).reshape(N, -1), tp.router, k)
    tok_s, k_s, keep, _ = moe.dispatch(idx, E, C)
    e_s = idx.reshape(-1)[k_s]
    mine = {(int(a), int(e)) for a, e, kept in zip(tok_s, e_s, keep) if not kept}
    assert mine == _reference_dropped(rp, x, k, C)
    assert bool(mine) == drops
    if not drops:
        assert rel_err(rmoe.moe_dense(rp, jnp.asarray(x), k), got) <= F32_TOL


def test_sort_local_is_sort_and_ffn_dispatch():
    rp, tp = _moe_pair(5)
    x = t(np.random.default_rng(6).standard_normal((1, 12, 32)).astype(np.float32))
    sort = moe.moe_sort(tp, x, 2, 1.25)
    assert torch.equal(moe.moe_sort_local(tp, x, 2, 1.25), sort)
    assert torch.equal(moe.moe_ffn(tp, x, 2, "sort_local", 1.25), sort)
    assert torch.equal(moe.moe_ffn(tp, x, 2, "dense"), moe.moe_dense(tp, x, 2))
    with pytest.raises(ValueError, match="gather"):
        moe.moe_ffn(tp, x, 2, "gather")


@pytest.mark.parametrize("arch,impl", [
    ("olmoe-1b-7b", "dense"),
    ("olmoe-1b-7b", "sort"),  # capacity dispatch; at decode's 2 tokens C = round(0.625) = 1
    ("mixtral-8x7b", "dense"),  # window 64 < prompt 70: the cache rotates
])
def test_prefill_and_decode_logits_and_cache(zoo, arch, impl):
    cfg_r, cfg_t, tree, rp, tp = zoo[arch]
    cfg_r, cfg_t = (dataclasses.replace(c, moe_impl=impl) for c in (cfg_r, cfg_t))
    tokens = np.random.default_rng(7).integers(0, cfg_r.vocab, (2, 72)).astype(np.int32)
    want, got, cache_r, cache_t = _serve_both(cfg_r, cfg_t, rp, tp, tokens, 96, 2)
    assert got.shape == (3, 2, cfg_r.vocab)
    assert rel_err(want, got) <= F32_TOL
    np.testing.assert_array_equal(cache_t["len"].numpy(), np.asarray(cache_r["len"]))
    assert cache_t["k"].shape == cache_r["k"].shape
    assert rel_err(cache_r["k"], cache_t["k"]) <= F32_TOL
    assert rel_err(cache_r["v"], cache_t["v"]) <= F32_TOL


def test_params_round_trip_and_init(zoo):
    cfg_r, cfg_t, tree, _, tp = zoo["olmoe-1b-7b"]
    back = model.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, tree, back)
    assert set(back["layers"]["moe"]) == {"router", "w1", "w3", "w2"}
    assert back["layers"]["moe"]["w1"].shape == (cfg_t.n_layers, cfg_t.n_experts,
                                                 cfg_t.d_model, cfg_t.d_ff)
    mine = model.params_to_numpy(model.init_params(cfg_t, 3, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    jax.tree.map(lambda r, m: np.testing.assert_equal(np.shape(r), np.shape(m)), tree, mine)
    assert 0.015 < float(np.std(mine["layers"]["moe"]["w2"])) < 0.025
    with pytest.raises(KeyError, match="layers.moe.w1"):
        bad = jax.tree.map(lambda a: a, tree)
        bad["layers"]["mlp"] = {"w1": bad["layers"]["moe"].pop("w1")}
        model.params_from_numpy(cfg_t, bad, device="cpu")
