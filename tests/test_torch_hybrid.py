"""Port differential: the hybrid family (``repro_torch.models.hybrid``,
zamba2: a Mamba-2 backbone with one shared attention block) against
``repro`` on the CPU, float32.

The reference's parameters (norms, biases and the SSM blocks' constant
leaves redrawn) carried across by ``params_from_numpy``.  Logits and every
cache leaf within ``F32_TOL`` of max |ref|, with a prompt longer than
zamba2 SMOKE's ``decode_window`` of 64, so that the shared block's caches
rotate."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import hybrid as rhybrid  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import hybrid, model  # noqa: E402
from test_torch_models import F32_TOL, _serve_both, reference_tree, rel_err, t  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

LAYERS = [5, 4]  # SMOKE: 2 groups of 2 and a tail layer; 2 groups, no tail


@pytest.fixture(scope="module")
def zoo():
    """Per depth at zamba2 SMOKE width in float32: (reference cfg, port
    cfg, numpy tree, reference params, port params)."""
    out = {}
    for n in LAYERS:
        cfg_r = rconfigs.get_config("zamba2-7b", smoke=True, dtype="float32", n_layers=n)
        cfg_t = configs.get_config("zamba2-7b", smoke=True, dtype="float32", n_layers=n)
        tree = reference_tree(cfg_r, 30 + n)
        out[n] = (cfg_r, cfg_t, tree, jax.tree.map(jnp.asarray, tree),
                  model.params_from_numpy(cfg_t, tree, device="cpu"))
    return out


def test_layout_at_full_size():
    for smoke in (False, True):
        cfg_r = rconfigs.get_config("zamba2-7b", smoke=smoke)
        cfg_t = configs.get_config("zamba2-7b", smoke=smoke)
        assert hybrid.n_groups(cfg_t) == rhybrid.n_groups(cfg_r)
        assert hybrid.shared_head_dim(cfg_t) == rhybrid.shared_head_dim(cfg_r)
    cfg = configs.get_config("zamba2-7b")
    assert hybrid.n_groups(cfg) == (13, 3) and hybrid.shared_head_dim(cfg) == 224


def test_shared_block(zoo):
    """The shared block at width 2·d over a prime sequence, and its keys
    and values."""
    cfg_r, cfg_t, _, rp, tp = zoo[5]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, cfg_t.d_model)).astype(np.float32)
    x0 = rng.standard_normal((2, 37, cfg_t.d_model)).astype(np.float32)
    pos = np.tile(np.arange(37), (2, 1))
    want, (k_r, v_r) = rhybrid.shared_block_fwd(cfg_r, rp["shared"], jnp.asarray(x),
                                                jnp.asarray(x0), jnp.asarray(pos),
                                                collect_kv=True)
    got, (k_t, v_t) = hybrid.shared_block_fwd(cfg_t, tp.shared, t(x), t(x0), t(pos))
    assert rel_err(want, got) <= F32_TOL
    assert rel_err(k_r, k_t) <= F32_TOL and rel_err(v_r, v_t) <= F32_TOL


@pytest.mark.parametrize("n_layers", LAYERS)
def test_zamba2_logits_and_every_cache_leaf(zoo, n_layers):
    """A 70-token prompt (past the 64-slot rotating window) and two decode
    steps: logits, both KV caches, the grouped and tail SSM states and
    conv windows, the clocks."""
    cfg_r, cfg_t, _, rp, tp = zoo[n_layers]
    tokens = np.random.default_rng(2).integers(0, cfg_r.vocab, (2, 72)).astype(np.int32)
    want, got, cache_r, cache_t = _serve_both(cfg_r, cfg_t, rp, tp, tokens, 96, 2)
    assert got.shape == (3, 2, cfg_r.vocab) and rel_err(want, got) <= F32_TOL
    assert set(cache_t) == set(cache_r)
    assert ("ssm_tail" in cache_t) == (n_layers == 5)
    assert cache_t["attn_k"].shape[2] == 64
    np.testing.assert_array_equal(cache_t["len"].numpy(), np.asarray(cache_r["len"]))
    for k in set(cache_r) - {"len"}:
        assert cache_t[k].shape == cache_r[k].shape, k
        assert rel_err(cache_r[k], cache_t[k]) <= F32_TOL, k


def test_decode_matches_teacher_forcing(zoo):
    """prefill(S-1) + decode(1) == forward(S)'s last position, S prime and
    within the decode window."""
    _, cfg, _, _, tp = zoo[5]
    tokens = t(np.random.default_rng(3).integers(0, cfg.vocab, (2, 37)))
    cache, _ = model.prefill(cfg, tp, {"tokens": tokens[:, :-1]}, 64)
    _, dec = model.decode_step(cfg, tp, cache, tokens[:, -1:])
    h = hybrid.forward(cfg, tp, {"tokens": tokens})
    assert rel_err(h[:, -1] @ tp.lm_head, dec) < 2e-3


def test_params_round_trip_and_init(zoo):
    cfg_r, cfg, tree, _, tp = zoo[5]
    back = model.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, tree, back)
    assert back["groups"]["mamba"]["in_proj"].shape[:2] == (2, 2)
    assert back["tail"]["ln"].shape == (1, cfg.d_model)
    assert "tail" not in model.params_to_numpy(zoo[4][4])
    mine = model.params_to_numpy(model.init_params(cfg, 3, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    jax.tree.map(lambda r, m: np.testing.assert_equal(np.shape(r), np.shape(m)), tree, mine)
    with pytest.raises(ValueError, match="layers stacked"):
        bad = jax.tree.map(lambda a: a, tree)
        bad["groups"]["ln"] = bad["groups"]["ln"].reshape(4, 1, -1)
        model.params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(KeyError, match="tail"):
        model.params_from_numpy(dataclasses.replace(cfg, n_layers=4), tree, device="cpu")
