"""Port differential: the SSM layers (``repro_torch.models.ssm``) and the
Mamba-1 LM (``repro_torch.models.ssm_model``, falcon-mamba) against
``repro`` on the CPU.

Same numpy inputs through both packages; the reference's parameters, with
``D``, ``dt_bias``, ``A_log``, the conv bias and the norms redrawn, carried
across.  Float32 outputs and every cache leaf within ``F32_TOL`` of max
|ref|: the port pads a prime S to whole chunks where the reference takes
chunks of 1, and scans with another tree (rounding only).  Each block runs
at a prime S and at a multiple of the chunk.  One bf16 case runs at a
tolerance measured here and stated below."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model, ssm, ssm_model  # noqa: E402
from test_torch_models import F32_TOL, _serve_both, reference_tree, rel_err, t  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

#: bf16 prefill + decode logits, falcon-mamba SMOKE, max |Δ| / max |logit|:
#: measured 0.0064 on this test's inputs (0.0033-0.0068 over three seeds
#: of weights and tokens; torch 2.13 against jax 0.9, both on the CPU).
#: bf16 keeps 8 significant bits (one rounding moves a logit by up to
#: 0.0039 of its size); the bound is about twice the largest measured
BF16_TOL = 1.5e-2
D_MODEL, N_STATE, HEAD_DIM, CHUNK = 16, 4, 8, 8


def _block_pair(kind, seed):
    """One Mamba block at width 16: the reference's dict (leaves redrawn)
    and the port's module holding the same values."""
    key = jax.random.PRNGKey(seed)
    if kind == "mamba1":
        rp = rssm.init_mamba1(key, D_MODEL, d_state=N_STATE)
        tp = ssm.Mamba1(D_MODEL, d_state=N_STATE, device="cpu")
    else:
        rp = rssm.init_mamba2(key, D_MODEL, d_state=N_STATE, head_dim=HEAD_DIM)
        tp = ssm.Mamba2(D_MODEL, d_state=N_STATE, head_dim=HEAD_DIM, device="cpu")
    rng = np.random.default_rng(seed)
    rp = {k: np.array(v, np.float32) for k, v in rp.items()}
    for name in ("D", "norm_w"):
        if name in rp:
            rp[name] = (1 + 0.2 * rng.standard_normal(rp[name].shape)).astype(np.float32)
    rp["conv_b"] = (0.05 * rng.standard_normal(rp["conv_b"].shape)).astype(np.float32)
    for name in ("dt_bias", "A_log"):
        rp[name] = (rp[name] + 0.5 * rng.standard_normal(rp[name].shape)).astype(np.float32)
    rp["in_proj"] *= 10  # activations of order one
    for name, p in tp.named_parameters():
        p.data.copy_(t(rp[name]))
    return {k: jnp.asarray(v) for k, v in rp.items()}, tp


def _kw(kind):
    return {"d_state": N_STATE} if kind == "mamba1" else {"d_state": N_STATE,
                                                          "head_dim": HEAD_DIM}


@pytest.fixture(scope="module")
def falcon():
    cfg_r = rconfigs.get_config("falcon-mamba-7b", smoke=True, dtype="float32")
    cfg_t = configs.get_config("falcon-mamba-7b", smoke=True, dtype="float32")
    tree = reference_tree(cfg_r, 20)
    return (cfg_r, cfg_t, tree, jax.tree.map(jnp.asarray, tree),
            model.params_from_numpy(cfg_t, tree, device="cpu"))


@pytest.mark.parametrize("S", [2, 31, 32])
def test_causal_conv1d_and_conv_step(S):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = rssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert rel_err(want, ssm.causal_conv1d(t(x), t(w), t(b))) <= 1e-6
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    want = rssm.conv_step(jnp.asarray(state), jnp.asarray(x[:, 0]), jnp.asarray(w),
                          jnp.asarray(b))
    got = ssm.conv_step(t(state), t(x[:, 0]), t(w), t(b))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert rel_err(want[1], got[1]) <= 1e-6


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
@pytest.mark.parametrize("S", [31, 32])  # prime (the reference's chunks fall to 1); 4 chunks
def test_mamba_blocks(kind, S):
    rp, tp = _block_pair(kind, 1)
    x = (0.5 * np.random.default_rng(S).standard_normal((2, S, D_MODEL))).astype(np.float32)
    block_r = rssm.mamba1 if kind == "mamba1" else rssm.mamba2
    block_t = ssm.mamba1 if kind == "mamba1" else ssm.mamba2
    want = block_r(rp, jnp.asarray(x), chunk=CHUNK, **_kw(kind))
    got = block_t(tp, t(x), chunk=CHUNK, **_kw(kind))
    assert got.shape == x.shape and rel_err(want, got) <= F32_TOL


@pytest.mark.parametrize("S", [2, 31])  # shorter than the conv window; prime
def test_mamba2_prefill_cache(S):
    rp, tp = _block_pair("mamba2", 2)
    x = (0.5 * np.random.default_rng(S).standard_normal((2, S, D_MODEL))).astype(np.float32)
    want_y, want_c = rssm.mamba2_prefill(rp, jnp.asarray(x), chunk=CHUNK, **_kw("mamba2"))
    got_y, got_c = ssm.mamba2_prefill(tp, t(x), chunk=CHUNK, **_kw("mamba2"))
    assert rel_err(want_y, got_y) <= F32_TOL
    np.testing.assert_array_equal(got_c["conv"].shape, want_c["conv"].shape)
    assert rel_err(want_c["conv"], got_c["conv"]) <= F32_TOL
    assert rel_err(want_c["ssm"], got_c["ssm"]) <= F32_TOL


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_decode_steps(kind):
    """One token from a random cache: the output and both cache leaves."""
    rp, tp = _block_pair(kind, 3)
    rng = np.random.default_rng(4)
    init_r = rssm.mamba1_init_cache if kind == "mamba1" else rssm.mamba2_init_cache
    init_t = ssm.mamba1_init_cache if kind == "mamba1" else ssm.mamba2_init_cache
    shapes = jax.tree.map(np.shape, init_r(rp, 3, N_STATE, dtype=jnp.float32))
    cache = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    assert {k: tuple(v.shape) for k, v in init_t(tp, 3, N_STATE, dtype=torch.float32).items()} \
        == shapes
    xt = (0.5 * rng.standard_normal((3, D_MODEL))).astype(np.float32)
    dec_r = rssm.mamba1_decode if kind == "mamba1" else rssm.mamba2_decode
    dec_t = ssm.mamba1_decode if kind == "mamba1" else ssm.mamba2_decode
    want_c, want_y = dec_r(rp, {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(xt),
                           **_kw(kind))
    got_c, got_y = dec_t(tp, {k: t(v) for k, v in cache.items()}, t(xt), **_kw(kind))
    assert rel_err(want_y, got_y) <= F32_TOL
    for k in ("conv", "ssm"):
        assert rel_err(want_c[k], got_c[k]) <= F32_TOL


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
@pytest.mark.parametrize("S", [23, 24])
def test_chunked_matches_stepwise(kind, S):
    """The reference's own checks (``tests/test_models.py``), on the port:
    the chunked block equals its token-by-token recurrence."""
    _, tp = _block_pair(kind, 0)
    x = t((0.3 * np.random.default_rng(1).standard_normal((2, S, D_MODEL))).astype(np.float32))
    block = ssm.mamba1 if kind == "mamba1" else ssm.mamba2
    init = ssm.mamba1_init_cache if kind == "mamba1" else ssm.mamba2_init_cache
    dec = ssm.mamba1_decode if kind == "mamba1" else ssm.mamba2_decode
    y_full = block(tp, x, chunk=CHUNK, **_kw(kind))
    cache = init(tp, 2, N_STATE, dtype=torch.float32)
    ys = []
    for i in range(S):
        cache, yt = dec(tp, cache, x[:, i], **_kw(kind))
        ys.append(yt)
    np.testing.assert_allclose(y_full.numpy(), torch.stack(ys, 1).numpy(), atol=1e-4, rtol=1e-3)


def test_falcon_mamba_logits_and_every_cache_leaf(falcon):
    """falcon-mamba SMOKE: a prime prompt (31) and two decode steps; the
    logits, the conv windows, the SSM states and the clocks."""
    cfg_r, cfg_t, _, rp, tp = falcon
    tokens = np.random.default_rng(5).integers(0, cfg_r.vocab, (2, 33)).astype(np.int32)
    want, got, cache_r, cache_t = _serve_both(cfg_r, cfg_t, rp, tp, tokens, 48, 2)
    assert got.shape == (3, 2, cfg_r.vocab) and rel_err(want, got) <= F32_TOL
    assert set(cache_t) == set(cache_r) == {"conv", "ssm", "len"}
    np.testing.assert_array_equal(cache_t["len"].numpy(), np.asarray(cache_r["len"]))
    for k in ("conv", "ssm"):
        assert cache_t[k].shape == cache_r[k].shape
        assert rel_err(cache_r[k], cache_t[k]) <= F32_TOL
    fresh = model.init_cache(cfg_t, 2, 48, device="cpu")
    assert {k: v.dtype for k, v in fresh.items()} == {
        "conv": torch.float32, "ssm": torch.float32, "len": torch.int64}


def test_decode_matches_teacher_forcing(falcon):
    """prefill(S-1) + decode(1) == forward(S)'s last position, S prime."""
    _, cfg, _, _, tp = falcon
    tokens = t(np.random.default_rng(6).integers(0, cfg.vocab, (2, 37)))
    cache, _ = model.prefill(cfg, tp, {"tokens": tokens[:, :-1]}, 64)
    _, dec = model.decode_step(cfg, tp, cache, tokens[:, -1:])
    h = ssm_model.forward(cfg, tp, {"tokens": tokens})
    assert rel_err(h[:, -1] @ tp.lm_head, dec) < 2e-3


def test_params_round_trip_and_init(falcon):
    cfg_r, cfg, tree, _, tp = falcon
    back = model.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, tree, back)
    assert set(back["layers"]) == {"ln", "mamba"}
    bf16 = model.params_from_numpy(configs.get_config("falcon-mamba-7b", smoke=True), tree,
                                   device="cpu")
    for name, p in bf16.named_parameters():  # A_log and dt_bias are used uncast
        want = torch.float32 if name.endswith(("A_log", "dt_bias")) else torch.bfloat16
        assert p.dtype == want, name
    mine = model.init_params(cfg, 3, device="cpu")
    ref = jax.tree.map(np.asarray, rssm.init_mamba1(jax.random.PRNGKey(0), cfg.d_model,
                                                    d_state=cfg.ssm_state))
    for name, p in mine.layers[0].mamba.named_parameters():
        assert tuple(p.shape) == ref[name].shape, name
        if name in ("A_log", "D", "conv_b", "dt_bias"):
            np.testing.assert_allclose(p.numpy(), ref[name], rtol=1e-6)
    with pytest.raises(ValueError, match="layers stacked"):
        bad = jax.tree.map(lambda a: a, tree)
        bad["layers"]["ln"] = bad["layers"]["ln"][:1]
        model.params_from_numpy(cfg, bad, device="cpu")


def test_bf16_logits(falcon):
    """falcon-mamba SMOKE in its own dtype (bf16)."""
    _, _, tree, _, _ = falcon
    cfg_r = rconfigs.get_config("falcon-mamba-7b", smoke=True)
    cfg_t = configs.get_config("falcon-mamba-7b", smoke=True)
    tp = model.params_from_numpy(cfg_t, tree, device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg_r.vocab, (2, 20)).astype(np.int32)
    want, got, _, _ = _serve_both(cfg_r, cfg_t, jax.tree.map(jnp.asarray, tree), tp, tokens,
                                  32, 2)
    assert rel_err(want, got) <= BF16_TOL
