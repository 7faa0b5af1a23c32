"""Port differential: the dense decoder's model zoo.

``repro_torch.configs`` against ``repro.configs`` field by field;
``repro_torch.models.{layers,flash,kvcache,transformer,model}`` against
``repro.models`` on the CPU, with the same numpy inputs and the
reference's parameters carried across by ``params_from_numpy`` (norm
weights, biases and qk-norms redrawn so that they are not all ones and
zeros).  Float32 logits must agree within 1e-4 × max |logit| (the chunked
softmax sums in another order: the port pads a prime length to whole
chunks where the reference takes chunks of 1); cache writes are data
movement and must be exact.  One bf16 case runs at a tolerance measured
here and stated below."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import kvcache as rkv  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import kvcache, layers, model, transformer  # noqa: E402

DENSE = ["qwen3-0.6b", "qwen2-72b", "deepseek-67b", "phi4-mini-3.8b"]
F32_TOL = 1e-4  # max |Δ| / max |ref|, float32
#: bf16 prefill + decode logits, qwen3 SMOKE, max |Δ| / max |logit|:
#: measured 0.0086 on this test's inputs (0.0070-0.0086 over three seeds;
#: torch 2.13 against jax 0.9, both on the CPU).  bf16 keeps 8 significant
#: bits, so the last rounding alone moves a logit by up to 1/256 = 0.0039
#: of its size; the bound is about twice the largest measured
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread for the module; the port's other CPU test
    files import this fixture.  At SMOKE width torch's default pool (a
    thread per core) costs more than it gives, and beside the suite's other
    workers its spinning threads take their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-9))


def t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def reference_tree(cfg_r, seed):
    """The reference's params, with norms, biases, qk-norms and the SSM
    blocks' constant leaves (``D``, ``dt_bias``, ``A_log``) redrawn."""
    tree = jax.tree.map(lambda a: np.array(a, np.float32),
                        rmodel.init_params(cfg_r, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = path[-1].key
        if name in ("ln1", "ln2", "ln", "final_norm", "q_norm", "k_norm", "norm_w", "D"):
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("bq", "bk", "bv", "conv_b"):
            return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if name in ("dt_bias", "A_log"):
            return (a + 0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, tree)


@pytest.fixture(scope="module")
def zoo():
    """Per dense arch at SMOKE size in float32: (reference cfg, port cfg,
    numpy tree, reference params, port params)."""
    out = {}
    for i, arch in enumerate(DENSE):
        cfg_r = rconfigs.get_config(arch, smoke=True, dtype="float32")
        cfg_t = configs.get_config(arch, smoke=True, dtype="float32")
        tree = reference_tree(cfg_r, i)
        out[arch] = (cfg_r, cfg_t, tree, jax.tree.map(jnp.asarray, tree),
                     model.params_from_numpy(cfg_t, tree, device="cpu"))
    return out


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


def test_configs_are_the_references():
    assert configs.list_archs() == rconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}
    for arch in configs.list_archs():
        for smoke in (False, True):
            mine = configs.get_config(arch, smoke=smoke)
            ref = rconfigs.get_config(arch, smoke=smoke)
            assert type(mine).__module__ == "repro_torch.configs.base"
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert mine.param_count() == ref.param_count()
            assert mine.active_param_count() == ref.active_param_count()
            for shape in configs.SHAPES:
                assert (configs.shape_applicable(mine, shape)
                        == rconfigs.shape_applicable(ref, shape))
    assert configs.get_config("qwen3-0.6b", dtype="float32").dtype == "float32"
    assert configs.get_config("qwen3-0.6b").param_count() == 751_624_192


# --------------------------------------------------------------------------
# layers, flash, kvcache
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = rlayers.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w, dtype), 1e-5)
    tdt = getattr(torch, dtype)
    got = layers.rmsnorm(t(x).to(tdt), t(w).to(tdt), 1e-5)
    assert got.dtype == tdt
    # float32: summation order only; bf16: at most one rounding of the output
    tol = 1e-6 if dtype == "float32" else 2**-7
    assert rel_err(want.astype(jnp.float32), got.float()) <= tol


def test_ffns_chunk_fit_and_embedding():
    """SwiGLU, the tanh-approximate GELU FFN, the reference's chunk fit and
    the token embedding with a stub prefix (``embeds``)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w1, w3 = (rng.standard_normal((16, 24)).astype(np.float32) for _ in range(2))
    w2 = rng.standard_normal((24, 16)).astype(np.float32)
    want = rlayers.swiglu(*map(jnp.asarray, (x, w1, w3, w2)))
    assert rel_err(want, layers.swiglu(*map(t, (x, w1, w3, w2)))) <= 1e-6
    want = rlayers.gelu_ffn(*map(jnp.asarray, (x, w1, w2)))
    assert rel_err(want, layers.gelu_ffn(*map(t, (x, w1, w2)))) <= 1e-6
    for n, c in [(31, 8), (64, 32), (96, 64), (1021, 512), (5, 512)]:
        assert layers._fit_chunk(n, c) == rlayers._fit_chunk(n, c)
    cfg_r = rconfigs.get_config("qwen3-0.6b", smoke=True)
    cfg_t = configs.get_config("qwen3-0.6b", smoke=True)
    embed = rng.standard_normal((cfg_r.vocab, cfg_r.d_model)).astype(np.float32)
    pre = rng.standard_normal((2, 3, cfg_r.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg_r.vocab, (2, 4)).astype(np.int32)
    want, n_r = rtransformer.embed_inputs(
        cfg_r, {"embed": jnp.asarray(embed)},
        {"tokens": jnp.asarray(tokens), "embeds": jnp.asarray(pre)})
    params = transformer.Transformer(cfg_t, device="cpu")
    params.embed.data.copy_(t(embed))
    got, n_t = transformer.embed_inputs(cfg_t, params, {"tokens": t(tokens), "embeds": t(pre)})
    assert n_r == n_t == 3 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_to_position_4096(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.concatenate([[0, 1, 4095, 4096], rng.integers(0, 4097, 5)]).astype(np.int32)
    pos = np.stack([pos, pos[::-1]])
    want = rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(t(x), t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(layers.rope_freqs(32, theta).numpy(),
                                  np.asarray(rlayers.rope_freqs(32, theta)))


@pytest.mark.parametrize("S,causal,window", [
    (31, True, 0),   # prime: the reference's chunks fall to 1, the port pads
    (64, True, 0),   # whole chunks
    (64, True, 16),  # sliding window: whole KV chunks skipped
    (37, False, 0),  # bidirectional, padded keys masked
])
def test_attention(S, causal, window):
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    want = rlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             window=window, q_chunk=16, kv_chunk=16)
    got = layers.attention(t(q), t(k), t(v), causal=causal, window=window,
                           q_chunk=16, kv_chunk=16)
    assert rel_err(want, got) <= 1e-5


def test_decode_attention_ragged_valid_len():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((4, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((4, 16, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((4, 16, 2, 16)).astype(np.float32)
    valid = np.array([1, 5, 16, 9], np.int32)
    want = rlayers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                    jnp.asarray(valid))
    got = layers.decode_attention(t(q), t(kc), t(vc), t(valid, torch.int64))
    assert rel_err(want, got) <= 1e-6


@pytest.mark.parametrize("S,max_len,window", [(5, 12, 0), (16, 40, 16), (37, 40, 16)])
def test_kvcache_prefill_and_token_writes(S, max_len, window):
    """Plain and rotating buffers (window=16, S ≥ T), then per-slot token
    writes past the wrap: exact."""
    rng = np.random.default_rng(S)
    L, B, H, D = 2, 3, 2, 4
    assert kvcache.attn_cache_len(max_len, window) == rkv.attn_cache_len(max_len, window)
    k = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    ref = rkv.cache_write_prefill(
        rkv.init_attn_cache(L, B, max_len, H, D, window=window, dtype=jnp.float32),
        jnp.asarray(k), jnp.asarray(v))
    mine = kvcache.cache_write_prefill(
        kvcache.init_attn_cache(L, B, max_len, H, D, window=window, dtype=torch.float32,
                                device="cpu"), t(k), t(v))
    for name in ("k", "v", "len"):
        np.testing.assert_array_equal(mine[name].numpy(), np.asarray(ref[name]))
    lengths = np.array([S, S + 7, S + 20], np.int32)  # ragged clocks, some past T
    kt = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    vt = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    want = rkv.cache_write_token(ref["k"][1], ref["v"][1], jnp.asarray(kt), jnp.asarray(vt),
                                 jnp.asarray(lengths))
    got = kvcache.cache_write_token(mine["k"][1], mine["v"][1], t(kt), t(vt),
                                    t(lengths, torch.int64))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # written in place: the layer views are the cache's
    np.testing.assert_array_equal(mine["k"][1].numpy(), np.asarray(want[0]))


# --------------------------------------------------------------------------
# transformer / model
# --------------------------------------------------------------------------


def _serve_both(cfg_r, cfg_t, rp, tp, tokens, max_len, n_dec):
    """Prefill then ``n_dec`` decode steps through both packages; returns
    the reference's and the port's logits and final caches."""
    cache_r, lr = rmodel.prefill(cfg_r, rp, {"tokens": jnp.asarray(tokens[:, :-n_dec])}, max_len)
    cache_t, lt = model.prefill(cfg_t, tp, {"tokens": t(tokens[:, :-n_dec])}, max_len)
    want, got = [lr], [lt]
    for i in range(n_dec, 0, -1):
        tok = tokens[:, -i:][:, :1]
        cache_r, lr = rmodel.decode_step(cfg_r, rp, cache_r, jnp.asarray(tok))
        cache_t, lt = model.decode_step(cfg_t, tp, cache_t, t(tok))
        want.append(lr)
        got.append(lt)
    return np.stack([np.asarray(w) for w in want]), torch.stack(got).numpy(), cache_r, cache_t


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits(zoo, arch):
    """Four dense SMOKE configs, float32: a prime prompt (31) then two
    decode steps."""
    cfg_r, cfg_t, _, rp, tp = zoo[arch]
    tokens = np.random.default_rng(3).integers(0, cfg_r.vocab, (2, 33)).astype(np.int32)
    want, got, cache_r, cache_t = _serve_both(cfg_r, cfg_t, rp, tp, tokens, 48, 2)
    assert got.dtype == np.float32 and got.shape == (3, 2, cfg_r.vocab)
    assert rel_err(want, got) <= F32_TOL
    np.testing.assert_array_equal(cache_t["len"].numpy(), np.asarray(cache_r["len"]))
    assert rel_err(cache_r["k"], cache_t["k"]) <= F32_TOL
    assert rel_err(cache_r["v"], cache_t["v"]) <= F32_TOL


def test_sliding_window_rotating_cache(zoo):
    """qwen3 SMOKE with window=16: the prefill (S=31 ≥ T=16) rolls into a
    rotating cache and decode wraps it."""
    cfg_r, cfg_t, tree, rp, _ = zoo["qwen3-0.6b"]
    cfg_r, cfg_t = (dataclasses.replace(c, window=16) for c in (cfg_r, cfg_t))
    tp = model.params_from_numpy(cfg_t, tree, device="cpu")
    tokens = np.random.default_rng(4).integers(0, cfg_r.vocab, (2, 34)).astype(np.int32)
    want, got, cache_r, cache_t = _serve_both(cfg_r, cfg_t, rp, tp, tokens, 48, 3)
    assert cache_t["k"].shape[2] == 16
    assert rel_err(want, got) <= F32_TOL


def test_bf16_logits(zoo):
    """qwen3 SMOKE in its own dtype (bf16): weights cast once at load on
    the port's side, at each use on the reference's."""
    _, _, tree, _, _ = zoo["qwen3-0.6b"]
    cfg_r = rconfigs.get_config("qwen3-0.6b", smoke=True)
    cfg_t = configs.get_config("qwen3-0.6b", smoke=True)
    tp = model.params_from_numpy(cfg_t, tree, device="cpu")
    assert tp.lm_head.dtype == torch.bfloat16
    tokens = np.random.default_rng(5).integers(0, cfg_r.vocab, (2, 20)).astype(np.int32)
    want, got, _, _ = _serve_both(cfg_r, cfg_t, jax.tree.map(jnp.asarray, tree), tp, tokens,
                                  32, 2)
    assert rel_err(want, got) <= BF16_TOL


def test_decode_matches_teacher_forcing(zoo):
    """The reference's own check (tests/test_models.py), on the port:
    prefill(S-1) + decode(1) == forward(S)'s last position, S prime."""
    _, cfg, _, _, tp = zoo["deepseek-67b"]
    tokens = t(np.random.default_rng(6).integers(0, cfg.vocab, (2, 37)))
    cache, _ = model.prefill(cfg, tp, {"tokens": tokens[:, :-1]}, 64)
    _, dec = model.decode_step(cfg, tp, cache, tokens[:, -1:])
    h, _, _ = transformer.forward(cfg, tp, {"tokens": tokens})
    assert rel_err(h[:, -1] @ tp.lm_head, dec) < 2e-3


def test_params_round_trip_and_mismatches(zoo):
    cfg_r, cfg, tree, _, tp = zoo["qwen2-72b"]
    back = model.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, tree, back)
    assert set(back["layers"]["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}
    with pytest.raises(KeyError, match="bq"):
        bad = jax.tree.map(lambda a: a, tree)
        del bad["layers"]["attn"]["bq"]
        model.params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(KeyError, match="q_norm"):
        bad = jax.tree.map(lambda a: a, tree)
        bad["layers"]["attn"]["q_norm"] = np.ones((cfg.n_layers, cfg.head_dim), np.float32)
        model.params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="layers stacked"):
        bad = jax.tree.map(lambda a: a, tree)
        bad["layers"]["ln1"] = bad["layers"]["ln1"][:1]
        model.params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(lambda a: a, tree)
        bad["lm_head"] = bad["lm_head"].T
        model.params_from_numpy(cfg, bad, device="cpu")


def test_init_params():
    cfg = configs.get_config("qwen3-0.6b", smoke=True)
    a = model.init_params(cfg, 7, device="cpu")
    b = model.init_params(cfg, 7, device="cpu")
    c = model.init_params(cfg, 8, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert pa.dtype == torch.bfloat16, name
        assert torch.equal(pa, pb), name
        if name.endswith(("ln1", "ln2", "final_norm", "q_norm", "k_norm")):
            assert bool((pa == 1).all()), name
        else:
            assert not torch.equal(pa, pc), name
            assert 0.015 < float(pa.float().std()) < 0.025, name
    f32 = model.init_params(dataclasses.replace(cfg, dtype="float32"), 7, device="cpu")
    assert torch.equal(f32.lm_head.to(torch.bfloat16), a.lm_head)  # the same draws, cast
    # the reference's tree layout
    tree = model.params_to_numpy(a)
    ref = rmodel.init_params(rconfigs.get_config("qwen3-0.6b", smoke=True), jax.random.PRNGKey(0))
    assert jax.tree.structure(jax.tree.map(np.asarray, ref)) == jax.tree.structure(tree)
    jax.tree.map(lambda r, m: np.testing.assert_equal(np.shape(r), np.shape(m)), ref, tree)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b"])
def test_entry_points_need_a_card(monkeypatch, arch):
    cfg = configs.get_config(arch, smoke=True)
    tree = model.params_to_numpy(model.init_params(cfg, 0, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: model.init_params(cfg, 0),
                 lambda: model.params_from_numpy(cfg, tree),
                 lambda: model.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert all(v.device.type == "cpu" for v in model.init_cache(cfg, 1, 8, device="cpu").values())
    params = model.params_from_numpy(cfg, tree, device="cpu")
    assert params.device.type == "cpu"
