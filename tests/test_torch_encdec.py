"""Port differential: the stub-frontend families' serving path, VLM
(phi-3-vision, through ``repro_torch.models.transformer``) and enc-dec
(seamless-m4t, ``repro_torch.models.encdec``), against ``repro`` on the
CPU, float32.

The reference's parameters are carried across by ``params_from_numpy``
(norm weights redrawn so that they are not all ones); the frontend
embeddings and tokens are numpy draws from a seed.  Prefill logits and
three decode steps within 1e-5 of max |logit|, every cache leaf too;
prefill(S-1) + decode(1) against the full pass within 2e-3 (the
reference test's bound) at a prime length; ``greedy_generate`` on a
two-request batch equal token for token to each request alone and to the
reference's; the parameter tree carried there and back exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import encdec as rencdec  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.serve.serve_step import greedy_generate as r_greedy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import encdec, model, transformer  # noqa: E402
from repro_torch.serve.serve_step import greedy_generate  # noqa: E402
from test_torch_models import reference_tree, rel_err, t  # noqa: E402

ARCHS = ["phi-3-vision-4.2b", "seamless-m4t-medium"]
TOL = 1e-5  # max |Δ| / max |logit|, float32
TEACHER_FORCING_TOL = 2e-3  # the reference's own bound (tests/test_models.py)
FRAMES = 11  # the enc-dec's stub frames per request


@pytest.fixture(scope="module")
def zoo():
    """Per arch at SMOKE size in float32: (reference cfg, port cfg, numpy
    tree, reference params, port params)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg_r = rconfigs.get_config(arch, smoke=True, dtype="float32")
        cfg_t = configs.get_config(arch, smoke=True, dtype="float32")
        tree = reference_tree(cfg_r, 20 + i)
        out[arch] = (cfg_r, cfg_t, tree, jax.tree.map(jnp.asarray, tree),
                     model.params_from_numpy(cfg_t, tree, device="cpu"))
    return out


def _embeds(cfg, B, seed):
    n = cfg.frontend_tokens if cfg.family == "vlm" else FRAMES
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((B, n, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_and_cache(zoo, arch):
    """A prime prompt (13 tokens) after the frontend embeddings, then three
    decode steps."""
    cfg_r, cfg_t, _, rp, tp = zoo[arch]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_r.vocab, (2, 16)).astype(np.int32)
    emb = _embeds(cfg_r, 2, 2)
    cache_r, lr = rmodel.prefill(cfg_r, rp, {"tokens": jnp.asarray(tokens[:, :13]),
                                             "embeds": jnp.asarray(emb)}, 48)
    with torch.inference_mode():
        cache_t, lt = model.prefill(cfg_t, tp, {"tokens": t(tokens[:, :13]), "embeds": t(emb)},
                                    48)
    want, got = [lr], [lt]
    for i in range(13, 16):
        cache_r, lr = rmodel.decode_step(cfg_r, rp, cache_r, jnp.asarray(tokens[:, i:i + 1]))
        with torch.inference_mode():
            cache_t, lt = model.decode_step(cfg_t, tp, cache_t, t(tokens[:, i:i + 1]))
        want.append(lr)
        got.append(lt)
    got = torch.stack(got)
    assert got.dtype == torch.float32 and got.shape == (4, 2, cfg_r.vocab)
    assert rel_err(np.stack([np.asarray(w) for w in want]), got) <= TOL
    assert set(cache_t) == set(cache_r)
    np.testing.assert_array_equal(cache_t["len"].numpy(), np.asarray(cache_r["len"]))
    for k in set(cache_r) - {"len"}:
        assert cache_t[k].shape == cache_r[k].shape, k
        assert rel_err(cache_r[k], cache_t[k]) <= TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(zoo, arch):
    """prefill(S-1) + decode(1) against the full pass's last position, S =
    31 text tokens (prime) after the embeddings."""
    _, cfg, _, _, tp = zoo[arch]
    tokens = t(np.random.default_rng(3).integers(0, cfg.vocab, (2, 31)))
    emb = t(_embeds(cfg, 2, 4))
    with torch.inference_mode():
        cache, _ = model.prefill(cfg, tp, {"tokens": tokens[:, :-1], "embeds": emb}, 64)
        _, dec = model.decode_step(cfg, tp, cache, tokens[:, -1:])
        if cfg.family == "vlm":
            h, n_prefix, _ = transformer.forward(cfg, tp, {"tokens": tokens, "embeds": emb})
            assert n_prefix == cfg.frontend_tokens
        else:
            h, _ = encdec.decode_full(cfg, tp, tokens, encdec.encode(cfg, tp, emb))
    assert rel_err(h[:, -1] @ tp.lm_head, dec) < TEACHER_FORCING_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_batch_equals_each_alone(zoo, arch):
    cfg_r, cfg_t, _, rp, tp = zoo[arch]
    tokens = np.random.default_rng(5).integers(0, cfg_r.vocab, (2, 11)).astype(np.int32)
    emb = _embeds(cfg_r, 2, 6)
    got = greedy_generate(cfg_t, tp, {"tokens": t(tokens), "embeds": t(emb)}, steps=6,
                          max_len=40)
    assert got.shape == (2, 6)
    for i in range(2):
        alone = greedy_generate(cfg_t, tp, {"tokens": t(tokens[i:i + 1]),
                                            "embeds": t(emb[i:i + 1])}, steps=6, max_len=40)
        assert got[i].tolist() == alone[0].tolist()
    want = r_greedy(cfg_r, rp, {"tokens": jnp.asarray(tokens), "embeds": jnp.asarray(emb)},
                    steps=6, max_len=40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_init(zoo, arch):
    cfg_r, cfg, tree, _, tp = zoo[arch]
    back = model.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, tree, back)
    mine = model.params_to_numpy(model.init_params(cfg, 3, device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(tree)
    jax.tree.map(lambda r, m: np.testing.assert_equal(np.shape(r), np.shape(m)), tree, mine)
    if cfg.family == "audio":
        assert back["enc_layers"]["attn"]["wq"].shape[0] == cfg.enc_layers
        assert back["dec_layers"]["cross_attn"]["wo"].shape[0] == cfg.dec_layers
        with pytest.raises(ValueError, match="layers stacked"):
            bad = jax.tree.map(lambda a: a, tree)
            bad["dec_layers"]["lnx"] = bad["dec_layers"]["lnx"][:1]
            model.params_from_numpy(cfg, bad, device="cpu")


def test_encdec_cache_layouts(zoo):
    """``model.init_cache`` splits ``max_len`` into 3/4 self and 1/4 cross
    positions; ``prefill`` builds its own cache of ``max_len`` self and the
    encoder's ``T_a`` cross positions: both as the reference's."""
    cfg_r, cfg_t, _, _, _ = zoo["seamless-m4t-medium"]
    want = rmodel.init_cache(cfg_r, 3, 50)
    got = model.init_cache(cfg_t, 3, 50, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert got["self_k"].dtype == torch.float32 and got["len"].dtype == torch.int64
    want = rencdec.init_cache(cfg_r, 2, 24, FRAMES)
    got = encdec.init_cache(cfg_t, 2, 24, FRAMES, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_need_a_card(monkeypatch, arch):
    cfg = configs.get_config(arch, smoke=True)
    tree = model.params_to_numpy(model.init_params(cfg, 0, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: model.init_params(cfg, 0),
                 lambda: model.params_from_numpy(cfg, tree),
                 lambda: model.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
