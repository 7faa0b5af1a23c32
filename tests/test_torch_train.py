"""Port differential: the training path (``repro_torch.models`` losses and
backwards, ``repro_torch.train``) against ``repro`` on the CPU, float32.

The same numpy inputs and the reference's parameters (carried across by
``params_from_numpy``) through both packages.  ``rmsnorm``'s and
``flash_attention``'s backwards against ``jax.vjp`` of the reference's
custom VJPs within 1e-5 of each output's max |g|; one SMOKE arch per
family, ``loss_fn`` within 1e-5 relative and every parameter's gradient
within 1e-4 of that leaf's max |g| against ``jax.value_and_grad``;
``optimizer.apply`` and ``grad_compress.compress`` on identical gradients
within 1e-6 (the masks exactly equal); four train steps with two
microbatches and compression within 1e-4 relative."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.data import synthetic as rsynthetic  # noqa: E402
from repro.models import flash as rflash  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import model as rmodel  # noqa: E402
from repro.train import grad_compress as rcompress  # noqa: E402
from repro.train import optimizer as roptimizer  # noqa: E402
from repro.train import train_step as rts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import flash, layers, model  # noqa: E402
from repro_torch.train import grad_compress, optimizer, train_step as ts  # noqa: E402
from test_torch_models import reference_tree, t  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

VJP_TOL = 1e-5  # max |Δg| / max |g|, per output
LOSS_TOL = 1e-5  # relative
GRAD_TOL = 1e-4  # max |Δg| / max |g|, per leaf
OPT_TOL = 1e-6  # absolute, float32 updates of O(1) values
STEP_LOSS_TOL = 1e-4  # relative, four train steps

#: one SMOKE arch per family
FAMILIES = ["qwen3-0.6b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-7b", "phi-3-vision-4.2b",
            "seamless-m4t-medium"]
OTHERS = ["qwen2-72b", "deepseek-67b", "phi4-mini-3.8b", "mixtral-8x7b"]


def rel_max(want, got) -> float:
    """max |Δ| / max |want|, 0 where both are all zeros."""
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    scale = np.abs(want).max()
    return float(np.abs(want - got).max() / scale) if scale else float(np.abs(got).max())


def module_tree(params, tensors) -> dict:
    """``tensors`` (in ``params``' order) as the reference's pytree."""
    m = optimizer.zeros_like(params)
    with torch.no_grad():
        for p, x in zip(m.parameters(), tensors, strict=True):
            p.copy_(x)
    return model.params_to_numpy(m)


def _batch(cfg, B, S, seed):
    """Tokens (and the family's frontend embeddings), as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["embeds"] = (0.1 * rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
                         ).astype(np.float32)
    elif cfg.family == "audio":
        out["embeds"] = (0.1 * rng.standard_normal((B, 7, cfg.d_model))).astype(np.float32)
    return out


# --------------------------------------------------------------------------
# the custom backwards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 7, 4, 32)])
def test_rmsnorm_backward(shape):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    y_r, vjp = jax.vjp(lambda x, w: rlayers.rmsnorm(x, w, 1e-5), jnp.asarray(x), jnp.asarray(w))
    dx_r, dw_r = vjp(jnp.asarray(dy))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    y = layers.rmsnorm(xt, wt, 1e-5)
    y.backward(t(dy))
    assert rel_max(y_r, y.detach()) <= VJP_TOL
    assert rel_max(dx_r, xt.grad) <= VJP_TOL
    assert rel_max(dw_r, wt.grad) <= VJP_TOL


def test_rmsnorm_backward_keeps_x_dtype():
    """``dx`` in ``x.dtype`` (bf16), ``dw`` summed in float32 and cast to
    ``w.dtype``: the reference's numbers at bf16's precision."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 9, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((4, 9, 64)).astype(np.float32)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda x, w: rlayers.rmsnorm(x, w), jnp.asarray(x, bf), jnp.asarray(w, bf))
    dx_r, dw_r = vjp(jnp.asarray(dy, bf))
    xt = t(x).to(torch.bfloat16).requires_grad_()
    wt = t(w).to(torch.bfloat16).requires_grad_()
    layers.rmsnorm(xt, wt).backward(t(dy).to(torch.bfloat16))
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    # bf16 keeps 8 significant bits: one rounding is up to 2**-8 of a value
    assert rel_max(np.asarray(dx_r.astype(jnp.float32)), xt.grad.float()) <= 2 ** -7
    assert rel_max(np.asarray(dw_r.astype(jnp.float32)), wt.grad.float()) <= 2 ** -7


@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, 0, 37, 37),   # prime S: the port pads to chunks of 16
    (False, 0, 37, 37),
    (True, 8, 37, 37),   # sliding window: whole chunks skipped
    (False, 0, 13, 29),  # cross attention, Sq != Sk
])
def test_flash_backward(causal, window, Sq, Sk):
    """GQA with G = 2: (B, Hkv, G, S, D) = (2, 2, 2, S, 16)."""
    rng = np.random.default_rng(Sq + Sk + window)
    q = rng.standard_normal((2, 2, 2, Sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, Sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, Sk, 16)).astype(np.float32)
    do = rng.standard_normal((2, 2, 2, Sq, 16)).astype(np.float32)
    o_r, vjp = jax.vjp(lambda q, k, v: rflash.flash_attention(q, k, v, causal, window, 0, 16, 16),
                       *map(jnp.asarray, (q, k, v)))
    grads_r = vjp(jnp.asarray(do))
    qt, kt, vt = (t(a).requires_grad_() for a in (q, k, v))
    o = flash.flash_attention(qt, kt, vt, causal, window, 0, 16, 16)
    o.backward(t(do))
    assert rel_max(o_r, o.detach()) <= VJP_TOL
    for want, got in zip(grads_r, (qt.grad, kt.grad, vt.grad)):
        assert got.shape == want.shape
        assert rel_max(want, got) <= VJP_TOL


# --------------------------------------------------------------------------
# loss_fn and every parameter's gradient
# --------------------------------------------------------------------------


def _loss_and_grads(arch, seed, **over):
    cfg_r = rconfigs.get_config(arch, smoke=True, dtype="float32", **over)
    cfg_t = configs.get_config(arch, smoke=True, dtype="float32", **over)
    tree = reference_tree(cfg_r, seed)
    batch = _batch(cfg_r, 2, 29, seed)
    loss_r, g_r = jax.jit(jax.value_and_grad(lambda p, b: rmodel.loss_fn(cfg_r, p, b)))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    params = model.params_from_numpy(cfg_t, tree, device="cpu").requires_grad_(True)
    loss = model.loss_fn(cfg_t, params, {k: t(v) for k, v in batch.items()})
    loss.backward()
    grads = module_tree(params, [p.grad for p in params.parameters()])
    return float(loss_r), float(loss.detach()), g_r, grads


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient(arch):
    """A prime text length (29 tokens; the VLM adds its 16 patches, the
    enc-dec 7 frames), remat "full" (the default)."""
    loss_r, loss, g_r, g = _loss_and_grads(arch, FAMILIES.index(arch))
    assert abs(loss - loss_r) <= LOSS_TOL * abs(loss_r)
    worst = jax.tree.map(rel_max, g_r, g)
    assert max(jax.tree.leaves(worst)) <= GRAD_TOL, worst


@pytest.mark.parametrize("arch,over", [
    ("qwen3-0.6b", {"remat": "none"}),  # autograd keeps every activation
    ("olmoe-1b-7b", {"moe_impl": "sort", "capacity_factor": 1.0}),  # capacity drops
])
def test_other_options_same_gradients(arch, over):
    loss_r, loss, g_r, g = _loss_and_grads(arch, 7, **over)
    assert abs(loss - loss_r) <= LOSS_TOL * abs(loss_r)
    assert max(jax.tree.leaves(jax.tree.map(rel_max, g_r, g))) <= GRAD_TOL


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_expected_initial_loss(package):
    """``transformer.expected_initial_loss`` (ln V + σ²/2, σ² = d · 0.02²,
    the card's step-1 check) against the loss of fresh weights from each
    package's own init over 8 x 256 uniform tokens, within half the σ²/2
    term: close enough to tell the formula from ln V alone."""
    from repro_torch.models import transformer

    cfg_t = configs.get_config("qwen3-0.6b", smoke=True, dtype="float32")
    half = cfg_t.d_model * 0.02**2 / 4
    tokens = np.random.default_rng(0).integers(0, cfg_t.vocab, (8, 256)).astype(np.int32)
    if package == "repro":
        cfg_r = rconfigs.get_config("qwen3-0.6b", smoke=True, dtype="float32")
        params = jax.tree.map(jnp.asarray, reference_tree(cfg_r, 0))
        loss = float(rmodel.loss_fn(cfg_r, params, {"tokens": jnp.asarray(tokens)}))
    else:
        params = model.init_params(cfg_t, 0, device="cpu")
        with torch.no_grad():
            loss = float(model.loss_fn(cfg_t, params, {"tokens": t(tokens)}))
    assert abs(loss - transformer.expected_initial_loss(cfg_t)) <= half


@pytest.mark.parametrize("arch", OTHERS)
def test_one_train_step_finite(arch):
    """The reference's own smoke check (tests/test_models.py): one step at
    the config's dtype, finite loss and parameters."""
    cfg = configs.get_config(arch, smoke=True)
    opt_cfg = optimizer.OptConfig(total_steps=10)
    state = ts.init_state(cfg, 0, opt_cfg, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in state["params"].parameters())
    batch = {k: t(v) for k, v in _batch(cfg, 2, 32, 0).items()}
    state, metrics = ts.make_train_step(cfg, opt_cfg)(state, batch)
    assert bool(torch.isfinite(metrics["loss"])) and float(metrics["loss"]) > 0
    assert all(bool(torch.isfinite(p).all()) for p in state["params"].parameters())
    assert int(state["opt"]["step"]) == 1


# --------------------------------------------------------------------------
# optimizer, compression, train step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen3():
    cfg_r = rconfigs.get_config("qwen3-0.6b", smoke=True, dtype="float32")
    cfg_t = configs.get_config("qwen3-0.6b", smoke=True, dtype="float32")
    return cfg_r, cfg_t, reference_tree(cfg_r, 0)


def _like(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.mark.parametrize("clip", [1.0, 1e3])  # clipped, and not
def test_optimizer_apply_matches_reference(qwen3, clip):
    cfg_r, cfg_t, tree = qwen3
    grads, mu = _like(tree, 1, 0.05), _like(tree, 2, 0.01)
    nu = jax.tree.map(np.abs, _like(tree, 3, 1e-3))
    opt_cfg = roptimizer.OptConfig(lr=1e-2, warmup_steps=3, total_steps=9, grad_clip=clip)
    r_params, r_opt, r_m = roptimizer.apply(
        jax.tree.map(jnp.asarray, tree),
        {"mu": jax.tree.map(jnp.asarray, mu), "nu": jax.tree.map(jnp.asarray, nu),
         "step": jnp.int32(4)}, jax.tree.map(jnp.asarray, grads), opt_cfg)

    def load(tr):
        return model.params_from_numpy(cfg_t, tr, device="cpu", dtype=torch.float32)

    params = load(tree)
    opt = {"mu": load(mu), "nu": load(nu), "step": torch.tensor(4, dtype=torch.int32)}
    params, opt, m = optimizer.apply(params, opt, load(grads), optimizer.OptConfig(
        **dataclasses.asdict(opt_cfg)))
    assert int(opt["step"]) == 5 and opt["step"].dtype == torch.int32
    assert abs(float(m["grad_norm"]) - float(r_m["grad_norm"])) <= 1e-6 * float(r_m["grad_norm"])
    assert abs(float(m["lr"]) - float(r_m["lr"])) <= 1e-9
    for want, got in ((r_params, params), (r_opt["mu"], opt["mu"]), (r_opt["nu"], opt["nu"])):
        diff = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()), want,
                            model.params_to_numpy(got))
        assert max(jax.tree.leaves(diff)) <= OPT_TOL, diff


def test_schedule_matches_reference():
    opt_cfg = roptimizer.OptConfig(lr=3e-3, warmup_steps=5, total_steps=40)
    mine = optimizer.OptConfig(**dataclasses.asdict(opt_cfg))
    for step in (0, 1, 4, 5, 6, 17, 39, 40, 55):
        assert float(optimizer.schedule(torch.tensor(step, dtype=torch.int32), mine)) == \
            pytest.approx(float(roptimizer.schedule(jnp.int32(step), opt_cfg)), rel=1e-6, abs=0)


@pytest.mark.parametrize("k_frac", [0.1, 0.5])
def test_grad_compress_matches_reference(qwen3, k_frac):
    cfg_r, cfg_t, tree = qwen3
    grads = _like(tree, 4, 0.05)
    # ties: a leaf of equal magnitudes keeps all of them (mask is >= k-th)
    grads["final_norm"] = np.full_like(grads["final_norm"], -0.25)
    err = _like(tree, 5, 0.01)
    err["final_norm"] = np.zeros_like(err["final_norm"])
    r_sparse, r_err, r_stats = rcompress.compress(jax.tree.map(jnp.asarray, grads),
                                                  jax.tree.map(jnp.asarray, err), k_frac)

    def load(tr):
        return model.params_from_numpy(cfg_t, tr, device="cpu", dtype=torch.float32)

    g = load(grads)
    sparse, new_err, stats = grad_compress.compress(g, load(err), k_frac)
    assert stats == r_stats
    sparse = module_tree(g, sparse)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a) != 0, b != 0),
                 r_sparse, sparse)
    assert np.all(sparse["final_norm"] == -0.25)
    for want, got in ((r_sparse, sparse), (r_err, model.params_to_numpy(new_err))):
        diff = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()), want, got)
        assert max(jax.tree.leaves(diff)) <= OPT_TOL, diff


def test_train_steps_with_microbatches_and_compression(qwen3):
    """Four steps of ``make_train_step(microbatches=2, compress_frac=0.1)``
    from the same state and the same token stream (each package's
    ``synthetic.make_batch_fn``): losses within 1e-4 relative, and the
    parameters after them close."""
    cfg_r, cfg_t, tree = qwen3
    opt_r = roptimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    r_step = jax.jit(rts.make_train_step(cfg_r, opt_r, microbatches=2, compress_frac=0.1))
    r_state = {"params": jax.tree.map(jnp.asarray, tree),
               "opt": roptimizer.init(jax.tree.map(jnp.asarray, tree)),
               "err": rcompress.init(jax.tree.map(jnp.asarray, tree))}
    step = ts.make_train_step(cfg_t, optimizer.OptConfig(**dataclasses.asdict(opt_r)),
                              microbatches=2, compress_frac=0.1)
    state = ts.init_state(cfg_t, 0, optimizer.OptConfig(), compress_frac=0.1, device="cpu")
    state["params"] = model.params_from_numpy(cfg_t, tree, device="cpu",
                                              dtype=torch.float32).requires_grad_(True)
    r_batches = rsynthetic.make_batch_fn(cfg_r, 4, 24)
    batches = synthetic.make_batch_fn(cfg_t, 4, 24, device="cpu")
    for i in range(4):
        r_state, r_m = r_step(r_state, r_batches(i))
        state, m = step(state, batches(i))
        assert abs(float(m["loss"]) - float(r_m["loss"])) <= STEP_LOSS_TOL * float(r_m["loss"])
        assert m["compress_ratio"] == pytest.approx(float(r_m["compress_ratio"]), rel=1e-6)
    assert int(state["opt"]["step"]) == 4
    worst = jax.tree.map(rel_max, r_state["params"], model.params_to_numpy(state["params"]))
    assert max(jax.tree.leaves(worst)) <= 1e-3, worst
