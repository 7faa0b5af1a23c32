"""Port differential: the model zoo's sharding rules.

``repro_torch.models.model``'s ``partition_specs``, ``batch_specs``,
``cache_specs`` and ``input_specs`` and ``train_step.state_specs`` against
the reference's, computed on ``jax.sharding.AbstractMesh`` (nothing is
allocated: the reference's leaves come from ``jax.eval_shape``, the port's
are ``meta`` tensors).  Every config at full size on the production meshes
``(16, 16)`` and ``(2, 16, 16)`` and on ``(2, 2)`` and ``(4, 1)``; the SMOKE
configs with ``expert_parallel`` on and off.  The rules read only axis
names and sizes, so the port gets a plain ``{axis: size}`` dict.  A
parameter of the port is one layer of the reference's stacked leaf: its
spec must be the reference's without the layer axes, which the reference
never shards.  Then ``placements`` must slice each leaf as the spec says.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import SHAPES as JSHAPES, get_config as jget_config  # noqa: E402
from repro.configs import shape_applicable  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as joptimizer, train_step as jts  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x2": (("data", "model"), (2, 2)),
    "4x1": (("data", "model"), (4, 1)),
}
CONFIGS = [(arch, False, None) for arch in list_archs()] + [
    (arch, True, ep) for arch in ("mixtral-8x7b", "olmoe-1b-7b") for ep in (False, True)
] + [(arch, True, None) for arch in ("qwen3-0.6b", "zamba2-7b", "seamless-m4t-medium")]


def _cfgs(arch, smoke, ep):
    over = {} if ep is None else {"expert_parallel": ep}
    return jget_config(arch, smoke=smoke, **over), get_config(arch, smoke=smoke, **over)


def _spec(p) -> tuple:
    return tuple(p)


def _flat(tree, is_leaf=None) -> dict:
    return {".".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def _meta_params(cfg):
    """The port's parameters on ``meta`` (the reference's ``jax.eval_shape``)."""
    return model._FAMILIES[cfg.family][1](cfg, device="meta")


@pytest.fixture(scope="module")
def abstract():
    """Per config: the reference's abstract train state and the port's
    ``meta`` parameters (built once for every mesh)."""
    out = {}
    for arch, smoke, ep in CONFIGS:
        jcfg, cfg = _cfgs(arch, smoke, ep)
        opt = joptimizer.OptConfig()
        jstate = jax.eval_shape(lambda: jts.init_state(jcfg, jax.random.PRNGKey(0), opt,
                                                       compress_frac=0.1))
        out[arch, smoke, ep] = jcfg, cfg, jstate, _meta_params(cfg)
    return out


def _check_params(params, jspecs: dict, got: dict):
    """The leaf specs equal the reference's; each port parameter, one layer
    of its stacked leaf, takes the spec without the layer axes."""
    shapes = model.leaf_shapes(params)
    assert got == {k: _spec(v) + (None,) * (len(shapes[k]) - len(v)) for k, v in jspecs.items()}
    for name, spec in model.param_specs(params, got).items():
        path, index = model._tree_name(name)
        assert spec == got[path][len(index):], name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,smoke,ep", CONFIGS)
def test_param_and_state_specs_match_reference(abstract, arch, smoke, ep, mesh_name):
    names, shape = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    mesh = dict(zip(names, shape))
    jcfg, cfg, jstate, params = abstract[arch, smoke, ep]
    jspecs = _flat(jts.state_specs(jcfg, jstate, jmesh), is_leaf=_is_spec)
    state = {"params": params, "opt": {"mu": params, "nu": params,
                                       "step": torch.zeros((), dtype=torch.int32)},
             "err": params}
    specs = ts.state_specs(cfg, state, mesh)
    assert set(specs) == {"params", "opt", "err"} and set(specs["opt"]) == {"mu", "nu", "step"}
    assert specs["opt"]["step"] == _spec(jspecs["opt.step"]) == ()
    for key in ("params", "opt.mu", "opt.nu", "err"):
        sub = {k[len(key) + 1:]: v for k, v in jspecs.items() if k.startswith(key + ".")}
        got = specs[key] if "." not in key else specs["opt"][key[4:]]
        _check_params(params, sub, got)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_batch_and_cache_specs_match_reference(arch, mesh_name):
    names, shape = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    mesh = dict(zip(names, shape))
    jcfg, cfg = _cfgs(arch, False, None)
    for sname, jshape in JSHAPES.items():
        if not shape_applicable(jcfg, sname)[0]:
            continue
        want = jmodel.input_specs(jcfg, jshape)
        got = model.input_specs(cfg, SHAPES[sname])
        assert all(t.device.type == "meta" for t in jax.tree.leaves(got))
        wflat, gflat = _flat(want), _flat(got)
        assert set(wflat) == set(gflat), sname
        for k, w in wflat.items():
            assert tuple(gflat[k].shape) == tuple(w.shape), (sname, k)
            if k != "cache.len":  # the port's clock is int64, the reference's int32
                assert str(gflat[k].dtype).removeprefix("torch.") == str(w.dtype), (sname, k)
        if jshape.kind == "decode":
            jc = _flat(jmodel.cache_specs(jcfg, want["cache"], jmesh), is_leaf=_is_spec)
            gc = model.cache_specs(cfg, got["cache"], mesh)
            assert gc == {k: _spec(v) + (None,) * (len(got["cache"][k].shape) - len(v))
                          for k, v in jc.items()}, sname
            batch = {"tokens": got["tokens"]}
            jbatch = {"tokens": want["tokens"]}
        else:
            batch = {k: v for k, v in got.items()}
            jbatch = want
        jb = {k: _spec(v) for k, v in jmodel.batch_specs(jcfg, jbatch, jmesh).items()}
        gb = model.batch_specs(cfg, batch, mesh)
        assert gb == {k: v + (None,) * (len(batch[k].shape) - len(v)) for k, v in jb.items()}


def _slice(full: np.ndarray, spec, sizes: dict, coord: dict) -> np.ndarray:
    """What a device at ``coord`` holds of ``full`` under ``spec``, the
    JAX way: each dim's axes flattened major to minor."""
    idx = []
    for d, entry in enumerate(spec):
        if entry is None:
            idx.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        n, k = 1, 0
        for a in axes:
            n, k = n * sizes[a], k * sizes[a] + coord[a]
        step = full.shape[d] // n
        idx.append(slice(k * step, (k + 1) * step))
    return full[tuple(idx)]


def _dtensor_slice(full: np.ndarray, placements, sizes: dict, coord: dict) -> np.ndarray:
    """What DTensor's ``placements`` give the rank at ``coord``: mesh dims
    applied left to right, each splitting its tensor dim again."""
    out = full
    for pl, (a, n) in zip(placements, sizes.items()):
        if pl.is_shard():
            out = np.split(out, n, axis=pl.dim)[coord[a]]
    return out


@pytest.mark.parametrize("mesh_name", ["2x16x16", "2x2", "4x1"])
def test_placements_slice_as_the_spec_says(mesh_name):
    names, shape = MESHES[mesh_name]
    sizes = dict(zip(names, shape))
    cfg = get_config("qwen3-0.6b", smoke=True, d_model=256, n_heads=4, n_kv=2, head_dim=64)
    params = _meta_params(cfg)
    specs = model.param_specs(params, model.partition_specs(cfg, params, sizes))
    rng = np.random.default_rng(0)
    coords = [dict(zip(names, c)) for c in np.ndindex(*shape)]
    coords = [coords[i] for i in rng.choice(len(coords), min(len(coords), 6), replace=False)]
    sharded = 0
    for name, p in params.named_parameters():
        full = rng.standard_normal(p.shape).astype(np.float32)
        pls = model.placements(specs[name], sizes)
        sharded += any(pl.is_shard() for pl in pls)
        for coord in coords:
            np.testing.assert_array_equal(_dtensor_slice(full, pls, sizes, coord),
                                          _slice(full, specs[name], sizes, coord), err_msg=name)
    assert sharded >= 8


def test_placements_refuse_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh order"):
        model.placements((("data", "pod"), None), {"pod": 2, "data": 2, "model": 1})


def test_batch_axes_are_every_axis_but_model():
    assert model.batch_axes({"pod": 2, "data": 16, "model": 16}) == ("pod", "data")
    assert model.fsdp_axes({"data": 4, "model": 1}) == ("data",)


# --------------------------------------------------------------------------
# sharded serving on a one-rank (1, 1) mesh
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A (1, 1) gloo mesh in this process (``make_host_mesh`` starts the
    one-rank group, or reuses one another module of this worker left)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    started = not dist.is_initialized()
    mesh = mesh_lib.make_host_mesh("cpu")
    assert tuple(mesh.shape) == (1, 1)
    yield mesh
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b", "seamless-m4t-medium"])
def test_sharded_prefill_and_decode_on_one_rank_are_the_unsharded_calls(one_rank_mesh, arch):
    """On (1, 1) the sharded branch gathers nothing and runs every row:
    logits and cache bit for bit the unsharded calls', the cache in
    ``cache_specs``' placements, and decode writes the prefill's cache in
    place as the unsharded decode does."""
    from repro_torch.ft import elastic
    from repro_torch.launch import mesh as mesh_lib

    mesh = one_rank_mesh
    cfg = get_config(arch, smoke=True, dtype="float32")
    params = model.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    B, S = 4, 24
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32))
    batch = {"tokens": tokens[:, :-1]}
    if cfg.family == "audio":  # frames first: 1/4 of the positions
        batch = {"tokens": tokens[:, :18],
                 "embeds": torch.from_numpy(rng.standard_normal((B, 6, cfg.d_model))
                                            .astype(np.float32))}
    tok = tokens[:, -1:]
    with torch.no_grad():
        want_cache, want_logits = model.prefill(cfg, params, batch, 40)
        want_cache = {k: v.clone() for k, v in want_cache.items()}
        want_dcache, want_dlogits = model.decode_step(
            cfg, params, {k: v.clone() for k, v in want_cache.items()}, tok)
        sp = elastic.reshard_state({"params": params},
                                   {"params": model.partition_specs(cfg, params, mesh)},
                                   mesh)["params"]
        sb = elastic.reshard_state(batch, model.batch_specs(cfg, batch, mesh), mesh)
        st = elastic.reshard_state({"t": tok}, {"t": model.batch_specs(cfg, {"t": tok},
                                                                       mesh)["t"]}, mesh)["t"]
        cache, logits = model.prefill(cfg, sp, sb, 40)
        assert torch.equal(mesh_lib.full_value(logits), want_logits)
        specs = model.cache_specs(cfg, cache, mesh)
        for k, v in cache.items():
            assert torch.equal(v.to_local(), want_cache[k]), k
            assert list(v.placements) == model.placements(specs[k], mesh), k
        before = {k: v.to_local().data_ptr() for k, v in cache.items() if k != "len"}
        dcache, dlogits = model.decode_step(cfg, sp, cache, st)
    assert torch.equal(mesh_lib.full_value(dlogits), want_dlogits)
    for k, v in dcache.items():
        assert torch.equal(v.to_local(), want_dcache[k]), k
    assert before == {k: v.to_local().data_ptr() for k, v in dcache.items() if k != "len"}
