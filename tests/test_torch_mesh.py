"""Port differential: the multi-card layer on ``torch.distributed``.

Four gloo ranks are spawned once for the module (:func:`ranks`); each
builds the meshes ``(data, model) = (2, 2)`` and ``(4, 1)``, the sub-meshes
``(1, 1)`` (rank 0) and ``(2, 1)`` (ranks 0 and 1), runs every scenario
and sends its results back, which the tests below hold against the
reference (``repro``, on the stacked or global values) and against the
port's unsharded paths:

* ``MeshComm``'s primitives (over one axis and over two flattened)
  against the reference's ``SimComm``;
* the stages of one A3 MSJ job through ``mesh_pipeline`` against
  ``run_pipeline`` under ``SimComm(4)`` (held against ``repro`` by
  ``test_torch_msj.py``), bit for bit;
* qwen3-0.6b SMOKE (float32) on ``(2, 2)``: train steps with
  ``microbatches=2``, and with ``compress_frac=0.1``, against the port's
  unsharded step and ``repro``'s ``make_train_step``, within 1e-5;
* each rank its own batch on ``(4, 1)``: the gradients must be the
  full batch's (a missing reduction leaves each rank its own);
* ``moe_sort_local`` under ``(2, 1)`` against the reference's ``moe_sort``
  on each batch shard, and ``constrain_batch`` on ``(2, 2)``;
* ``run_train_loop`` on ``(2, 2)`` crashed after its first step and
  resumed: its state equals the uninterrupted steps', and its checkpoint
  loads onto ``(1, 1)`` and ``(4, 1)``; ``reshard_state`` from ``(2, 2)`` to
  ``(4, 1)``; each bit for bit;
* a global batch whose microbatches do not split evenly over ``(4, 1)``
  runs whole on every rank (the reference then replicates it).

Then the reference's own two tests of this layer, mirrored on a one-rank
gloo group that ``make_host_mesh`` starts in the test process.
"""
import dataclasses
import socket
import time
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.engine.comm import SimComm as JSimComm  # noqa: E402
from repro.models import model as jmodel, moe as jmoe  # noqa: E402
from repro.train import grad_compress as jcompress  # noqa: E402
from repro.train import optimizer as joptimizer, train_step as jts  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import msj, queries  # noqa: E402
from repro_torch.core.algebra import semijoins_of  # noqa: E402
from repro_torch.core.relation import Relation, db_from_dict  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.engine.comm import MeshComm, SimComm, mesh_pipeline, run_pipeline  # noqa: E402
from repro_torch.ft import elastic, supervisor  # noqa: E402
from repro_torch.kernels.msj_probe import ops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, model, moe  # noqa: E402
from repro_torch.train import optimizer, train_step as ts  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

WORLD = 4
TOL = 1e-5  # relative: max |Δ| / max |want| per leaf, float32
OPT = optimizer.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
MSJ_ROWS, MSJ_P = 96, 4  # an A3 shape test_torch_msj.py runs
TRAIN = {"batch": 4, "seq": 32, "steps": 2}
MOE = {"B": 4, "S": 8, "cf": 1.0}  # capacity 1.0: the shards drop other pairs than the whole
RANKS_TIMEOUT_S = 300  # the four ranks' whole run (about 15 s alone); a collective waits 120 s


def _cfg():
    return get_config("qwen3-0.6b", smoke=True, dtype="float32")


def _numpy_state(state) -> dict:
    """Full values of a state (DTensor leaves gathered: a collective)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = _numpy_state(v)
        elif isinstance(v, torch.nn.Module):
            out[k] = model.params_to_numpy(v)
        else:
            out[k] = mesh_lib.full_value(v).numpy()
    return out


def _same(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True)) and \
        jax.tree.structure(a) == jax.tree.structure(b)


def _local_bytes(state) -> int:
    leaves = [p for m in (state["params"], state["opt"]["mu"], state["opt"]["nu"])
              for p in m.parameters()] + [state["opt"]["step"]]
    return sum(mesh_lib.local(x).numel() * x.element_size() for x in leaves)


def _spec_bytes(cfg, state, sizes: dict) -> int:
    """Bytes of one rank's shards as ``state_specs`` gives them."""
    specs = model.param_specs(state["params"], ts.state_specs(cfg, state, sizes)["params"])
    total = 4  # opt.step, int32, replicated
    for name, p in state["params"].named_parameters():
        n = p.numel()
        for entry in specs[name]:
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                n //= sizes[a]
        total += 3 * n * 4  # parameter, mu, nu: float32
    return total


# --------------------------------------------------------------------------
# what each rank runs
# --------------------------------------------------------------------------


def _comm_inputs():
    rng = np.random.default_rng(3)
    return (rng.integers(-50, 50, (WORLD, WORLD, 3)).astype(np.int32),
            rng.random((WORLD, WORLD, 3)) < 0.3)


def _rank_comm(m22, m41) -> dict:
    x, b = _comm_inputs()
    out = {}
    for label, comm in (("data", MeshComm(m41, "data")),
                        ("flat", MeshComm(m22, ("data", "model")))):
        r = comm.shard_id()
        t, tb = torch.from_numpy(x[r]), torch.from_numpy(b[r])
        out[label] = {"sid": r, "P": comm.P, "a2a": comm.all_to_all(t).numpy(),
                      "a2a_bool": comm.all_to_all(tb).numpy(),
                      "gather": comm.all_gather(t).numpy(),
                      "sum": comm.all_reduce_sum(t).numpy(),
                      "or": comm.all_reduce_or(tb).numpy(), "max": comm.all_reduce_or(t).numpy()}
    return out


def _msj_job(comm):
    qs = queries.make_queries("A3")
    sjs = [sj for q in qs for sj in semijoins_of(q)]
    db = db_from_dict(queries.gen_db(qs, n_guard=MSJ_ROWS, n_cond=MSJ_ROWS, seed=0), P=MSJ_P,
                      device="cpu")
    spec = msj.make_spec(sjs)
    cap = msj.count_forward_cap(spec, db, SimComm(MSJ_P))
    kit = msj._MSJKit(db, spec, comm, cap, probe_fn=ops.probe_bucketed)
    return kit, [kit.stage_map, kit.stage_probe, kit.stage_out]


def _tree_numpy(tree):
    """A pipeline result as nested dicts and lists of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, Relation):
        return {"data": tree.data.numpy(), "valid": tree.valid.numpy()}
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    return [_tree_numpy(v) for v in tree]


def _rank_msj(m41) -> dict:
    kit, stages = _msj_job(MeshComm(m41, "data"))
    mine = run_pipeline(MeshComm(m41, "data"), stages, kit.stacked)
    stacked = mesh_pipeline(m41, "data", stages)(kit.stacked)
    return {"local": _tree_numpy(mine), "stacked": _tree_numpy(stacked)}


def _fresh(cfg, mesh, seed=0, compress_frac=0.0):
    state = ts.init_state(cfg, seed, OPT, compress_frac=compress_frac, device="cpu")
    return elastic.reshard_state(state, ts.state_specs(cfg, state, mesh), mesh)


def _train(mesh, compress_frac, microbatches, grads=False):
    cfg = _cfg()
    state = _fresh(cfg, mesh, compress_frac=compress_frac)
    step = ts.make_train_step(cfg, OPT, microbatches=microbatches, compress_frac=compress_frac)
    if grads:  # the first step's, gathered
        batch = synthetic.token_batch(cfg, "train", TRAIN["batch"], TRAIN["seq"], 0,
                                      device="cpu")
        _, gs = ts.loss_and_grads(cfg, state["params"], batch, microbatches)
        grads = model.params_to_numpy(mesh_lib.module_with(state["params"], {
            n: mesh_lib.full_value(g)
            for (n, _), g in zip(state["params"].named_parameters(), gs)}, False))
    metrics, first = [], None
    for i in range(TRAIN["steps"]):
        batch = synthetic.token_batch(cfg, "train", TRAIN["batch"], TRAIN["seq"], i,
                                      device="cpu")
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        first = first or model.params_to_numpy(state["params"])
    return cfg, state, metrics, first, grads


def _rank_train(rank, m22, m41, m11, tmp) -> dict:
    out = {}
    cfg, state, out["metrics"], out["first"], out["grads"] = _train(m22, 0.0, 2, grads=True)
    out["state"] = _numpy_state(state)
    out["local_bytes"] = _local_bytes(state)
    out["spec_bytes"] = _spec_bytes(cfg, state, mesh_lib.axis_sizes(m22))
    out["placements"] = {n: tuple(map(str, p.placements))
                         for n, p in state["params"].named_parameters()}
    _, cstate, out["compress_metrics"], out["compress_first"], _ = _train(m22, 0.1, 1)
    out["compress_state"] = _numpy_state(cstate)

    # run_train_loop(mesh=) crashed after step 1 (a checkpoint every step)
    # and resumed from another state: the uninterrupted steps' state
    step = ts.make_train_step(cfg, OPT, microbatches=2)
    batches = synthetic.make_batch_fn(cfg, TRAIN["batch"], TRAIN["seq"], device="cpu")
    loop = {"steps": TRAIN["steps"], "ckpt_dir": f"{tmp}/loop", "ckpt_every": 1,
            "mesh": m22}
    with pytest.raises(supervisor.SimulatedFault):
        supervisor.run_train_loop(_fresh(cfg, m22), step, batches, crash_at=2, **loop)
    resumed, out["restart_hist"] = supervisor.run_train_loop(_fresh(cfg, m22, seed=1), step,
                                                             batches, log_every=1, **loop)
    out["restart_equal"] = _same(out["state"], _numpy_state(resumed))
    out["restart_dtensor"] = isinstance(resumed["params"].embed, DTensor)

    # its last checkpoint, written on (2, 2), onto (4, 1) and (1, 1);
    # reshard in memory
    last = TRAIN["steps"]
    s41 = checkpoint.load(loop["ckpt_dir"], last, state, mesh=m41,
                          specs=ts.state_specs(cfg, state, m41))
    out["load_41"] = _same(out["state"], _numpy_state(s41))
    out["load_41_local_rows"] = mesh_lib.local(s41["params"].embed).shape[0]
    out["reshard_41"] = _same(out["state"], _numpy_state(
        elastic.reshard_state(state, ts.state_specs(cfg, state, m41), m41)))
    if rank == 0:  # the one rank of (1, 1)
        s11 = checkpoint.load(loop["ckpt_dir"], last, state, mesh=m11,
                              specs=ts.state_specs(cfg, state, m11))
        out["load_11"] = _same(out["state"], _numpy_state(s11))
        out["load_11_local_rows"] = mesh_lib.local(s11["params"].embed).shape[0]
    return out


def _uneven_batch(cfg):
    return synthetic.token_batch(cfg, "train", 6, TRAIN["seq"], 1, device="cpu")


def _per_rank_batch(cfg, r):
    return synthetic.token_batch(cfg, "train", 2, TRAIN["seq"], 0, seed=10 + r, device="cpu")


def _rank_grads(rank, m41) -> dict:
    cfg = _cfg()
    params = ts.init_state(cfg, 0, OPT, device="cpu")["params"]
    sharded = elastic.reshard_state({"params": params}, {"params": model.partition_specs(
        cfg, params, m41)}, m41)["params"]
    tokens = DTensor.from_local(_per_rank_batch(cfg, rank)["tokens"], m41,
                                [Shard(0), Replicate()])
    loss, grads = ts.loss_and_grads(cfg, sharded, {"tokens": tokens})
    out = {"loss": float(loss), "grads": [mesh_lib.full_value(g).numpy() for g in grads]}
    # 4 microbatches of a batch that gives each rank 2 rows: a row each
    loss, grads = ts.loss_and_grads(cfg, sharded, {"tokens": tokens}, 4)
    out["row_each"] = {"loss": float(loss),
                       "grads": [mesh_lib.full_value(g).numpy() for g in grads]}
    # 6 rows do not split over 4 batch shards: every rank runs them all
    uneven = _uneven_batch(cfg)
    loss, grads = ts.loss_and_grads(cfg, sharded, uneven)
    out["uneven"] = {"loss": float(loss),
                     "grads": [mesh_lib.full_value(g).numpy() for g in grads]}
    out["refused"] = []
    for label, batch, mb in (("rows", uneven, 4), ("dtensor", {
            "tokens": DTensor.from_local(  # shares of 1, 1, 2 and 2 rows
                uneven["tokens"][:1 + rank // 2], m41, [Shard(0), Replicate()],
                run_check=False, shape=uneven["tokens"].shape,
                stride=uneven["tokens"].stride())}, 1)):
        with pytest.raises(ValueError, match="does not split"):
            ts.loss_and_grads(cfg, sharded, batch, mb)
        out["refused"].append(label)
    return out


def _moe_inputs():
    cfg = get_config("olmoe-1b-7b", smoke=True, dtype="float32")
    rng = np.random.default_rng(5)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"router": rng.standard_normal((d, E)), "w1": rng.standard_normal((E, d, f)),
         "w3": rng.standard_normal((E, d, f)), "w2": rng.standard_normal((E, f, d))}
    w = {k: (0.1 * v).astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((MOE["B"], MOE["S"], d)).astype(np.float32)
    return cfg, w, x


def _rank_moe(rank, m21) -> dict:
    if rank >= 2:
        return {}
    cfg, w, x = _moe_inputs()
    pl = {"router": [Replicate(), Replicate()], "w1": [Shard(1), Replicate()],
          "w3": [Shard(1), Replicate()], "w2": [Shard(2), Replicate()]}
    p = SimpleNamespace(**{k: mesh_lib.place(v, m21, pl[k]) for k, v in w.items()})
    half = MOE["B"] // 2
    xd = DTensor.from_local(torch.from_numpy(x[rank * half:(rank + 1) * half]), m21,
                            [Shard(0), Replicate()])
    layers.set_activation_batch_axes(("data",))
    try:
        y = moe.moe_sort_local(p, xd, cfg.top_k, MOE["cf"])
    finally:
        layers.set_activation_batch_axes(None)
    return {"y": y.to_local().numpy(), "placements": tuple(map(str, y.placements))}


def _rank_constrain(m22) -> dict:
    """``constrain_batch`` on a replicated activation: nothing without axes;
    the batch dim over ``data`` with them, and the sequence dim over
    ``model`` with ``seq_axis``; the values unchanged."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 6, 8)).astype(np.float32))
    xd = DTensor.from_local(x, m22, [Replicate(), Replicate()])
    out = {"none": tuple(map(str, layers.constrain_batch(xd).placements))}
    try:
        for label, seq in (("batch", None), ("seq", "model")):
            layers.set_activation_batch_axes(("data",), seq_axis=seq)
            y = layers.constrain_batch(xd)
            out[label] = (tuple(map(str, y.placements)), bool(torch.equal(y.full_tensor(), x)))
        out["plain"] = layers.constrain_batch(x) is x
    finally:
        layers.set_activation_batch_axes(None)
    return out


SERVE_ARCHS = ("qwen3-0.6b", "zamba2-7b")  # a KV cache; and the hybrid's grouped state (batch on dim 2)
SERVE = {"B": 4, "S": 24, "max_len": 40}


def _serve_inputs(arch):
    """Float32 SMOKE weights, a prompt batch and one decode token, the
    same on every rank (and in the test's process)."""
    cfg = get_config(arch, smoke=True, dtype="float32")
    params = model.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE["B"], SERVE["S"] + 1))
                              .astype(np.int32))
    return cfg, params, {"tokens": tokens[:, :-1]}, tokens[:, -1:]


def _rank_serve(m22) -> dict:
    """Sharded prefill and one decode step on (2, 2): each rank's logits
    (its batch rows) and each cache leaf gathered over ``model`` only (its
    rows, whole), with the placements they came back in."""
    out = {}
    with torch.no_grad():
        for arch in SERVE_ARCHS:
            cfg, params, batch, tok = _serve_inputs(arch)
            sharded = elastic.reshard_state(
                {"params": params}, {"params": model.partition_specs(cfg, params, m22)},
                m22)["params"]
            batch = elastic.reshard_state(batch, model.batch_specs(cfg, batch, m22), m22)
            tok = elastic.reshard_state({"t": tok}, {"t": model.batch_specs(
                cfg, {"t": tok}, m22)["t"]}, m22)["t"]
            cache, logits = model.prefill(cfg, sharded, batch, SERVE["max_len"])
            got = {"prefill": ({k: mesh_lib.full_value(v, over=("model",)).numpy()
                                for k, v in cache.items()}, logits.to_local().numpy())}
            cache, logits = model.decode_step(cfg, sharded, cache, tok)
            got["decode"] = ({k: mesh_lib.full_value(v, over=("model",)).numpy()
                              for k, v in cache.items()}, logits.to_local().numpy())
            got["placements"] = {k: tuple(map(str, v.placements)) for k, v in cache.items()}
            got["logit_placements"] = tuple(map(str, logits.placements))
            out[arch] = got
    return out


def _rank(rank, port, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank, timeout=timedelta(seconds=120))
    m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=mesh_lib.AXES)
    m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=mesh_lib.AXES)
    m11 = DeviceMesh("cpu", [[0]], mesh_dim_names=mesh_lib.AXES)
    m21 = DeviceMesh("cpu", [[0], [1]], mesh_dim_names=mesh_lib.AXES)
    out = {"comm": _rank_comm(m22, m41), "msj": _rank_msj(m41),
           "train": _rank_train(rank, m22, m41, m11, tmp),
           "grads": _rank_grads(rank, m41), "moe": _rank_moe(rank, m21),
           "constrain": _rank_constrain(m22), "serve": _rank_serve(m22),
           "rank": rank, "coord": m22.get_coordinate()}
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    ctx = mp.spawn(_rank, args=(_free_port(), str(tmp)), nprocs=WORLD, join=False)
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {WORLD} ranks did not finish within {RANKS_TIMEOUT_S} s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


# --------------------------------------------------------------------------
# the reference's values
# --------------------------------------------------------------------------


def rel_max(want, got) -> float:
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    scale = np.abs(want).max()
    return float(np.abs(want - got).max() / scale) if scale else float(np.abs(got).max())


def rel_l2(want, got) -> float:
    """|Δ|₂ / |want|₂ over a leaf.  Parameters after an AdamW step are
    compared so: the update divides each gradient element by its own
    magnitude, so where a gradient is a float32 rounding of zero (a few
    elements in 10⁴–10⁵) a sum in another order moves the element by up to
    lr, and its max relative error says nothing of the rest."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.linalg.norm(want - got) / np.linalg.norm(want))


def _worst(want: dict, got: dict, metric=rel_max) -> float:
    return max(jax.tree.leaves(jax.tree.map(metric, want, got)))


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded steps and ``repro``'s, from the same state."""
    cfg = _cfg()
    jcfg = jget_config("qwen3-0.6b", smoke=True, dtype="float32")
    jopt = joptimizer.OptConfig(**dataclasses.asdict(OPT))
    out = {}
    for label, cf, mb in (("plain", 0.0, 2), ("compress", 0.1, 1)):
        state = ts.init_state(cfg, 0, OPT, compress_frac=cf, device="cpu")
        tree = model.params_to_numpy(state["params"])
        jstate = {"params": jax.tree.map(jnp.asarray, tree),
                  "opt": joptimizer.init(jax.tree.map(jnp.asarray, tree))}
        if not cf:  # the first step's gradients, by jax.grad of the reference's loss
            batch0 = synthetic.token_batch(cfg, "train", TRAIN["batch"], TRAIN["seq"], 0,
                                           device="cpu")
            tokens = jnp.asarray(batch0["tokens"].numpy())
            grad = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(jcfg, p, b)))
            out["jgrads"] = jax.tree.map(lambda *g: sum(g) / mb, *(
                grad(jstate["params"], {"tokens": part}) for part in jnp.split(tokens, mb)))
        if cf:
            jstate["err"] = jcompress.init(jstate["params"])
        step = ts.make_train_step(cfg, OPT, microbatches=mb, compress_frac=cf)
        jstep = jax.jit(jts.make_train_step(jcfg, jopt, microbatches=mb, compress_frac=cf))
        losses, jlosses, norms, jfirst = [], [], [], None
        for i in range(TRAIN["steps"]):
            batch = synthetic.token_batch(cfg, "train", TRAIN["batch"], TRAIN["seq"], i,
                                          device="cpu")
            state, m = step(state, batch)
            jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"].numpy())})
            losses.append(float(m["loss"]))
            jlosses.append(float(jm["loss"]))
            norms.append(float(m["grad_norm"]))
            jfirst = jfirst or jax.tree.map(np.asarray, jstate["params"])
        out[label] = {"losses": losses, "grad_norms": norms,
                      "params": model.params_to_numpy(state["params"]),
                      "jlosses": jlosses, "jfirst": jfirst}
    return out


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("label", ["data", "flat"])
def test_meshcomm_matches_simcomm(ranks, label):
    x, b = _comm_inputs()
    sim = JSimComm(WORLD)
    want = {"a2a": np.asarray(sim.all_to_all(jnp.asarray(x))),
            "a2a_bool": np.asarray(sim.all_to_all(jnp.asarray(b))),
            "gather": np.asarray(sim.all_gather(jnp.asarray(x))),
            "sum": np.asarray(sim.all_reduce_sum(jnp.asarray(x))),
            "or": np.asarray(sim.all_reduce_or(jnp.asarray(b))),
            "max": np.asarray(sim.all_reduce_or(jnp.asarray(x)))}
    assert sorted(r["comm"][label]["sid"] for r in ranks) == list(range(WORLD))
    for r in ranks:
        got = r["comm"][label]
        assert got["P"] == WORLD
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w[got["sid"]], err_msg=k)
            assert got[k].dtype == w.dtype, k


def test_mesh_pipeline_msj_matches_simcomm(ranks):
    kit, stages = _msj_job(SimComm(MSJ_P))
    want = _tree_numpy(run_pipeline(SimComm(MSJ_P), stages, kit.stacked))
    for r, got in enumerate(ranks):
        assert jax.tree.structure(got["msj"]["stacked"]) == jax.tree.structure(want)
        assert _same(want, got["msj"]["stacked"])
        shard = jax.tree.map(lambda a: a[r], want)
        assert _same(shard, got["msj"]["local"])
    outputs, stats = want
    assert int(stats["hits"].sum()) > 0 and any(o["valid"].any() for o in outputs.values())


@pytest.mark.parametrize("label", ["plain", "compress"])
def test_sharded_train_steps_match_unsharded_and_reference(ranks, unsharded, label):
    ref = unsharded[label]
    key = "metrics" if label == "plain" else "compress_metrics"
    skey = "state" if label == "plain" else "compress_state"
    for r in ranks:
        losses = [m["loss"] for m in r["train"][key]]
        np.testing.assert_allclose(losses, ref["losses"], rtol=TOL, atol=0)
        np.testing.assert_allclose(losses, ref["jlosses"], rtol=TOL, atol=0)
        assert _worst(ref["params"], r["train"][skey]["params"], rel_l2) <= TOL
        # the reference's parameters after the first step, at the bound the
        # port's unsharded step keeps to them (tests/test_torch_train.py):
        # its own AdamW update differs from the reference's by up to 1.3e-5
        # relative in |Δ|₂ (qwen3 SMOKE), for the reason ``rel_l2`` gives
        first = "first" if label == "plain" else "compress_first"
        assert _worst(ref["jfirst"], r["train"][first]) <= 1e-3
        np.testing.assert_allclose([m["grad_norm"] for m in r["train"][key]],
                                   ref["grad_norms"], rtol=TOL, atol=0)
    assert ranks[0]["train"][skey]["opt"]["step"] == TRAIN["steps"]
    if label == "plain":  # the first step's gradients, against jax.grad of the reference
        for r in ranks:
            assert _worst(jax.tree.map(np.asarray, unsharded["jgrads"]),
                          r["train"]["grads"]) <= TOL
    if label == "compress":
        assert all(0 < m["compress_ratio"] < 1 for m in ranks[0]["train"][key])


def test_sharded_state_holds_its_shards(ranks):
    """Each rank holds what ``state_specs`` gives it: the weight matrices
    split four ways on (2, 2), the norms whole."""
    for r in ranks:
        assert r["train"]["local_bytes"] == r["train"]["spec_bytes"]
    pl = ranks[0]["train"]["placements"]
    assert pl["layers.0.attn.wq"] == ("S(0)", "S(1)") and pl["embed"] == ("S(1)", "S(0)")
    assert pl["layers.0.ln1"] == ("R", "R")


def test_each_rank_its_own_batch_gives_the_full_batch_gradient(ranks):
    cfg = _cfg()
    params = ts.init_state(cfg, 0, OPT, device="cpu")["params"]
    tokens = torch.cat([_per_rank_batch(cfg, r)["tokens"] for r in range(WORLD)])
    loss, grads = ts.loss_and_grads(cfg, params, {"tokens": tokens})
    for r in ranks:
        assert r["grads"]["loss"] == pytest.approx(float(loss), rel=TOL, abs=0)
        for g, want in zip(r["grads"]["grads"], grads, strict=True):
            assert rel_max(want.numpy(), g) <= TOL


def test_a_dtensor_batch_of_fewer_rows_than_microbatches_runs_a_row_each(ranks):
    """2 rows per rank and 4 microbatches (the reference's microbatch is
    half a row per shard): each rank runs its rows one at a time, and the
    loss and gradients are the full batch's."""
    cfg = _cfg()
    params = ts.init_state(cfg, 0, OPT, device="cpu")["params"]
    tokens = torch.cat([_per_rank_batch(cfg, r)["tokens"] for r in range(WORLD)])
    loss, grads = ts.loss_and_grads(cfg, params, {"tokens": tokens})
    for r in ranks:
        got = r["grads"]["row_each"]
        assert got["loss"] == pytest.approx(float(loss), rel=TOL, abs=0)
        for g, want in zip(got["grads"], grads, strict=True):
            assert rel_max(want.numpy(), g) <= TOL


def test_a_batch_that_does_not_split_runs_whole_on_every_rank(ranks):
    """6 rows on 4 batch shards: the full batch's loss and gradients (not
    a mean of unequal shares); rows that do not split into microbatches,
    and a DTensor batch of unequal shares, are refused."""
    cfg = _cfg()
    params = ts.init_state(cfg, 0, OPT, device="cpu")["params"]
    loss, grads = ts.loss_and_grads(cfg, params, _uneven_batch(cfg))
    for r in ranks:
        got = r["grads"]["uneven"]
        assert got["loss"] == pytest.approx(float(loss), rel=TOL, abs=0)
        for g, want in zip(got["grads"], grads, strict=True):
            assert rel_max(want.numpy(), g) <= TOL
        assert r["grads"]["refused"] == ["rows", "dtensor"]


def test_moe_sort_local_runs_each_shard_alone(ranks):
    cfg, w, x = _moe_inputs()
    jcfg = jget_config("olmoe-1b-7b", smoke=True, dtype="float32")
    half = MOE["B"] // 2
    sort = jax.jit(jmoe.moe_sort, static_argnums=(2, 3))
    whole = np.asarray(sort(w, jnp.asarray(x), jcfg.top_k, MOE["cf"]))
    for r in range(2):
        got = ranks[r]["moe"]
        want = np.asarray(sort(w, jnp.asarray(x[r * half:(r + 1) * half]), jcfg.top_k,
                               MOE["cf"]))
        assert got["placements"] == ("S(0)", "R")
        assert rel_max(want, got["y"]) <= TOL
    # per-shard capacity: the shards drop other pairs than the whole batch
    got = np.concatenate([ranks[r]["moe"]["y"] for r in range(2)])
    assert rel_max(whole, got) > 1e-3


def test_constrain_batch_places_dtensor_activations(ranks):
    for r in ranks:
        got = r["constrain"]
        assert got["none"] == ("R", "R") and got["plain"]
        assert got["batch"] == (("S(0)", "R"), True)
        assert got["seq"] == (("S(0)", "S(1)"), True)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_are_each_ranks_unsharded_rows(ranks, arch):
    """Each rank of (2, 2) runs its batch shard (``data``) with every
    weight gathered: its logits and its rows of the new cache are bit for
    bit the unsharded prefill and decode of those rows, and the cache
    comes back in ``cache_specs``' placements (``len`` replicated)."""
    cfg, params, batch, tok = _serve_inputs(arch)
    half = SERVE["B"] // 2
    with torch.no_grad():
        for r in ranks:
            rows = slice(r["coord"][0] * half, (r["coord"][0] + 1) * half)
            cache, logits = model.prefill(cfg, params, {"tokens": batch["tokens"][rows]},
                                          SERVE["max_len"])
            want = {"prefill": ({k: v.numpy().copy() for k, v in cache.items()},
                                logits.numpy())}
            cache, logits = model.decode_step(cfg, params, cache, tok[rows])
            want["decode"] = ({k: v.numpy() for k, v in cache.items()}, logits.numpy())
            got = r["serve"][arch]
            for step in ("prefill", "decode"):
                (gc_, gl), (wc, wl) = got[step], want[step]
                assert np.array_equal(gl, wl), (arch, step, r["rank"])
                assert gc_.keys() == wc.keys()
                for k in wc:  # ``len`` is replicated: every rank holds all rows
                    g = gc_[k][rows] if k == "len" else gc_[k]
                    assert np.array_equal(g, wc[k]), (arch, step, k, r["rank"])
            m22 = {"data": 2, "model": 2}
            specs = model.cache_specs(cfg, model.init_cache(
                cfg, SERVE["B"], SERVE["max_len"], device="meta"), m22)
            assert got["placements"] == {k: tuple(map(str, model.placements(v, m22)))
                                         for k, v in specs.items()}
            assert got["placements"]["len"] == ("R", "R")
            assert got["logit_placements"] == ("S(0)", "R")


def test_checkpoint_and_reshard_across_meshes(ranks):
    cfg = _cfg()
    V = cfg.vocab
    for r, res in enumerate(ranks):
        t = res["train"]
        assert t["load_41"] and t["reshard_41"]
        assert t["load_41_local_rows"] == V  # embed (V, d): d over data on (4, 1)
    assert ranks[0]["train"]["load_11"] and ranks[0]["train"]["load_11_local_rows"] == V


def test_run_train_loop_resumes_a_sharded_state(ranks):
    for r in ranks:
        res = r["train"]
        assert res["restart_equal"] and res["restart_dtensor"]
        assert [s for s, _ in res["restart_hist"]] == [2]


# --------------------------------------------------------------------------
# one rank in this process: the reference's own tests, mirrored
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    mesh = mesh_lib.make_host_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_make_host_mesh_puts_every_rank_on_data(host_mesh):
    assert mesh_lib.axis_sizes(host_mesh) == {"data": 1, "model": 1}
    assert host_mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    assert model.batch_axes(host_mesh) == ("data",)


def test_make_host_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_host_mesh()


def test_checkpoint_reshard_on_load(host_mesh, tmp_path):
    cfg = get_config("qwen3-0.6b", smoke=True)
    params = model.init_params(cfg, 0, device="cpu")
    checkpoint.save(str(tmp_path), 1, {"params": params}, mesh=host_mesh)
    assert checkpoint.latest_step(str(tmp_path)) == 1
    specs = model.partition_specs(cfg, params, host_mesh)
    loaded = checkpoint.load(str(tmp_path), 1, {"params": params}, mesh=host_mesh,
                             specs={"params": specs})["params"]
    for (name, a), b in zip(params.named_parameters(), loaded.parameters(), strict=True):
        assert isinstance(b, DTensor) and b.device_mesh == host_mesh, name
        assert b.dtype == a.dtype and torch.equal(a.detach(), b.to_local().detach()), name


def test_reshard_state_roundtrip(host_mesh):
    state = {"w": np.arange(8, dtype=np.float32), "b": np.ones((2, 2), np.float32)}
    specs = {"w": (None,), "b": ()}
    out = elastic.reshard_state(state, specs, host_mesh)
    np.testing.assert_array_equal(mesh_lib.full_value(out["w"]).numpy(), state["w"])
    np.testing.assert_array_equal(mesh_lib.full_value(out["b"]).numpy(), state["b"])
