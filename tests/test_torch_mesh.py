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
  unsharded step and ``repro``'s ``make_train_step``, within 1e-5 (each
  layer gathered over ``data`` as it runs, tensor-parallel over
  ``model``; the parameters over the elements their gradients settle,
  :func:`_settled`), the gathered bytes live at once read from
  ``models.parallel.STATS``; the loss and gradients of the olmoe-1b-7b
  (MoE), phi4-mini-3.8b (1.5 q heads and half a KV head per ``model``
  rank), falcon-mamba-7b (Mamba-1 on the rank's ``d_inner`` slice),
  zamba2-7b (Mamba-2 on the rank's heads, the shared block's heads) and
  seamless-m4t-medium (enc-dec) SMOKE configs against their unsharded
  ones; on ``(1, 1)`` the qwen3-0.6b and zamba2-7b steps bit for bit the
  unsharded ones;
* the vocabulary-parallel cross-entropy over ``model`` against
  ``_ChunkedCE`` on one rank;
* sharded prefill and decode on ``(2, 2)`` and ``(4, 1)`` of the
  qwen3-0.6b, olmoe-1b-7b, phi4-mini-3.8b, zamba2-7b, falcon-mamba-7b and
  seamless-m4t-medium SMOKE configs against each rank's rows of the
  unsharded calls, no SSM state gathered over ``model``
  (``models.parallel.CACHE_GATHERS``);
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
from repro_torch.models import layers, model, moe, parallel, transformer  # noqa: E402
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
    parallel.reset_stats()
    cfg, state, out["metrics"], out["first"], out["grads"] = _train(m22, 0.0, 2, grads=True)
    out["gathered_peak"] = parallel.STATS["params_peak"]
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


# MoE experts; q and KV heads split by model; Mamba-1's d_inner; Mamba-2's
# heads and the shared block's; the encoder's and decoder's heads
TP_ARCHS = ("olmoe-1b-7b", "phi4-mini-3.8b", "falcon-mamba-7b", "zamba2-7b",
            "seamless-m4t-medium")
ONE_RANK_ARCHS = ("qwen3-0.6b", "zamba2-7b")  # (1, 1): tensor-parallel family; shared block


def _grads_of(arch, mesh=None):
    """The loss and gradients (numpy, full values) of ``arch``'s SMOKE
    float32 parameters on a ``TRAIN`` batch in 2 microbatches, placed on
    ``mesh`` (or not)."""
    cfg = get_config(arch, smoke=True, dtype="float32")
    params = ts.init_state(cfg, 0, OPT, device="cpu")["params"]
    if mesh is not None:
        params = elastic.reshard_state({"params": params}, {"params": model.partition_specs(
            cfg, params, mesh)}, mesh)["params"]
    batch = synthetic.token_batch(cfg, "train", TRAIN["batch"], TRAIN["seq"], 0, device="cpu")
    loss, grads = ts.loss_and_grads(cfg, params, batch, 2)
    return float(loss), [mesh_lib.full_value(g).detach().numpy() for g in grads]


def _rank_tp(rank, m22, m11) -> dict:
    out = {arch: _grads_of(arch, m22) for arch in TP_ARCHS}
    if rank == 0:
        out["one_rank"] = {arch: _grads_of(arch, m11) for arch in ONE_RANK_ARCHS}
    return out


def _ce_inputs():
    cfg = _cfg()
    rng = np.random.default_rng(9)
    B, S, d, V = 2, 40, cfg.d_model, cfg.vocab  # S: a last chunk shorter than ce_chunk
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (0.1 * rng.standard_normal((d, V))).astype(np.float32)
    targets = rng.integers(0, V, (B, S))
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    return cfg, hidden, w, targets, mask


def _rank_vocab_ce(m22) -> dict:
    """``_ChunkedCE`` vocabulary-parallel over ``model`` of (2, 2), each
    rank its half of the vocabulary's columns: the loss, the whole input
    gradient, its own block of the weight's gradient."""
    cfg, hidden, w, targets, mask = _ce_inputs()
    tp = parallel.Shards(m22, split=False).tp
    h = torch.from_numpy(hidden).requires_grad_(True)
    wl = torch.from_numpy(np.split(w, tp.size, axis=1)[tp.rank]).requires_grad_(True)
    loss = transformer._ChunkedCE.apply(h, wl, torch.from_numpy(targets),
                                        torch.from_numpy(mask), cfg.ce_chunk, tp)
    loss.backward()
    return {"loss": float(loss), "dh": h.grad.numpy(), "dw": wl.grad.numpy(), "part": tp.rank}


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


# a KV cache, tensor-parallel (dense, MoE; phi4-mini's 3 q heads and 1 KV
# head split by 2 ``model`` ranks: K and V gathered from half-head column
# blocks in prefill, q heads split in decode; the encoder-decoder's self
# and cross caches); the SSM state, ``N``-sharded (Mamba-1; the hybrid's
# grouped state, batch on dim 2, beside its shared block's KV cache)
SERVE_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "phi4-mini-3.8b", "zamba2-7b", "falcon-mamba-7b",
               "seamless-m4t-medium")
SERVE = {"B": 4, "S": 24, "max_len": 40, "frames": 12}


def _serve_inputs(arch):
    """Float32 SMOKE weights, a prompt batch (with stub frame embeddings
    for the enc-dec family) and one decode token, the same on every rank
    (and in the test's process)."""
    cfg = get_config(arch, smoke=True, dtype="float32")
    params = model.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE["B"], SERVE["S"] + 1))
                              .astype(np.int32))
    batch = {"tokens": tokens[:, :-1]}
    if cfg.family == "audio":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (SERVE["B"], SERVE["frames"], cfg.d_model)).astype(np.float32))
    return cfg, params, batch, tokens[:, -1:]


def _rank_serve(m22, m41) -> dict:
    """Sharded prefill and one decode step on (2, 2), and on (4, 1) under
    ``"4x1"``: each rank's logits (its batch rows) and each cache leaf
    gathered over ``model`` only (its rows, whole), with the placements
    they came back in."""
    out = {"4x1": _rank_serve(m41, None)} if m41 is not None else {}
    with torch.no_grad():
        for arch in SERVE_ARCHS:
            cfg, params, batch, tok = _serve_inputs(arch)
            sharded = elastic.reshard_state(
                {"params": params}, {"params": model.partition_specs(cfg, params, m22)},
                m22)["params"]
            batch = elastic.reshard_state(batch, model.batch_specs(cfg, batch, m22), m22)
            tok = elastic.reshard_state({"t": tok}, {"t": model.batch_specs(
                cfg, {"t": tok}, m22)["t"]}, m22)["t"]
            parallel.reset_stats()
            cache, logits = model.prefill(cfg, sharded, batch, SERVE["max_len"])
            # a copy: decode writes the local cache in place, and with one
            # ``model`` rank the gather is the local tensor itself
            got = {"prefill": ({k: mesh_lib.full_value(v, over=("model",)).numpy().copy()
                                for k, v in cache.items()}, logits.to_local().numpy())}
            cache, logits = model.decode_step(cfg, sharded, cache, tok)
            got["gathered_peak"] = {k: parallel.STATS[f"{k}_peak"] for k in ("params", "cache")}
            got["cache_gathers"] = dict(parallel.CACHE_GATHERS)
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
           "constrain": _rank_constrain(m22), "serve": _rank_serve(m22, m41),
           "tp": _rank_tp(rank, m22, m11), "vocab_ce": _rank_vocab_ce(m22),
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


def _worst(want: dict, got: dict, metric=rel_max, *rest) -> float:
    return max(jax.tree.leaves(jax.tree.map(metric, want, got, *rest)))


def _settled(*grads) -> np.ndarray:
    """The elements of a leaf whose AdamW steps the gradient comparisons
    fix: not those whose gradient at some step is nonzero yet within
    ``TOL`` of zero relative to the leaf's largest, the bound to which the
    sharded steps' gradients are held.  AdamW moves an element by about
    lr·g/(|g| + eps), so its sign alone, a rounding there, decides a move
    of up to lr."""
    out = True
    for g in grads:
        a = np.abs(np.asarray(g))
        out = out & ~((a > 0) & (a <= TOL * a.max()))
    return np.broadcast_to(out, np.shape(grads[0]))


def _worst_settled(ref: dict, got: dict) -> float:
    """The worst ``rel_l2`` of the parameters after the steps over the
    elements each step's unsharded gradients settle (:func:`_settled`,
    which must leave out fewer than one in 10³ of them)."""
    settled = jax.tree.map(_settled, *ref["grads"])
    n_out = sum(int((~m).sum()) for m in jax.tree.leaves(settled))
    assert n_out <= 1e-3 * sum(m.size for m in jax.tree.leaves(settled)), n_out
    return _worst(ref["params"], got, lambda w, g, m: rel_l2(np.asarray(w)[m], np.asarray(g)[m]),
                  settled)


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
        losses, jlosses, norms, jfirst, grads = [], [], [], None, []
        for i in range(TRAIN["steps"]):
            batch = synthetic.token_batch(cfg, "train", TRAIN["batch"], TRAIN["seq"], i,
                                          device="cpu")
            _, gs = ts.loss_and_grads(cfg, state["params"], batch, mb)
            grads.append(model.params_to_numpy(mesh_lib.module_with(state["params"], {
                n: g for (n, _), g in zip(state["params"].named_parameters(), gs)}, False)))
            state, m = step(state, batch)
            jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"].numpy())})
            losses.append(float(m["loss"]))
            jlosses.append(float(jm["loss"]))
            norms.append(float(m["grad_norm"]))
            jfirst = jfirst or jax.tree.map(np.asarray, jstate["params"])
        out[label] = {"losses": losses, "grad_norms": norms, "grads": grads,
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
        assert _worst_settled(ref, r["train"][skey]["params"]) <= TOL
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
    """Each rank of (2, 2) runs its batch shard (``data``), each layer's
    weights gathered as it runs: its logits and its rows of the new cache
    are the unsharded prefill and decode of those rows, within ``TOL``:
    every family computes tensor-parallel over ``model`` (partial sums
    added in another order); the cache comes back in ``cache_specs``'
    placements (``len`` replicated)."""
    _check_serve(ranks, arch, "2x2", {"data": 2, "model": 2}, exact=False)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_on_4x1_are_each_ranks_unsharded_rows(ranks, arch):
    """(4, 1): one row per rank, each layer gathered over ``data``, no
    ``model`` split: each rank's logits and cache rows are the unsharded
    call's on its row, bit for bit."""
    _check_serve(ranks, arch, "4x1", {"data": 4, "model": 1}, exact=True)


def _check_serve(ranks, arch, label, sizes, exact):
    cfg, params, batch, tok = _serve_inputs(arch)
    half = SERVE["B"] // sizes["data"]

    def same(want, got):
        return np.array_equal(got, want) if exact or want.dtype.kind == "i" else \
            rel_max(want, got) <= TOL
    with torch.no_grad():
        for r in ranks:
            coord = r["coord"][0] if label == "2x2" else r["rank"]
            rows = slice(coord * half, (coord + 1) * half)
            cache, logits = model.prefill(cfg, params, {k: v[rows] for k, v in batch.items()},
                                          SERVE["max_len"])
            want = {"prefill": ({k: v.numpy().copy() for k, v in cache.items()},
                                logits.numpy())}
            cache, logits = model.decode_step(cfg, params, cache, tok[rows])
            want["decode"] = ({k: v.numpy() for k, v in cache.items()}, logits.numpy())
            got = r["serve"][arch] if label == "2x2" else r["serve"]["4x1"][arch]
            for step in ("prefill", "decode"):
                (gc_, gl), (wc, wl) = got[step], want[step]
                assert same(wl, gl), (arch, step, r["rank"])
                assert gc_.keys() == wc.keys()
                for k in wc:  # ``len`` is replicated: every rank holds all rows
                    g = gc_[k][rows] if k == "len" else gc_[k]
                    assert same(wc[k], g), (arch, step, k, r["rank"])
            specs = model.cache_specs(cfg, model.init_cache(
                cfg, SERVE["B"], SERVE["max_len"], device="meta"), sizes)
            assert got["placements"] == {k: tuple(map(str, model.placements(v, sizes)))
                                         for k, v in specs.items()}
            assert got["placements"]["len"] == ("R", "R")
            assert got["logit_placements"] == ("S(0)", "R")


def _layer_bytes(params) -> int:
    """The most bytes of one layer's parameters (a layer, or the hybrid's
    shared block), plus the larger of ``embed`` and ``lm_head``."""
    def nbytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())

    layers = [params.shared, *params.mamba_layers()] if hasattr(params, "shared") else [
        *getattr(params, "layers", ()), *getattr(params, "enc_layers", ()),
        *getattr(params, "dec_layers", ())]
    layer = max(nbytes(lp) for lp in layers)
    return layer + max(nbytes_ for nbytes_ in (params.embed.numel() * params.embed.element_size(),
                                              params.lm_head.numel() * 4))


def _layer_cache_bytes(cfg) -> int:
    """The most bytes of one layer's cache leaves that a decode step may
    gather together (its KV cache, or the hybrid's conv window), for one
    rank's rows, whole over ``model``."""
    cache = model.init_cache(cfg, SERVE["B"] // 2, SERVE["max_len"], device="meta")
    groups = (("k", "v"), ("attn_k", "attn_v"), ("conv",), ("conv_tail",))
    out = 0
    for group in groups:
        if group[0] in cache:
            out = max(out, sum(cache[k].numel() * cache[k].element_size()
                               // int(np.prod(cache[k].shape[:model.cache_batch_dim(
                                   k, cache[k].shape)])) for k in group))
    return out


@pytest.mark.parametrize("run", ("train",) + SERVE_ARCHS)
def test_gathered_bytes_stay_within_one_layer(ranks, run):
    """The gather's counter (``parallel.STATS``): no rank holds more than
    one layer's gathered parameters, plus ``embed`` or ``lm_head``, at
    once in the (2, 2) train step or in prefill and decode; nor more than
    one layer's gathered cache: decode reads each rank's ``head_dim``
    slice of a KV cache and ``N`` slice of an SSM state, and gathers only
    the hybrid's conv windows, split over ``model`` in blocks that do not
    follow its heads (``parallel.CACHE_GATHERS``)."""
    if run == "train":
        params = ts.init_state(_cfg(), 0, OPT, device="cpu")["params"]
        peaks = [r["train"]["gathered_peak"] for r in ranks]
        assert all(0 < p <= _layer_bytes(params) for p in peaks), peaks
        return
    cfg, params, _, _ = _serve_inputs(run)
    peaks = [r["serve"][run]["gathered_peak"] for r in ranks]
    assert all(0 < p["params"] <= _layer_bytes(params) for p in peaks), peaks
    hybrid = cfg.family == "hybrid"
    assert all(set(r["serve"][run]["cache_gathers"]) <= ({"conv", "conv_tail"} if hybrid
                                                          else set()) for r in ranks)
    if hybrid:
        assert all(0 < p["cache"] <= _layer_cache_bytes(cfg) for p in peaks), peaks
    else:
        assert all(p["cache"] == 0 for p in peaks), peaks


@pytest.fixture(scope="module")
def unsharded_grads():
    return {arch: _grads_of(arch) for arch in TP_ARCHS + ONE_RANK_ARCHS}


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_families_match_their_unsharded_gradients(ranks, unsharded_grads, arch):
    """olmoe-1b-7b's experts, phi4-mini-3.8b's heads (3 q heads, 1 KV
    head on 2 ``model`` ranks: the rank's ``wq`` columns and its ``wk``,
    ``wv`` columns split heads), falcon-mamba-7b's ``d_inner``, zamba2-7b's
    Mamba-2 and shared-block heads and seamless-m4t-medium's encoder and
    decoder heads on (2, 2): the loss and every gradient within ``TOL`` of
    the unsharded step's."""
    loss, grads = unsharded_grads[arch]
    for r in ranks:
        got_loss, got = r["tp"][arch]
        assert got_loss == pytest.approx(loss, rel=TOL, abs=0)
        for want, g in zip(grads, got, strict=True):
            assert rel_max(want, g) <= TOL


@pytest.mark.parametrize("arch", ONE_RANK_ARCHS)
def test_one_rank_mesh_step_is_the_unsharded_step_bit_for_bit(ranks, unsharded_grads, arch):
    loss, grads = unsharded_grads[arch]
    got_loss, got = ranks[0]["tp"]["one_rank"][arch]
    assert got_loss == loss
    assert all(np.array_equal(w, g) for w, g in zip(grads, got, strict=True))


def test_vocab_parallel_cross_entropy_matches_chunked_ce(ranks):
    """Each ``model`` rank of (2, 2) holds half of ``lm_head``'s columns:
    the loss and the input gradient are ``_ChunkedCE``'s on one rank, and
    each rank's weight gradient is its block of the whole one."""
    cfg, hidden, w, targets, mask = _ce_inputs()
    h = torch.from_numpy(hidden).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = transformer._ChunkedCE.apply(h, wt, torch.from_numpy(targets),
                                        torch.from_numpy(mask), cfg.ce_chunk)
    loss.backward()
    for r in ranks:
        got = r["vocab_ce"]
        assert got["loss"] == pytest.approx(float(loss.detach()), rel=TOL, abs=0)
        assert rel_max(h.grad.numpy(), got["dh"]) <= TOL
        want_dw = np.split(wt.grad.numpy(), 2, axis=1)[got["part"]]
        assert rel_max(want_dw, got["dw"]) <= TOL


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
