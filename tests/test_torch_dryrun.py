"""Port differential: the dry-run (``repro_torch.launch.{dryrun,opcost,
roofline,report}`` and ``launch.mesh.make_production_mesh``) against
``repro.launch``.

In this process: ``model_flops`` and ``active_param_count`` for every arch ×
shape; ``roofline.build`` field by field, with the reference's three rates
set to the H100's for the comparison; the analyser's matmul FLOPs of
qwen3-0.6b SMOKE's prefill, loss and train step against the reference's
HLO ``dot`` FLOPs (trip counts included), with the difference attributed
term by term (:func:`dot_gap`); ``report`` against the reference's table.

What needs a fake default process group runs in one subprocess for the
module (:func:`fake`; this file is its ``__main__``), so that no fake group
meets the gloo groups other port tests start in the same worker, and the
imports are paid once: the production meshes on 256 and 512 fake ranks;
each rank's argument bytes of the full-size ``train_4k`` state of
qwen3-0.6b and olmoe-1b-7b on them, held against the reference's
``state_specs`` on ``AbstractMesh``; the collective bytes of a SMOKE
train step on a fake ``(2, 2)`` mesh (per-layer gathers, tensor
parallelism over ``model``) of qwen3-0.6b and falcon-mamba-7b, held
against their sum over the reference's specs; and the per-rank bytes of
that step and of a SMOKE prefill and decode, of qwen3-0.6b and of the
SSM, hybrid and enc-dec families, held below what each held when it
gathered its weights whole.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
B, S = 4, 256  # SMOKE qwen3-0.6b: a shape test_torch_models.py compiles
S_TRAIN = 64  # the fake (2, 2) train step's sequence
#: the reduced cells traced on the fake (2, 2) mesh: (kind, seq, batch), and
#: each one's per-rank bytes (arguments + the temporaries' peak) as the
#: tree before per-layer gathers and tensor parallelism traced it, when
#: every weight (and the decode cache, over ``model``) was gathered whole
SMOKE_CELLS = {"train": (S_TRAIN, B), "prefill": (256, B), "decode": (256, 8)}
WHOLE_GATHER_BYTES = {"train": 6_409_732, "prefill": 2_774_528, "decode": 2_015_312}
#: the same cells of the SSM, hybrid and enc-dec families (2 microbatches)
#: as the tree traced them that gathered each of their layers whole over
#: ``model`` (and the decode cache one layer at a time), with per-layer
#: gathers over ``data`` and no tensor parallelism
LAYER_GATHER_BYTES = {
    "falcon-mamba-7b": {"train": 3_195_140, "prefill": 7_872_000, "decode": 296_016},
    "zamba2-7b": {"train": 2_480_420, "prefill": 3_577_768, "decode": 802_744},
    "seamless-m4t-medium": {"train": 1_401_732, "prefill": 1_188_864, "decode": 1_036_880},
}
GATHER_BYTES = {"qwen3-0.6b": WHOLE_GATHER_BYTES, **LAYER_GATHER_BYTES}
FAKE_TIMEOUT_S = 240
STATE_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b")
SMOKE_MESH = {"data": 2, "model": 2}
#: the train cell's microbatches for the families whose own are 8: one row each
SMOKE_MICROBATCHES = 2


# --------------------------------------------------------------------------
# the subprocess: rank 0 on fake process groups (torch and the port only)
# --------------------------------------------------------------------------


def _smoke_overrides(arch) -> dict:
    from repro_torch.configs import get_config

    smoke = get_config(arch, smoke=True)
    out = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}
    if arch in LAYER_GATHER_BYTES:
        out["train_microbatches"] = SMOKE_MICROBATCHES
    return out


def _fake_main() -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun, mesh as mesh_lib
    from repro_torch.launch.opcost import OpCounter

    out = {"meshes": {}, "state_bytes": {}}
    for world, multi in ((256, False), (512, True)):
        mesh_lib.make_fake_group(world)
        try:
            mesh_lib.make_production_mesh(multi_pod=not multi, device="cpu")
        except RuntimeError as e:
            out["meshes"][f"refused{world}"] = str(e)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi, device="cpu")
        out["meshes"][world] = [list(mesh.shape), list(mesh.mesh_dim_names), mesh.device_type]
        for arch in STATE_ARCHS:
            lowered = dryrun.lower_cell(arch, "train_4k", mesh=mesh, device="cpu")[0]
            with lowered.fake:
                counter = OpCounter()
                out["state_bytes"][f"{arch}/{world}"] = counter.add_args(lowered.args["state"])
            del lowered
        dist.destroy_process_group()
    mesh_lib.make_fake_group(4)
    mesh = init_device_mesh("cpu", tuple(SMOKE_MESH.values()),
                           mesh_dim_names=tuple(SMOKE_MESH))
    out["smoke"] = {arch: {
        kind: dryrun.run_cell(arch, ShapeSpec(f"{kind}_smoke", *SMOKE_CELLS[kind], kind),
                              mesh=mesh, device="cpu", overrides=_smoke_overrides(arch),
                              verbose=False) for kind in SMOKE_CELLS} for arch in GATHER_BYTES}
    sort = dryrun.run_cell("olmoe-1b-7b", ShapeSpec("train_smoke", S_TRAIN, B, "train"), mesh=mesh,
                           device="cpu", verbose=False,
                           overrides={**_smoke_overrides("olmoe-1b-7b"), "moe_impl": "sort"})
    out["moe_sort_status"] = sort["status"]
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module", autouse=True)
def _fake_run():
    """The subprocess, started with the module's first test so that it runs
    beside the reference's compiles; killed if it is still running at the
    module's end."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, __file__], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def fake(_fake_run):
    out, err = _fake_run.communicate(timeout=FAKE_TIMEOUT_S)
    assert _fake_run.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


if __name__ == "__main__":
    torch.set_num_threads(1)
    print(json.dumps(_fake_main()))
    sys.exit(0)


# --------------------------------------------------------------------------
# the reference (JAX on the CPU) and this process
# --------------------------------------------------------------------------

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as JSHAPES, get_config as jget_config  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro.launch import hlo as jhlo, roofline as jroofline  # noqa: E402
from repro.launch import report as jreport  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as joptimizer, train_step as jts  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs, shape_applicable  # noqa: E402
from repro_torch.launch import opcost, report, roofline  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.train import optimizer, train_step as ts  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_active_params_and_skips(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert shape_applicable(cfg, shape) == jshape_applicable(jcfg, shape)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert roofline.model_flops(cfg, SHAPES[shape]) == jroofline.model_flops(jcfg,
                                                                              JSHAPES[shape])


@pytest.mark.parametrize("cell", [
    ("qwen2-72b", "train_4k", "16x16", 256, 3.1e15, 4.4e13, 2.2e12, {"all-gather": 960}),
    ("olmoe-1b-7b", "decode_32k", "2x16x16", 512, 7.0e9, 9.1e11, 0.0, {}),
    ("falcon-mamba-7b", "prefill_32k", "16x16", 256, 4.2e13, 1.0e9, 6.4e10,
     {"all-gather": 386, "reduce-scatter": 1}),
])
def test_roofline_build_matches_reference(monkeypatch, cell):
    """The same per-chip inputs give the same record, field by field, once
    the reference prices them at the H100's rates."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroofline, name, getattr(roofline, name))
    arch, shape, desc, chips, flops, nbytes, coll, counts = cell
    got = roofline.build(get_config(arch), SHAPES[shape], desc, chips, flops, nbytes, coll,
                         counts).to_dict()
    want = jroofline.build(jget_config(arch), JSHAPES[shape], desc, chips, flops, nbytes,
                           coll, counts).to_dict()
    assert got == want
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9


# --------------------------------------------------------------------------
# matmul FLOPs against the reference's HLO dot FLOPs
# --------------------------------------------------------------------------


def hlo_dot_flops(hlo_text: str) -> float:
    """The reference's ``dot`` FLOPs of a compiled module, each dot times
    the trip counts of the loops around it (``repro.launch.hlo``'s rules,
    dots alone)."""
    a = jhlo.HloAnalyzer(hlo_text)
    mult: dict = {}

    def walk(cname, m):
        mult[cname] = mult.get(cname, 0) + m
        for ins in a.comps.get(cname, []):
            if ins.opcode == "while":
                trips = jhlo._trip_count(ins, a.comps)
                for attr in ("body", "condition"):
                    if callee := jhlo._called(ins, attr):
                        walk(callee, m * trips)
            elif ins.opcode in ("fusion", "call", "conditional", "async-start"):
                for attr in ("calls", "to_apply", "branch_computations", "called_computations"):
                    if callee := jhlo._called(ins, attr):
                        walk(callee, m)

    walk(a.entry, 1)
    return sum(a._dot_flops(c, ins) * m for c, m in mult.items()
               for ins in a.comps[c] if ins.opcode == "dot")


def dot_gap(cfg, step: str) -> int:
    """What the reference's HLO has as ``dot``s that the port does not run
    as matmuls, less what the port runs and the reference does not, for
    qwen3-0.6b SMOKE's ``step`` on a (B, S) batch:

    * attention blocks: the reference computes every (q, kv) chunk pair
      of each forward pass and masks it (``repro/models/flash.py``); the
      port skips the pairs that are wholly masked
      (``repro_torch/models/flash.py:_fully_masked``), the n(n+1)/2 it
      keeps of n² for causal chunks of one size; 2 passes with a
      gradient (the forward and its remat);
    * XLA lowers sums of squares to ``dot``s, the port to elementwise ops
      and a reduction: RMSNorm's 2L + 1 per forward (ln1, ln2 per layer
      and the final norm; 2L more in the remat and 2L + 1 in the
      backward), the q and k norms' L each (3L with a gradient), and the
      flash backward's ``delta`` = rowsum(dO ∘ O), one per layer;
    * the loss picks each target's logit with a one-hot ``dot`` over the
      vocabulary, where the port gathers.

    The port's chunked cross-entropy recomputes the logits in its
    backward, and so does the reference's train step (its scan over
    microbatches rematerializes them); ``grad(loss_fn)`` alone keeps them,
    and its module takes the targets without the one-hot ``dot``."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.head_dim
    cq, ck = cfg.q_chunk, cfg.kv_chunk
    assert cq == ck and S % cq == 0 and cfg.window == 0
    n = S // cq
    block = 2 * (2 * B * Hq * cq * ck * D)  # QKᵀ and PV of one chunk pair
    skipped = L * (n * n - n * (n + 1) // 2) * block
    norm, qn, kn = 2 * B * S * d, 2 * B * S * Hq * D, 2 * B * S * Hkv * D
    delta = 2 * B * Hq * S * D
    onehot = 2 * B * S * V
    fwd = skipped + (2 * L + 1) * norm + L * (qn + kn)
    if step == "prefill":
        return fwd
    if step == "loss":
        return fwd + onehot
    # with a gradient (``grad(loss_fn)`` alone gives this less ``onehot``
    # and the port's recomputed ``logits``: 2·B·S·d·V)
    return 2 * skipped + (6 * L + 2) * norm + 3 * L * (qn + kn) + L * delta + onehot


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("qwen3-0.6b", smoke=True)
    cfg = get_config("qwen3-0.6b", smoke=True)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree


def _reference_module(jcfg, jparams, step: str) -> str:
    tok = {"tokens": jnp.zeros((B, S), jnp.int32)}
    if step == "prefill":
        fn, args = (lambda p, b: jmodel.prefill(jcfg, p, b, S)), (jparams, tok)
    elif step == "loss":
        fn, args = (lambda p, b: jmodel.loss_fn(jcfg, p, b)), (jparams, tok)
    else:
        oc = joptimizer.OptConfig()
        state = {"params": jparams, "opt": joptimizer.init(jparams)}
        fn = jts.make_train_step(jcfg, oc, microbatches=jcfg.train_microbatches)
        args = (state, tok)
    return jax.jit(fn).lower(*args).compile().as_text()


def _port_matmul_flops(cfg, tree, step: str) -> float:
    tok = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    counter = opcost.OpCounter()
    if step in ("prefill", "loss"):
        params = model.params_from_numpy(cfg, tree, device="cpu")
        with counter, torch.no_grad():
            if step == "prefill":
                model.prefill(cfg, params, tok, S)
            else:
                model.loss_fn(cfg, params, tok)
    else:
        oc = optimizer.OptConfig()
        state = ts.init_state(cfg, 0, oc, device="cpu")
        step_fn = ts.make_train_step(cfg, oc, microbatches=cfg.train_microbatches)
        with counter:
            step_fn(state, tok)
    return counter.matmul_flops


@pytest.mark.parametrize("step", ["prefill", "loss", "train_step"])
def test_matmul_flops_are_the_reference_dots_less_the_attributed_gap(smoke, step):
    jcfg, cfg, jparams, tree = smoke
    want = hlo_dot_flops(_reference_module(jcfg, jparams, step))
    got = _port_matmul_flops(cfg, tree, step)
    assert want - got == dot_gap(cfg, step), (want, got)


# --------------------------------------------------------------------------
# the report
# --------------------------------------------------------------------------


def _rows() -> list:
    rl = {"t_compute": 0.0123, "t_memory": 1.5, "t_collective": 2.25e-3, "bottleneck": "memory",
          "useful_flop_ratio": 0.0345, "roofline_frac": 0.00257}
    return [
        {"arch": "qwen3-0.6b", "shape": "train_4k", "status": "ok", "per_chip_gb": 19.246,
         "tpu_projected_gb": 18.0, "roofline": rl},
        {"arch": "qwen3-0.6b", "shape": "long_500k", "status": "skip", "reason": "x"},
        {"arch": "zamba2-7b", "shape": "decode_32k", "status": "error", "error": "y"},
        {"arch": "olmoe-1b-7b", "shape": "prefill_32k", "status": "ok", "per_chip_gb": 3.5,
         "tpu_projected_gb": 3.0, "roofline": dict(rl, bottleneck="compute")},
    ]


@pytest.mark.parametrize("md", [False, True])
def test_report_is_the_reference_table_without_its_tpu_column(tmp_path, monkeypatch, md):
    path = tmp_path / "rows.json"
    path.write_text(json.dumps(_rows()))
    monkeypatch.setattr(sys, "argv", ["report", str(path)] + (["--md"] if md else []))
    buf = io.StringIO()
    with redirect_stdout(buf):
        jreport.main()
    want = buf.getvalue().rstrip("\n").splitlines()
    got = report.render(_rows(), md).splitlines()
    assert len(got) == len(want)
    tpu = 3  # "TPU GB", after arch, shape and GB/chip
    for w, g in zip(want, got):
        if md and w.startswith("|---"):
            assert g == "|" + "---|" * len(report.HEADER)
        elif md:
            cells = w.strip("| ").split(" | ")
            assert g.strip("| ").split(" | ") == cells[:tpu] + cells[tpu + 1:]
        elif w.startswith("arch"):  # the header: "TPU GB" is two words
            words = w.split()
            assert g.split() == words[:tpu] + words[tpu + 2:]
        elif w.startswith(("qwen", "zamba", "olmoe")):
            words = w.split()
            if words[-1] in ("SKIP", "ERROR"):  # a row of dashes: one fewer
                assert g.split() == words[:-2] + words[-1:]
            else:
                assert g.split() == words[:tpu] + words[tpu + 1:]
        else:
            assert g == w


# --------------------------------------------------------------------------
# on fake process groups (the subprocess)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("world", ["256", "512"])
def test_production_mesh_shapes(fake, world):
    jmesh = {"256": ((16, 16), ("data", "model")),
             "512": ((2, 16, 16), ("pod", "data", "model"))}[world]
    shape, names, kind = fake["meshes"][world]
    assert (tuple(shape), tuple(names), kind) == jmesh + ("cpu",)
    assert "process group of" in fake["meshes"][f"refused{world}"]


def _reference_state_bytes(arch, axes, sizes) -> int:
    """One chip's bytes of the reference's ``train_4k`` state as its
    ``state_specs`` shard it on ``AbstractMesh``."""
    jcfg = jget_config(arch)
    mesh = AbstractMesh(sizes, axes)
    state = jax.eval_shape(lambda: jts.init_state(jcfg, jax.random.PRNGKey(0),
                                                  joptimizer.OptConfig()))
    specs = jts.state_specs(jcfg, state, mesh)
    size = dict(zip(axes, sizes))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(state), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = int(np.prod(leaf.shape, dtype=np.int64))
        for entry in spec:
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                n //= size[a]
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("world", ["256", "512"])
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_fake_state_bytes_per_rank_are_the_reference_shards(fake, arch, world):
    axes, sizes = {"256": (("data", "model"), (16, 16)),
                   "512": (("pod", "data", "model"), (2, 16, 16))}[world]
    assert fake["state_bytes"][f"{arch}/{world}"] == _reference_state_bytes(arch, axes, sizes)


def _analytic_collectives(jcfg) -> dict:
    """One rank's link bytes of the sharded train step on (data, model) =
    (2, 2), over the reference's ``state_specs``, ``train_microbatches``
    microbatches of one row each.  Per microbatch: each float32 weight
    that ``data`` shards is gathered over ``data`` (whole along ``data``,
    the rank's block along ``model``: the full bytes over ``model``, less
    the local), a layer's twice (its remat recomputes it), and its
    gradient reduce-scattered back (the same bytes); the gradient of a
    weight that ``data`` does not shard is all-reduced over ``data``
    (2·|p|·(n−1)/n of the rank's block), and over ``model`` too for the q
    and k norms (each rank normalizes its own heads).  The activations'
    all-reduces over ``model``, in the compute dtype, per layer: in the
    transformer, (rows, S, d) two in the backward (the gradients entering
    attention and the FFN) and two partial sums in the forward, one more
    in the recompute (the checkpoint stops before the FFN's); in Mamba-1,
    ``out_proj``'s partial sums in the forward and the gradient entering
    ``in_proj`` in the backward, (rows, S, d), and ``x_proj``'s partial
    sums (rows, S, dt_rank + 2N) in the forward, its recompute and, as a
    gradient, the backward.  Then the cross-entropy's input gradient; the
    vocabulary-parallel lookup's rows in float32 (the master table's);
    the cross-entropy's row max, sum of exponentials and target logit per
    chunk, float32; the loss over ``data``, and the gradient norm's local
    sums over each mesh dim that shards them, one stack per placement
    pattern.  Mamba-1's all-to-alls, ``|in|·(n−1)/n`` each: ``in_proj``'s
    and ``x_proj``'s blocks re-laid in the compute dtype, in the forward,
    the recompute and the backward."""
    axes, sizes = tuple(SMOKE_MESH), tuple(SMOKE_MESH.values())
    mesh = AbstractMesh(sizes, axes)
    state = jax.eval_shape(lambda: jts.init_state(jcfg, jax.random.PRNGKey(0),
                                                  joptimizer.OptConfig()))
    params, specs = state["params"], jts.state_specs(jcfg, state, mesh)["params"]
    nd, nm = SMOKE_MESH["data"], SMOKE_MESH["model"]
    mb, L = jcfg.train_microbatches, jcfg.n_layers
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    groups: dict = {}
    spec_of = dict((tuple(str(k) for k in p), s) for p, s in jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = spec_of[tuple(str(k) for k in path)]
        stacked = str(path[0]) == "['layers']"
        layers = leaf.shape[0] if stacked else 1
        one = int(np.prod(leaf.shape)) * 4 // layers
        used = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
        if "data" in used:
            block = one // nm if "model" in used else one
            link = block - block // nd
            out["all-gather"] += mb * layers * (2 if stacked else 1) * link
            out["reduce-scatter"] += mb * layers * link
        else:
            norm = str(path[-1]) in ("['q_norm']", "['k_norm']")
            block = one // nm if "model" in used else one
            out["all-reduce"] += mb * layers * 2 * block * (nd - 1) / nd * (2 if norm else 1)
        if used:  # one gradient-norm sum per layer of the stacked leaf
            key = tuple(a in used for a in axes)
            groups[key] = groups.get(key, 0) + layers
    rows, d = B // nd // mb, jcfg.d_model
    item = jnp.dtype(jcfg.dtype).itemsize
    act = rows * S_TRAIN * d * item
    chunks = S_TRAIN // jcfg.ce_chunk
    ar = 2 * (nm - 1) / nm
    layer = 5 * act
    if jcfg.family == "ssm":
        di, xw = jcfg.ssm_expand * d, d // 16 + 2 * jcfg.ssm_state  # d_inner, x_proj's width
        layer = 2 * act + 3 * rows * S_TRAIN * xw * item
        out["all-to-all"] = mb * L * 3 * (d * 2 * di + di * xw) // nm * item * (nm - 1) / nm
    out["all-reduce"] += mb * ar * (L * layer + act + rows * S_TRAIN * d * 4
                                    + chunks * 3 * rows * jcfg.ce_chunk * 4)
    out["all-reduce"] += 2 * 4 * (nd - 1) / nd  # the loss
    for key, count in groups.items():
        for a, sharded in zip(axes, key):
            if sharded:
                out["all-reduce"] += 2 * 4 * count * (SMOKE_MESH[a] - 1) / SMOKE_MESH[a]
    return out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_smoke_step_collective_bytes_are_the_analytic_sum(fake, arch):
    rec = fake["smoke"][arch]["train"]
    assert rec["status"] == "ok" and rec["dtensor_ops"] == 0
    overrides = {"train_microbatches": SMOKE_MICROBATCHES} if arch in LAYER_GATHER_BYTES else {}
    want = _analytic_collectives(jget_config(arch, smoke=True, **overrides))
    assert rec["coll_by_kind_bytes"] == want
    assert rec["roofline"]["coll_bytes"] == sum(want.values()) * rec["chips"]


@pytest.mark.parametrize("kind", list(SMOKE_CELLS))
@pytest.mark.parametrize("arch", list(GATHER_BYTES))
def test_smoke_cells_hold_less_per_rank_than_whole_gathers(fake, arch, kind):
    """Per-layer gathers and tensor parallelism: each reduced cell on the
    fake (2, 2) mesh holds less per rank than it did with its weights
    gathered whole (qwen3-0.6b: the whole model at once; the SSM, hybrid
    and enc-dec families: each layer whole over ``model``), with no
    DTensor op."""
    rec = fake["smoke"][arch][kind]
    assert rec["status"] == "ok" and rec["dtensor_ops"] == 0
    assert rec["per_chip_bytes"] < GATHER_BYTES[arch][kind]


def test_smoke_record_has_the_reference_keys(fake):
    rec = fake["smoke"]["qwen3-0.6b"]["train"]
    want = {"arch", "shape", "mesh", "chips", "status", "per_chip_bytes", "per_chip_gb",
            "arg_gb", "temp_gb", "xla_flops_per_chip", "roofline"}  # less lower_s, compile_s
    assert want | {"trace_s"} <= set(rec) and "tpu_projected_gb" not in rec
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["per_chip_bytes"] == rec["arg_bytes"] + rec["temp_bytes"]
    assert set(rec["roofline"]) == set(dataclasses.asdict(jroofline.Roofline(
        *(None,) * len(dataclasses.fields(jroofline.Roofline)))))


def test_moe_sort_dispatch_traces_on_fake_tensors(fake):
    assert fake["moe_sort_status"] == "ok"


def test_opcost_rules_on_small_ops():
    """Matmul, elementwise, reduction, view, allocation and partial-write
    rules on real CPU tensors (float32: 4 bytes an element)."""
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    c = opcost.OpCounter()
    with c:
        y = a @ b  # mm: 2·4·3·8 FLOPs; reads 32 + 24, writes 12 elements
        z = y + 1  # add: 12 FLOPs; reads 12, writes 12
        s = z.sum()  # a reduction: its operand's 48 bytes / 4 FLOPs; reads 12, writes 1
        v = z.view(3, 4).t()  # views: nothing
        buf = torch.zeros(10, 3)  # writes 30
        buf[torch.tensor([1, 5])] = y[:2]  # reads 2 int64 indices and 6 values, writes 6
    assert v.shape == (4, 3) and s.item() == 4 * 3 * 9
    assert c.matmul_flops == 2 * 4 * 3 * 8
    assert c.costs.flops == c.matmul_flops + 12 + 48 / 4
    assert c.costs.bytes == 4 * (32 + 24 + 12) + 4 * (12 + 12) + 4 * (12 + 1) + 4 * 30 \
        + (2 * 8 + 4 * 6 + 4 * 6)
    assert c.costs.coll_bytes == 0
    assert c.temp_peak_bytes >= 4 * (12 + 12 + 30)
