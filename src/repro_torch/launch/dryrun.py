"""Multi-pod dry-run: trace every (arch × shape) as rank 0 of the production
mesh on fake tensors, and derive the roofline terms from the op counts.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for 512 placeholder host devices; the port starts a
``"fake"`` process group of 256 or 512 ranks (``launch.mesh.make_fake_group``,
before anything else touches ``torch.distributed``, as the reference sets
``XLA_FLAGS`` first), builds the production mesh on it, and runs rank 0's
step under ``FakeTensorMode``: every op runs on shapes alone, every
collective returns at once, nothing is allocated.

Per cell:
  1. resolve config + shape, check applicability (the long_500k skip rules);
  2. build the step on fake tensors: ``train_4k`` → ``ts.init_state``
     placed by ``state_specs``, the batch by ``batch_specs``, one
     ``make_train_step(..., microbatches=cfg.train_microbatches)`` call;
     ``prefill_32k`` → ``model.prefill``; decode shapes → one
     ``model.decode_step`` against a full cache placed by ``cache_specs``;
     serving weights are held in ``cfg.dtype`` as the port serves them
     (the reference lowers float32 parameters and casts them at use) and
     placed by ``partition_specs``.  Sharded steps compute what the
     placements give the rank (``models.parallel``): each layer's weights
     are gathered over the FSDP axes as the layer runs, the transformer
     families compute tensor-parallel over ``model``, and each rank runs
     its batch rows (``train_step``, ``model._sharded_serve``);
  3. run it once under :class:`~repro_torch.launch.opcost.OpCounter`;
  4. record the rank's bytes (its arguments, the peak of its temporaries)
     and the op counts, feeding the three-term roofline
     (:mod:`repro_torch.launch.roofline`, the H100's data-sheet rates).

The record has the reference's keys but ``tpu_projected_gb`` (a fix for
XLA:CPU's bf16 legalization, which a fake trace does not have);
``lower_s`` and ``compile_s`` are one ``trace_s``, and
``xla_flops_per_chip`` holds the framework's own FLOP count, the matmul
FLOPs of ``torch.utils.flop_counter``'s registry.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --cell qwen2-72b:train_4k --cell olmoe-1b-7b:decode_32k \
      --jobs 2 --out results.json --device cpu
  python -m repro_torch.launch.dryrun --all [--multi-pod] --out results.json --device cpu
"""
from __future__ import annotations

import argparse
import gc
import json
import time
import traceback
from dataclasses import dataclass

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_archs, shape_applicable
from repro_torch.core.relation import resolve_device
from repro_torch.ft import elastic
from repro_torch.launch import mesh as mesh_lib, roofline as roofline_lib
from repro_torch.launch.opcost import OpCounter
from repro_torch.models import layers, model
from repro_torch.train import optimizer, train_step as ts


@dataclass
class Lowered:
    """A cell's step on fake tensors: ``fn()`` runs it on ``args``."""

    fake: object  # the FakeTensorMode the arguments belong to
    args: dict
    fn: object


def _fake_inputs(specs: dict, device) -> dict:
    """Zeros of each ``meta`` tensor's shape and dtype on ``device`` (fake
    under the active ``FakeTensorMode``)."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}


def place_inputs(cfg, shape: ShapeSpec, mesh, device) -> dict:
    """The cell's inputs (``model.input_specs``) as zeros on ``device``,
    placed on ``mesh`` by ``batch_specs`` and, for decode, the cache by
    ``cache_specs``: ``{"batch": ..., "cache": ...}``."""
    specs = model.input_specs(cfg, shape)
    cache = specs.pop("cache", None)
    out = {"batch": elastic.reshard_state(_fake_inputs(specs, device),
                                          model.batch_specs(cfg, specs, mesh), mesh)}
    if cache is not None:
        out["cache"] = elastic.reshard_state(_fake_inputs(cache, device),
                                             model.cache_specs(cfg, cache, mesh), mesh)
    return out


def serving_params(cfg, mesh, device):
    """Weights in ``cfg.dtype`` placed by ``partition_specs``."""
    params = model.init_params(cfg, 0, device=device)
    return elastic.reshard_state({"params": params},
                                 {"params": model.partition_specs(cfg, params, mesh)},
                                 mesh)["params"]


def lower_cell(arch: str, shape, *, multi_pod: bool = False, overrides: dict | None = None,
               mesh=None, device=None):
    """Returns (lowered, cfg, shape, mesh); raises on inapplicable shapes.
    ``shape`` is a ``SHAPES`` name or a ``ShapeSpec``; ``mesh`` defaults to
    the production mesh on the current (fake) group."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch, **(overrides or {}))
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, reason = shape_applicable(cfg, shape.name)
    if not ok:
        raise ValueError(f"skip: {reason}")
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else mesh_lib.make_production_mesh(
        multi_pod=multi_pod, device=dev.type)
    layers.set_activation_batch_axes(model.batch_axes(mesh),
                                     seq_axis="model" if cfg.seq_shard else None)
    fake = FakeTensorMode()
    with fake:
        inputs = place_inputs(cfg, shape, mesh, dev)
        if shape.kind == "train":
            opt_cfg = optimizer.OptConfig()
            state = ts.init_state(cfg, 0, opt_cfg, device=dev)
            state = elastic.reshard_state(state, ts.state_specs(cfg, state, mesh), mesh)
            step = ts.make_train_step(cfg, opt_cfg, microbatches=cfg.train_microbatches)
            args = {"state": state, "batch": inputs["batch"]}
            fn = lambda: step(args["state"], args["batch"])  # noqa: E731
        elif shape.kind == "prefill":
            args = {"params": serving_params(cfg, mesh, dev), "batch": inputs["batch"]}

            def fn():
                with torch.no_grad():
                    return model.prefill(cfg, args["params"], args["batch"], shape.seq_len)
        else:  # decode
            args = {"params": serving_params(cfg, mesh, dev), "cache": inputs["cache"],
                    "tokens": inputs["batch"]["tokens"]}

            def fn():
                with torch.no_grad():
                    return model.decode_step(cfg, args["params"], args["cache"], args["tokens"])
    return Lowered(fake, args, fn), cfg, shape, mesh


def mesh_desc(mesh) -> str:
    return "x".join(map(str, mesh.shape))


def _gb(n: float) -> float:
    return round(n / 2**30, 3)


def run_cell(arch: str, shape, *, multi_pod: bool = False, overrides: dict | None = None,
             mesh=None, device=None, verbose: bool = True) -> dict:
    t0 = time.time()
    lowered, cfg, shape, mesh = lower_cell(arch, shape, multi_pod=multi_pod,
                                           overrides=overrides, mesh=mesh, device=device)
    counter = OpCounter()
    try:
        with lowered.fake:
            counter.add_args(lowered.args)
            with counter:
                out = lowered.fn()
            del out
    finally:
        layers.set_activation_batch_axes(None)
    trace_s = time.time() - t0
    costs = counter.costs
    chips = mesh.size()
    rl = roofline_lib.build(cfg, shape, mesh_desc(mesh), chips, costs.flops, costs.bytes,
                            costs.coll_bytes, costs.coll_counts)
    per_rank = counter.arg_bytes + counter.temp_peak_bytes
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_desc(mesh), "chips": chips,
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "per_chip_bytes": int(per_rank),
        "per_chip_gb": _gb(per_rank),
        "arg_gb": _gb(counter.arg_bytes),
        "temp_gb": _gb(counter.temp_peak_bytes),
        "arg_bytes": int(counter.arg_bytes),
        "temp_bytes": int(counter.temp_peak_bytes),
        # the framework's own count, as the reference's XLA cost analysis:
        # torch's flop_counter registry (matmuls and convolutions)
        "xla_flops_per_chip": counter.matmul_flops,
        "n_ops": counter.n_ops,
        "dtensor_ops": counter.dtensor_ops,
        "coll_by_kind_bytes": dict(costs.coll_by_kind_bytes),
        "roofline": rl.to_dict(),
    }
    if verbose:
        print(json.dumps(rec, indent=None, default=str), flush=True)
    return rec


def parse_overrides(moe_impl, sets) -> dict:
    """``--moe-impl`` and ``--set key=value`` (int/float/bool auto-parsed)."""
    overrides = {}
    if moe_impl:
        overrides["moe_impl"] = moe_impl
    for kv in sets:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        overrides[k] = v
    return overrides


def _cell(arch: str, shape: str, multi_pod: bool, overrides: dict, device: str,
          mesh) -> dict:
    """One cell's record: ``skip``, ``ok`` or ``error`` (an error is a bug
    in the system; its traceback is printed)."""
    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        print(f"SKIP {arch} x {shape}: {reason}")
        return {"arch": arch, "shape": shape, "status": "skip", "reason": reason}
    print(f"=== {arch} x {shape} (multi_pod={multi_pod}) ===", flush=True)
    try:
        return run_cell(arch, shape, overrides=overrides, mesh=mesh, device=device)
    except Exception as e:  # a failure here is a bug in the system
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "status": "error", "error": str(e)}
    finally:
        gc.collect()


def _production_mesh(multi_pod: bool, device: str):
    """The production mesh on a fake group started in this process (before
    anything else touches ``torch.distributed``)."""
    mesh_lib.make_fake_group(512 if multi_pod else 256)
    return mesh_lib.make_production_mesh(multi_pod=multi_pod, device=device)


def _worker_cell(task):
    """One cell in a ``--jobs`` worker, a process of its own."""
    i, (arch, shape, multi_pod, overrides, device) = task
    return i, _cell(arch, shape, multi_pod, overrides, device,
                    _production_mesh(multi_pod, device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", action="append", default=[], metavar="ARCH:SHAPE",
                    help="a cell to trace (repeatable; with --jobs, several at once)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--moe-impl", default=None, choices=["dense", "sort"])
    ap.add_argument(
        "--set", action="append", default=[],
        help="config override key=value (int/float/bool auto-parsed)",
    )
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors claim (cpu for a CPU-only torch)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each worker process on its own fake group "
                         "(a full-size step is 10^5-10^7 ops at about 0.2 ms each)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.moe_impl, args.set)

    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    elif args.cell:
        cells = [tuple(c.split(":", 1)) for c in args.cell]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --cell, or --all)")
        cells = [(args.arch, args.shape)]
    tasks = list(enumerate((arch, shape, args.multi_pod, overrides, args.device)
                           for arch, shape in cells))

    results: list = [None] * len(cells)

    def done(i, rec):
        results[i] = rec
        if args.out:  # each cell as it ends: a full sweep runs for more than an hour
            with open(args.out, "w") as f:
                json.dump([r for r in results if r is not None], f, indent=1, default=str)

    if args.jobs > 1:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs, maxtasksperchild=1) as pool:
            for i, rec in pool.imap_unordered(_worker_cell, tasks):
                done(i, rec)
    else:
        mesh = _production_mesh(args.multi_pod, args.device)
        for i, task in tasks:
            done(i, _cell(*task, mesh))
    if args.out:
        print(f"wrote {args.out}")
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {len(results)} cells, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
