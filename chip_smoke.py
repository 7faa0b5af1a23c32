#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--log2-rows 25]

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. ``device``  — the card's name and ``nvidia-smi`` name / power limit.
2. ``build``   — every CUDA source compiled with ``nvcc`` for ``sm_90a``
   from the sources in this checkout (registers / shared memory from
   ptxas).
3. ``kernel``  — the hand-written probe kernel against its plain torch
   version on the card, exactly, on a case list (key widths 1/2/4/126,
   empty sides, all-duplicate keys, all-equal prune keys, forced
   ``fp = key % 4`` collisions, int32 extremes, ragged tiles) and on one
   shard's probe inputs captured from the full-size MSJ run; then times
   kernel, plain version and ``torch.isin`` at that shape.
4. ``e2e``     — the A3 family (guard R arity 4, four unary conditionals
   sharing key x) through the planner and ``execute_plan`` on 16 shards:
   the 1-ROUND plan at 2**log2-rows rows per relation and the GREEDY plan
   (MSJ + EVAL) at half of that, each with ``probe_backend="auto"``
   (every MSJ job must resolve to the kernel) and ``"sorted"``; outputs
   and counters must be bit-identical, and the kernel's launch counter,
   set to 0 before the measured ``auto`` runs, must be > 0 after.  One
   more ``auto`` run with a synchronizing tracer splits the wall into the
   operators' phases (count, shuffle, probe, scatter, EVAL).
5. ``oracle``  — the quickstart query on the card under PAR / GREEDY /
   1-ROUND, set-equal to the set-semantics oracle ``ref_engine``.

Then a ``kernels`` JSON line, the raw ``nvidia-smi`` name/power line, and
as the last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits 1 before printing any result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
SHARDS = 16  # P of the main path
REPS = 20  # timed launches per measured kernel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (after one warm-up),
    from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phase 3: kernel vs plain
# --------------------------------------------------------------------------


def probe_case(gen, nb, np_, kw, lo, hi, fp_mode=None, values=None):
    """Random probe inputs on the card: ``(args, kwargs)`` of probe_fn.
    Keys are drawn from ``[lo, hi)``, or from ``values`` when given."""
    import torch

    def ints(*shape, a=lo, b=hi):
        return torch.randint(a, b, shape, generator=gen, dtype=torch.int64,
                             device=DEVICE).to(torch.int32)

    if values is None:
        bk, pk = ints(nb, kw), ints(np_, kw)
    else:
        pool = torch.tensor(values, dtype=torch.int32, device=DEVICE)
        bk = pool[ints(nb, kw, a=0, b=len(values)).long()]
        pk = pool[ints(np_, kw, a=0, b=len(values)).long()]
    args = (ints(nb, a=0, b=3), bk, torch.rand(nb, generator=gen, device=DEVICE) < 0.7,
            ints(np_, a=0, b=3), pk, torch.rand(np_, generator=gen, device=DEVICE) < 0.7)
    kwargs = {}
    if fp_mode == "zero":
        kwargs = {"build_fp": torch.zeros_like(bk[:, 0]), "probe_fp": torch.zeros_like(pk[:, 0])}
    elif fp_mode == "mod4":
        kwargs = {"build_fp": torch.remainder(bk[:, 0], 4), "probe_fp": torch.remainder(pk[:, 0], 4)}
    return args, kwargs


def kernel_cases(gen):
    extremes = (-(2**31), -(2**31) + 1, -2, -1, 0, 1, 2**31 - 2, 2**31 - 1)
    return {
        "kw1": probe_case(gen, 6000, 5000, 1, -1000, 1000),
        "kw2": probe_case(gen, 6000, 5000, 2, -30, 30),
        "kw4": probe_case(gen, 5000, 6000, 4, -4, 4),
        "kw126_wide": probe_case(gen, 1500, 1300, 126, 0, 1),
        "empty_build": probe_case(gen, 0, 300, 1, 0, 5),
        "empty_probe": probe_case(gen, 300, 0, 1, 0, 5),
        "all_duplicate": probe_case(gen, 4000, 4000, 1, 7, 8),
        "all_equal_prune_key": probe_case(gen, 4000, 3000, 2, -50, 50, "zero"),
        "fp_key_mod4": probe_case(gen, 4000, 3000, 2, -50, 50, "mod4"),
        "int32_extremes": probe_case(gen, 3000, 3000, 2, 0, 0, values=extremes),
        "ragged_1x1": probe_case(gen, 1, 1, 1, 0, 2),
        "ragged_127x129": probe_case(gen, 129, 127, 1, 0, 40),
        "ragged_385x1000": probe_case(gen, 1000, 385, 2, 0, 20),
    }


def capture_main_path_probe(db, sjs, P):
    """One shard's probe_fn inputs from a full-size MSJ run (shard 0)."""
    from repro_torch.core.msj import run_msj
    from repro_torch.engine.comm import SimComm
    from repro_torch.kernels.msj_probe import ops

    seen = []

    def capture(*args, **kwargs):
        if not seen:  # copies: views would keep the whole exchange alive
            seen.append((tuple(a.clone() for a in args),
                         {k: v.clone() for k, v in kwargs.items()}))
        return ops.probe_bucketed(*args, **kwargs)

    run_msj(db, sjs, SimComm(P), probe_fn=capture)
    return seen[0]


def band_pairs(args, kwargs) -> int:
    """(probe row, build row) pairs the bucketed probe compares on these
    inputs: each valid probe row against its tile's prune-key band."""
    import torch

    from repro_torch.kernels.msj_probe import ops

    sides, _ = ops._sides(*args, kwargs.get("build_fp"), kwargs.get("probe_fp"))
    p_pk, p_ok, b_pk = sides[1], sides[2], sides[4]
    if p_pk.shape[0] == 0 or b_pk.shape[0] == 0:
        return 0
    starts, b0, b1 = ops.tile_bands(p_pk, b_pk)
    active = (p_ok & (p_pk >= 0)).to(torch.int64)
    per_tile = torch.zeros(starts.shape[0], dtype=torch.int64, device=p_pk.device)
    per_tile.index_add_(0, torch.arange(p_pk.shape[0], device=p_pk.device) // ops.TILE, active)
    return int((per_tile * (b1 - b0)).sum())


def unique_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def phase_kernel(main_case) -> dict:
    import torch

    from repro_torch.kernels.msj_probe import ops, ref

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    cases = kernel_cases(gen)
    cases["main_path_shard0"] = main_case
    checked, max_err = {}, 0
    for name, (args, kwargs) in cases.items():
        got = ops.probe_bucketed(*args, **kwargs)
        want = ops.probe_bucketed_plain(*args, **kwargs)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if got.numel() else 0
        if not torch.equal(got, want) or err != 0:
            raise AssertionError(f"kernel != plain on case {name}: max |diff| {err}")
        max_err = max(max_err, err)
        if name != "main_path_shard0" and args[0].shape[0] * args[3].shape[0] <= 4e7:
            if not torch.equal(got, ref.probe(*args)):
                raise AssertionError(f"kernel != dense oracle on case {name}")
        checked[name] = {"np": int(args[3].shape[0]), "nb": int(args[0].shape[0]),
                         "kw": int(args[1].shape[1]), "hits": int(got.sum())}
    emit({"phase": "kernel_check", "cases": checked, "max_abs_err": max_err})

    # timing at the main path's shape
    args, kwargs = main_case
    ms = cuda_ms(lambda: ops.probe_bucketed(*args, **kwargs), REPS)
    plain_ms = cuda_ms(lambda: ops.probe_bucketed_plain(*args, **kwargs), REPS // 5)
    sides, _ = ops._sides(*args, kwargs.get("build_fp"), kwargs.get("probe_fp"))
    band_ms = cuda_ms(lambda: ops.band_probe_cuda(*sides), REPS)
    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok = args
    lib_ms = None
    if build_keys.shape[1] == 1:
        def packed(sig, keys, ok):
            v = (sig.to(torch.int64) << 32) | (keys[:, 0].to(torch.int64) & 0xFFFFFFFF)
            return v[ok]

        bp, pp = packed(build_sig, build_keys, build_ok), packed(probe_sig, probe_keys, probe_ok)
        lib_ms = cuda_ms(lambda: torch.isin(pp, bp), REPS)
    in_bytes = unique_bytes(list(args) + list(kwargs.values()))
    out_bytes = probe_sig.shape[0]  # one bool per probe row
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    pairs = band_pairs(args, kwargs)
    n_cols = build_keys.shape[1] + 1
    ops_ms = pairs * n_cols / SCALAR_OPS_PER_S * 1e3
    timing = {
        "np": int(probe_sig.shape[0]), "nb": int(build_sig.shape[0]), "kw": int(build_keys.shape[1]),
        "valid_probe": int(probe_ok.sum()), "valid_build": int(build_ok.sum()),
        "max_abs_err": max_err, "ms": ms, "band_kernel_only_ms": band_ms,
        "plain_ms": plain_ms, "library_ms": lib_ms,
        "bytes": in_bytes + out_bytes, "band_pairs": pairs,
        "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    emit({"phase": "kernel_timing", **timing})
    return timing


# --------------------------------------------------------------------------
# phase 4: end to end
# --------------------------------------------------------------------------


def run_plan(db, plan, P, backend, tracer=None):
    import torch

    from repro_torch.core.executor import Executor, ExecutorConfig
    from repro_torch.engine.comm import SimComm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = Executor(dict(db), SimComm(P), ExecutorConfig(probe_backend=backend), tracer=tracer)
    env, report = ex.execute(plan)
    torch.cuda.synchronize()
    return env, report, time.perf_counter() - t0


def phase_seconds(report) -> dict:
    """Seconds per traced phase name, summed over the report's jobs."""
    out: dict[str, float] = {}
    for rec in report.records:
        for top in rec.spans:
            for sp in top.walk():
                if sp.cat == "phase":
                    out[sp.name] = out.get(sp.name, 0.0) + sp.dur
    return out


def same_outputs(env_a, env_b, names) -> None:
    import torch

    for k in names:
        if not (torch.equal(env_a[k].data, env_b[k].data)
                and torch.equal(env_a[k].valid, env_b[k].valid)):
            raise AssertionError(f"auto and sorted backends differ on {k}")


def phase_e2e(name, db, plan, P, rows) -> dict:
    import torch

    from repro_torch.core.planner import MSJJob, job_writes
    from repro_torch.kernels.msj_probe import ops

    outputs = sorted(set().union(*(job_writes(j) for r in plan.rounds for j in r.jobs)))
    run_plan(db, plan, P, "auto")  # warm
    torch.cuda.reset_peak_memory_stats()
    ops.probe_bucketed.launches = 0
    env_a, rep_a, wall_a = run_plan(db, plan, P, "auto")
    launches = ops.probe_bucketed.launches
    peak = torch.cuda.max_memory_allocated()
    msj_backends = [r.backend for r in rep_a.records if isinstance(r.job, MSJJob)]
    if not msj_backends or any(b != "kernel" for b in msj_backends):
        raise AssertionError(f"{name}: auto resolved to {msj_backends}, not the kernel")
    if launches <= 0:
        raise AssertionError(f"{name}: the probe kernel was never launched")
    # the sorted reference path: compare the measured auto run's outputs
    # first, then free them before the sorted runs
    run_plan(db, plan, P, "sorted")  # warm
    env_s, rep_s, wall_s = run_plan(db, plan, P, "sorted")
    same_outputs(env_a, env_s, outputs)
    stats_a = [r.stats for r in rep_a.records]
    if stats_a != [r.stats for r in rep_s.records]:
        raise AssertionError(f"{name}: auto and sorted counters differ")
    out_rows = {k: int(env_a[k].count()) for k in outputs}
    del env_a, env_s
    from repro_torch.obs.tracer import Tracer

    _, rep_t, wall_t = run_plan(db, plan, P, "auto", tracer=Tracer(trace_sync=True))
    result = {
        "phase": "e2e", "plan": name, "rows_per_relation": rows, "P": P,
        "jobs": rep_a.n_jobs, "msj_backends": msj_backends, "launches": launches,
        "wall_auto_s": wall_a, "wall_sorted_s": wall_s,
        "bytes_shuffled": rep_a.bytes_shuffled(),
        "forward_cap": [r.stats.get("forward_cap") for r in rep_a.records],
        "output_rows": out_rows, "peak_mem_bytes": peak, "bit_identical": True,
        "traced_wall_s": wall_t, "phase_s": phase_seconds(rep_t),
    }
    emit(result)
    return result


# --------------------------------------------------------------------------
# phase 5: oracle
# --------------------------------------------------------------------------


def phase_oracle() -> None:
    import numpy as np

    from repro_torch.core import ref_engine
    from repro_torch.core.algebra import And, Atom, BSGF, Or
    from repro_torch.core.costmodel import HADOOP, stats_of_db
    from repro_torch.core.executor import execute_plan
    from repro_torch.core.planner import plan_greedy, plan_one_round, plan_par
    from repro_torch.core.relation import db_from_dict
    from repro_torch.engine.comm import SimComm

    P = 8
    rng = np.random.default_rng(0)
    db_np = {
        "R": rng.integers(0, 64, (2000, 2)).astype(np.int32),
        "S": rng.integers(0, 64, (1500, 2)).astype(np.int32),
        "T": rng.integers(0, 64, (1000, 2)).astype(np.int32),
    }
    query = BSGF("Z", ("x", "y"), Atom("R", "x", "y"),
                 And(Or(Atom("S", "x", "y"), Atom("S", "y", "x")), Atom("T", "x", "z")))
    want = ref_engine.eval_bsgf({k: {tuple(map(int, r)) for r in v} for k, v in db_np.items()},
                                query)
    db = db_from_dict(db_np, P=P)
    if any(r.data.device.type != DEVICE for r in db.values()):
        raise AssertionError("oracle: the default device is not the card")
    plans = {"par": plan_par([query]), "greedy": plan_greedy([query], stats_of_db(db), HADOOP),
             "one_round": plan_one_round([query])}
    got = {}
    for name, plan in plans.items():
        env, report = execute_plan(db, plan, SimComm(P))
        z = env["Z"].to_set()
        if z != want:
            raise AssertionError(f"oracle: {name} plan disagrees with ref_engine")
        got[name] = {"rows": len(z), "jobs": report.n_jobs,
                     "backends": [r.backend for r in report.records if r.backend]}
    emit({"phase": "oracle", "want_rows": len(want), "plans": got, "set_equal": True})


# --------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-rows", type=int, default=25)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from repro_torch.core import queries
    from repro_torch.core.algebra import semijoins_of
    from repro_torch.core.costmodel import HADOOP, stats_of_db
    from repro_torch.core.planner import plan_greedy, plan_one_round
    from repro_torch.core.relation import db_from_dict
    from repro_torch.kernels import build
    from repro_torch.kernels.msj_probe import ops

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = {src.name: build.build(src) for src in build.sources()}
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "ptxas info" in ln]
             for name, log in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [str(s.relative_to(ROOT)) for s in build.sources()], "ptxas": ptxas})

    P, rows = SHARDS, 2**args.log2_rows
    qs = queries.make_queries("A3")
    sjs = [sj for q in qs for sj in semijoins_of(q)]
    t0 = time.perf_counter()
    db = db_from_dict(queries.gen_db(qs, n_guard=rows, n_cond=rows, sel=0.5, seed=args.seed),
                      P=P)
    torch.cuda.synchronize()
    emit({"phase": "data", "rows_per_relation": rows, "P": P,
          "relations": {k: list(r.data.shape) for k, r in db.items()},
          "seconds": time.perf_counter() - t0})

    main_case = capture_main_path_probe(db, sjs, P)
    timing = phase_kernel(main_case)
    del main_case

    e2e = [phase_e2e("one_round", db, plan_one_round(qs), P, rows)]
    del db
    torch.cuda.empty_cache()
    # GREEDY adds an EVAL job, whose forward buffer is the reference's
    # no-assumption bound (P x the sum of its inputs' capacities per shard
    # pair): at half the rows the buffer and its exchanged copy fit the card
    g_rows = rows // 2
    gdb = db_from_dict(queries.gen_db(qs, n_guard=g_rows, n_cond=g_rows, sel=0.5,
                                      seed=args.seed), P=P)
    e2e.append(phase_e2e("greedy", gdb, plan_greedy(qs, stats_of_db(gdb), HADOOP), P, g_rows))
    del gdb
    torch.cuda.empty_cache()

    phase_oracle()

    emit({"kernels": [{
        "name": "probe_bucketed",
        "route": "cuda",
        "source": "src/repro_torch/kernels/msj_probe/csrc/probe_bucketed.cu",
        "replaces": "src/repro/kernels/msj_probe/kernel.py:110",
        "launches": sum(r["launches"] for r in e2e),
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "shape": {"np": timing["np"], "nb": timing["nb"], "kw": timing["kw"]},
    }], "seconds_total": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
