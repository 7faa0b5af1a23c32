"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* the cell's configuration file (``configs[].file``): relations, rows,
  selectivity, shards, the queries, the guarantees;
* its traffic file ``bench/traffic/<traffic>.json``: the entry into the
  program and the loop's parameters;
* the entry ``bench/entries/<entry>.py``, whose ``Session`` lays the
  relations out, warms up (``warm``) and serves one request a ``step``;
* a reader ``bench/metrics/<metric>.py`` for each metric of the cell, whose
  ``read(record)`` returns the metric or None when it finds nothing to read.

:func:`run_cell` takes the device as an argument, so the CPU tests drive a
whole run; ``bench/run.py`` refuses to run without the card.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from bench.reference import datagen, semijoin

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: share of a traced run's window under the profiler; spans take the rest
PROFILE_SHARE = 0.25
#: the caching allocator's counters logged for the window
ALLOC_COUNTS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


# --------------------------------------------------------------------------
# finding a cell's files by name
# --------------------------------------------------------------------------


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def cell_parts(manifest: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry of the manifest with its configuration, traffic and
    metrics resolved."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the manifest has {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return {
        "cell": cell,
        "config": json.loads((root / cfg_entry["file"]).read_text()),
        "traffic": json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": _for_cell(manifest["end_to_end"], workload),
        "per_layer": _for_cell(manifest["per_layer"], workload),
    }


def reader(name: str, root: Path = ROOT):
    module = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    return load_module(root / "bench" / "metrics" / f"{name}.py", module).read


def session_class(entry: str, root: Path = ROOT):
    module = "bench_entry_" + entry.replace(".", "_").replace("-", "_")
    return load_module(root / "bench" / "entries" / f"{entry}.py", module).Session


# --------------------------------------------------------------------------
# the window
# --------------------------------------------------------------------------


class Spans:
    """The benchmark's own spans around its calls into the program, summed
    by name over one step; with ``stamp`` each is also kept as
    ``(start_ns, end_ns, name)`` on ``time.time_ns``, the profiler's clock."""

    def __init__(self, stamp: bool):
        self.times: dict[str, float] = {}
        self.stamps: list | None = [] if stamp else None

    @contextmanager
    def __call__(self, name: str):
        t0, ns0 = time.perf_counter(), time.time_ns()
        yield
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
        if self.stamps is not None:
            self.stamps.append((ns0, time.time_ns(), name))


def job_summary(report) -> dict:
    """What the metric readers need of one ``Report``: host numbers only,
    so no device memory outlives its step."""
    jobs = []
    for r in report.records:
        phases = [(sp.name, sp.dur, dict(sp.args)) for top in r.spans for sp in top.walk()
                  if sp.cat == "phase"]
        jobs.append({"stats": {k: int(v) for k, v in r.stats.items()}, "phases": phases})
    return {"jobs": jobs, "bytes_shuffled": int(report.bytes_shuffled())}


def _tracer(kind: str | None):
    """The program's tracer for one step: none, ``"barrier"`` (a device
    barrier after each stage, so its span is its device time) or
    ``"stamps"`` (no barrier; the stages stamped for the profiler)."""
    if kind is None:
        return None
    if kind == "barrier":
        from repro_torch.obs.tracer import Tracer

        return Tracer(trace_sync=True)
    from bench.program import StageStamps

    return StageStamps()


def drive(session, seconds: float, *, picks, tracer: str | None = None,
          stamp: bool = False) -> tuple[list, float]:
    """Steps of ``session`` in a closed loop until ``seconds`` have passed,
    each under the program's tracer of kind ``tracer`` (:func:`_tracer`);
    the window ends with the last step started before then.  The answers
    of the steps ``picks(n)`` names (given ``n``, the steps the window
    should hold at the first step's pace) are copied to the host.  Returns
    the steps and the window's length."""
    steps, chosen = [], {0}
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        spans = Spans(stamp)
        t0 = time.perf_counter()
        program_tracer = _tracer(tracer)
        served, reports, answers = session.step(program_tracer, spans)
        kept = None
        if chosen is None or len(steps) in chosen:
            with spans("answer"):
                kept = [(key, None if rows is None else rows.cpu()) for key, rows in answers]
        del answers
        t1 = time.perf_counter()
        if not steps:
            more = picks(int(seconds / max(t1 - t0, 1e-9)))
            chosen = None if more is None else chosen | more
        steps.append({"t0": t0 - t_start, "t1": t1 - t_start, "served": served,
                      "traced": tracer == "barrier", "profiled": tracer == "stamps",
                      "spans": spans.times, "stamps": spans.stamps,
                      "stages": getattr(program_tracer, "stamps", None),
                      "reports": [job_summary(r) for r in reports], "answers": kept})
        if t1 >= deadline:
            return steps, t1 - t_start


def sampler(seed: int, checked):
    """``picks(n)`` for ``drive``: None for ``"all"`` steps, or ``checked -
    1`` steps besides the first, drawn from the seed among the ``n`` the
    window should hold, so every run copies as many answers as the next."""
    rng = random.Random(datagen.sub_seed(seed, "check"))

    def picks(n: int) -> set | None:
        if checked == "all":
            return None
        return set(rng.sample(range(1, max(n, 1)), min(checked - 1, max(n - 1, 0))))

    return picks


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def check(config: dict, seed: int, steps: list, device) -> dict:
    """Every kept answer against the plain reference, evaluated over the
    relations as they stood for that answer, drawn again from the seed."""
    rels: dict = {}
    expected: dict = {}
    checked = wrong = missing = extra = 0
    for step in steps:
        for key, got in step["answers"] or ():
            versions = key["versions"]
            ident = json.dumps(key, sort_keys=True)
            if ident not in expected:
                state = {}
                for name, rel in config["relations"].items():
                    v = versions.get(name, 0)
                    if (name, v) not in rels:
                        rels[name, v] = datagen.relation_rows(
                            name, rel["arity"], rel["role"], config["rows"], config["sel"],
                            seed, v, device, config["P"])
                    state[name] = rels[name, v]
                expected[ident] = semijoin.evaluate(key["query"], state)
            if got is None:  # the request never completed
                m, x = expected[ident].shape[0], 0
            else:
                m, x = semijoin.difference(expected[ident], got)
            checked += 1
            wrong += bool(m or x)
            missing += m
            extra += x
    return {
        "answers_checked": {"value": checked, "min": 1},
        "answers_wrong": {"value": wrong, "max": 0},
        "rows_missing": {"value": missing, "max": 0},
        "rows_extra": {"value": extra, "max": 0},
    }


def passes(numbers: dict) -> bool:
    return all(("min" not in n or n["value"] >= n["min"])
               and ("max" not in n or n["value"] <= n["max"]) for n in numbers.values())


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}
    return {"platform": dev.type, "kind": dev.type, "count": 1}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, *,
             root: Path = ROOT, process_age=None, marks: list | None = None,
             config_override: dict | None = None, log=None) -> dict:
    """Set up the cell, measure ``seconds``, check the answers, read the
    metrics; the result line as a dict.  ``process_age()`` gives the
    seconds since the process started (set-up counts from there), and
    ``marks`` the ``(part, age)`` at which each part of set-up before this
    call ended; ``config_override`` replaces keys of the configuration
    (the CPU tests' small sizes)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_begin = time.perf_counter()
    process_age = process_age or (lambda: time.perf_counter() - t_begin)
    marks = list(marks or [])

    def mark(part: str) -> None:
        if cuda:
            torch.cuda.synchronize(dev)
        marks.append((part, process_age()))

    parts = cell_parts(load_manifest(root), workload, root)
    config = {**parts["config"], **(config_override or {})}
    traffic = parts["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    mark("harness")
    session_cls = session_class(traffic["entry"], root)
    mark("program import")
    session = session_cls(config, traffic, seed, device)
    mark("relations")
    session.warm()
    mark("warm step")
    setup_s = marks[-1][1]
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{part} {age - before:.3f}" for (part, age), before
        in zip(marks, [0.0] + [age for _, age in marks])))
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_stats(dev) if cuda else {}
    picks = sampler(seed, traffic["checked_steps"])
    # set-up's objects out of the collector's reach: a full collection in
    # the window then walks only what the window made
    gc.collect()
    gc.freeze()

    profile = None
    if not trace:
        steps, window_s = drive(session, seconds, picks=picks)
    else:
        # the device trace of the program's own path, its stages stamped,
        # then its spans with a device barrier after each stage, each on
        # its share of the window
        steps_a, prof, window_ns = _profiled(session, seconds * PROFILE_SHARE, picks, dev)
        steps_b, window_s = drive(session, seconds * (1 - PROFILE_SHARE), picks=picks,
                                  tracer="barrier")
        steps = steps_a + steps_b
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    served = sum(s["served"] for s in steps)
    log("step seconds " + json.dumps([round(s["t1"] - s["t0"], 4) for s in steps]))
    if cuda:
        mem = torch.cuda.memory_stats(dev)
        log("allocator in the window " + json.dumps(
            {k: mem.get(k, 0) - mem0.get(k, 0) for k in ALLOC_COUNTS}
            | {"reserved_peak_bytes": mem.get("reserved_bytes.all.peak")}))
    gc.unfreeze()
    session.close()
    del session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    if trace and prof is not None:
        from bench.trace import reduce_profile

        spans = [st for step in steps_a for st in step["stamps"]]
        stages = [st for step in steps_a for st in step["stages"]]
        profile = reduce_profile(prof, window_ns, spans, stages)
        profile["served"] = sum(s["served"] for s in steps_a)
        log(f"profile: {profile['device_ops']} device operations, "
            f"{profile['misaligned']} outside the window; by stage "
            + json.dumps({k: [v, profile["stage_ops"][k], profile["stage_top"][k]]
                          for k, v in profile["stage_s"].items()}))
        del prof
    t_check = time.perf_counter()
    numbers = check(config, seed, steps, dev)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    info = device_info(dev)
    info["memory_peak_bytes"] = max(peak, setup_peak)
    record = {
        "device": info, "P": config["P"], "setup_s": setup_s,
        "window_s": window_s, "served": served, "peak_mem_bytes": peak,
        "steps": steps, "profile": profile,
    }
    metrics = {}
    for m in parts["per_layer"] if trace else parts["end_to_end"]:
        value = reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": passes(numbers), "attempted": served,
        "failed": numbers["answers_wrong"]["value"], "metrics": metrics, "device": info,
    }
    if trace and profile is not None:
        info["busy_s"] = profile["busy_s"]
        info["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_op_s"],
                               "idle_gaps": profile["idle_gaps"]}
    result["check"] = numbers
    return result


def _profiled(session, seconds: float, picks, dev):
    """``drive`` under ``torch.profiler`` recording the device's activity,
    the program's stages stamped (on the card; on the CPU there is none and
    no profiler runs): ``(steps, prof, (start_ns, end_ns))``."""
    if dev.type != "cuda":
        steps, _ = drive(session, seconds, picks=picks, tracer="stamps", stamp=True)
        return steps, None, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(dev)
        ns0 = time.time_ns()
        steps, _ = drive(session, seconds, picks=picks, tracer="stamps", stamp=True)
        torch.cuda.synchronize(dev)
        ns1 = time.time_ns()
    return steps, prof, (ns0, ns1)
