#!/usr/bin/env python3
"""A device trace's idle gaps and device-to-host copies put down to the
program's own spans, and the command that measures them on the card.

The port's tracer logs every span it times on ``time.time_ns``, the clock
``torch.profiler`` stamps its events with (``Tracer.log``: ``(ns0, ns1,
name, cat, parent)``, DESIGN.md §14).  :func:`attribute` names each idle
gap of the device by the benchmark's span, the innermost program span and
the CUDA runtime call open at the gap's midpoint, and puts each
device-to-host copy under the program span open when its runtime call
started.  A tracer without a log (a program that predates it) gives the
benchmark's two-part names of ``bench/trace.py`` and no program numbers.

    python3 bench/attribution.py --workload a3.greedy --seed 7 --seconds 20

sets the cell up as a run does, then measures three windows of
``--seconds`` each, in this order: untraced, traced (the benchmark's
stamping tracer, no barrier) and profiled (the same tracer, with
``torch.profiler`` recording the device, as a traced run's first quarter
runs), and prints one JSON line: the seconds per query of each window,
the program's spans per query, and from the profiled window the device's
idle seconds by name, with what the per-layer metrics ``exec_idle_s``,
``stage_idle_s``, ``shard_loop_s`` and ``host_reads_per_query`` would
read there.  ``--device cpu`` with ``--rows`` rehearses it without the
card: no profiler runs, and the profile's numbers are null.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.trace import _events, _merge  # noqa: E402

#: program spans whose gaps are the executor's (``exec_idle_s``) and the
#: operators' stages with their runner spans (``stage_idle_s``)
EXEC = ("exec.",)
STAGE = ("msj.", "eval.", "sim.")
TOP = 15


def innermost(points, intervals) -> list:
    """For each time in ``points`` (ascending), the name of the innermost
    of the ``(start, end, name)`` intervals open there, or None; intervals
    nest or are disjoint, and of two that start together the longer is the
    outer."""
    events = sorted(intervals, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for m in points:
        while i < len(events) and events[i][0] <= m:
            stack.append(events[i])
            i += 1
        stack = [e for e in stack if e[1] >= m]
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(host, dev, window_ns, bench_spans, program_spans) -> dict:
    """The idle gaps of ``dev`` inside ``window_ns`` and its device-to-host
    copies, by span.  ``host`` and ``dev`` are ``(start_ns, end_ns, name,
    correlation)``: the runtime calls and the device's operations;
    ``bench_spans`` the benchmark's ``(start_ns, end_ns, name)``;
    ``program_spans`` the program's log entries, or None.

    Returns ``idle_s`` (all idle seconds), ``idle_gaps`` (seconds by
    ``<benchmark span> / <program span> / <runtime call>``, the middle left
    out where no program span is open), and, None without a log,
    ``exec_idle_s`` and ``stage_idle_s`` (gaps whose innermost program span
    is the executor's, or a stage's or its runner's), ``execute_idle_s``
    and ``execute_covered_s`` (gaps in the benchmark's ``execute`` span,
    and those of them under a program span), ``host_reads`` (copies to the
    host launched inside a program span, outside the benchmark's
    ``answer`` span) and ``reads_by_span``."""
    w0, w1 = window_ns
    busy = _merge((max(a, w0), min(b, w1)) for a, b, _, _ in dev if b > w0 and a < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    mids = [(a + b) // 2 for a, b in gaps]
    calls = [(a, b, n) for a, b, n, _ in host]
    logged = program_spans is not None
    prog = [(a, b, n) for a, b, n, _, _ in program_spans or ()]
    names = zip(innermost(mids, bench_spans),
                innermost(mids, prog) if logged else [None] * len(mids), innermost(mids, calls))
    idle, by_prog = defaultdict(int), defaultdict(int)
    execute = covered = 0
    for (a, b), (span, program, call) in zip(gaps, names):
        parts = [span or "between steps"] + ([program] if program else []) + [call or "host code"]
        idle[" / ".join(parts)] += b - a
        by_prog[program] += b - a
        if span == "execute":
            execute += b - a
            covered += (b - a) if program else 0
    out = {"idle_s": sum(b - a for a, b in gaps) / 1e9,
           "idle_gaps": {k: v / 1e9 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])}}
    if not logged:
        return out | dict.fromkeys(("exec_idle_s", "stage_idle_s", "execute_idle_s",
                                    "execute_covered_s", "host_reads", "reads_by_span"))
    started = {corr: a for a, _, _, corr in host if corr}
    copies = sorted(started[corr] for _, _, n, corr in dev if "DtoH" in n and corr in started)
    reads = Counter(p for p, span in zip(innermost(copies, prog), innermost(copies, bench_spans))
                    if p is not None and span != "answer")
    return out | {
        "exec_idle_s": sum(v for k, v in by_prog.items() if k and k.startswith(EXEC)) / 1e9,
        "stage_idle_s": sum(v for k, v in by_prog.items() if k and k.startswith(STAGE)) / 1e9,
        "execute_idle_s": execute / 1e9,
        "execute_covered_s": covered / 1e9,
        "host_reads": sum(reads.values()),
        "reads_by_span": dict(reads.most_common()),
    }


def span_seconds(logs, name: str) -> float:
    """Host seconds inside the program's spans ``name`` over the logs."""
    return sum(e[1] - e[0] for log in logs for e in log if e[2] == name) / 1e9


# --------------------------------------------------------------------------
# the command
# --------------------------------------------------------------------------


def window(session, seconds: float, make_tracer) -> list:
    """Steps of ``session`` in a closed loop for ``seconds``, each under a
    fresh tracer from ``make_tracer`` (None: untraced) and the benchmark's
    stamped spans."""
    from bench import harness

    steps = []
    deadline = time.perf_counter() + seconds
    while True:
        spans = harness.Spans(stamp=True)
        tracer = make_tracer()
        t0 = time.perf_counter()
        served, _, answers = session.step(tracer, spans)
        del answers
        t1 = time.perf_counter()
        steps.append({"seconds": t1 - t0, "served": served, "stamps": spans.stamps,
                      "log": getattr(tracer, "log", None)})
        if t1 >= deadline:
            return steps


def per_query(steps) -> float:
    return sum(s["seconds"] for s in steps) / sum(s["served"] for s in steps)


def measure(workload: str, seed: int, seconds: float, device, config_override=None) -> dict:
    import torch

    from bench import harness
    from bench.program import StageStamps

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    parts = harness.cell_parts(harness.load_manifest(ROOT), workload, ROOT)
    config = {**parts["config"], **(config_override or {})}
    session = harness.session_class(parts["traffic"]["entry"], ROOT)(
        config, parts["traffic"], seed, device)
    session.warm()
    untraced = window(session, seconds, lambda: None)
    traced = window(session, seconds, StageStamps)
    prof = None
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(dev)
            ns0 = time.time_ns()
            profiled = window(session, seconds, StageStamps)
            torch.cuda.synchronize(dev)
            ns1 = time.time_ns()
    else:
        profiled = window(session, seconds, StageStamps)
    session.close()
    served = sum(s["served"] for s in profiled)
    logs = [s["log"] for s in profiled]
    logged = all(log is not None for log in logs)
    out = {
        "workload": workload, "seed": seed, "device": harness.device_info(dev)["kind"],
        "query_s": {"untraced": per_query(untraced), "traced": per_query(traced),
                    "profiled": per_query(profiled)},
        "queries": [sum(s["served"] for s in w) for w in (untraced, traced, profiled)],
        "spans_per_query": sum(map(len, logs)) / served if logged else None,
        "shard_loop_s": span_seconds(logs, "sim.shards") / served if logged else None,
    }
    if prof is None:
        return out | {"profile": None}
    host, devs = _events(prof)
    del prof
    found = attribute(host, devs, (ns0, ns1), [st for s in profiled for st in s["stamps"]],
                      [e for log in logs for e in log] if logged else None)
    each = {k: (None if found[k] is None else found[k] / served)
            for k in ("exec_idle_s", "stage_idle_s", "host_reads")}
    return out | {
        "window_s": (ns1 - ns0) / 1e9,
        "idle_share": 100.0 * found["idle_s"] * 1e9 / (ns1 - ns0),
        "exec_idle_s": each["exec_idle_s"], "stage_idle_s": each["stage_idle_s"],
        "host_reads_per_query": each["host_reads"],
        "execute_covered": (100.0 * found["execute_covered_s"] / found["execute_idle_s"]
                            if found["execute_idle_s"] else None),
        "misaligned": sum(1 for a, b, _, _ in devs if b <= ns0 or a >= ns1),
        "idle_gaps": [[k[:160], v / served] for k, v in list(found["idle_gaps"].items())[:TOP]],
        "reads_by_span": found["reads_by_span"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, help="the configuration's rows, overridden")
    args = ap.parse_args(argv)
    out = measure(args.workload, args.seed, args.seconds, args.device,
                  None if args.rows is None else {"rows": args.rows})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
