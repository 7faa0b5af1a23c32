"""Chrome/Perfetto ``trace_event`` export of executor reports (DESIGN.md §14).

One trace per :class:`~repro_torch.core.executor.Report`: a track (``tid``) per
cluster slot carrying the job slices of the virtual event timeline, the
phase spans of each job nested inside its slice, and flow arrows for the
relations-DAG dependencies, speculation loser→winner pairs, and
failure→taint propagation.  Open the written file in ``ui.perfetto.dev``
or ``chrome://tracing``.

**Replay-identity contract**: every job slice carries its *exact* float64
``wall``/``start``/``round`` in ``args``.  Python's ``json`` writes
shortest-roundtrip reprs, so :func:`report_from_trace` reconstructs a
Report whose ``net_time`` / ``total_time`` / ``net_time_by_events(W)``
equal the source report's **bit-exactly** — the trace file is a lossless
serialization of the timeline accounting, not just a picture of it.
``ts``/``dur`` (microseconds, the trace_event convention) are derived
display values and are *not* used for reconstruction.
"""
from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # imported lazily at runtime: executor traces via
    from repro_torch.core.executor import JobRecord, Report  # repro_torch.obs.tracer

#: synthetic track for zero-wall tainted records (slot == -1).
TAINT_TID = 999

_PHASES = {"M", "X", "s", "f"}


def _label(rec: "JobRecord") -> str:
    job = rec.job
    if job is None:
        return "job"
    kind = type(job).__name__
    if kind == "MSJJob":
        return f"MSJ x{len(job.sjs)}"
    if kind == "EvalJob":
        return f"EVAL x{len(job.queries)}"
    if kind == "TransferJob":
        return f"XFER x{len(job.base.sjs)}"
    if kind == "ComputeJob":
        return f"PROBE x{len(job.base.sjs)}"
    if kind == "SkewProfileJob":
        return f"SKEW x{len(job.base.sjs)}"
    return kind


def _tid(rec: JobRecord) -> int:
    return rec.slot if rec.slot >= 0 else TAINT_TID


def _job_args(rec: JobRecord) -> dict:
    args = {
        "round": rec.round_idx,
        "wall": rec.wall,
        "start": rec.start,
        "slot": rec.slot,
        "attempt": rec.attempt,
        "attempts": rec.attempts,
        "speculative": rec.speculative,
        "cancelled": rec.cancelled,
        "outcome": rec.outcome,
        "backend": rec.backend,
        "bytes_fwd": int(rec.stats.get("bytes_fwd", 0)),
        "bytes_bwd": int(rec.stats.get("bytes_bwd", 0)),
    }
    if rec.job is not None:
        # relation access sets make the trace a self-contained audit
        # subject: the offline sanitizer (audit_trace) recovers conflicts
        # from these after the job objects are gone
        from repro_torch.core.planner import job_reads, job_writes

        args["reads"] = sorted(job_reads(rec.job))
        args["writes"] = sorted(job_writes(rec.job))
    return args


def trace_events(report: Report, *, title: str = "msj") -> list[dict]:
    """Build the trace_event list for one report.

    Requires event-timeline info on every record (``start >= 0`` — the
    async/waves executor always records it; zero-wall tainted records use
    their failure-time start).
    """
    if any(r.start < 0.0 and r.outcome != "tainted" for r in report.records):
        raise ValueError("report lacks event-timeline info (start < 0)")
    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": title}},
    ]
    from repro_torch.core.executor import COMM_SLOT

    tids = sorted({_tid(r) for r in report.records})
    for tid in tids:
        if tid == TAINT_TID:
            name = "tainted"
        elif tid == COMM_SLOT:
            name = "comm"  # the dedicated transfer track (DESIGN.md §16)
        else:
            name = f"slot {tid}"
        events.append(
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
             "args": {"name": name}}
        )
        events.append(
            {"ph": "M", "name": "thread_sort_index", "pid": 0, "tid": tid,
             "args": {"sort_index": tid}}
        )

    for rec in report.records:
        tid = _tid(rec)
        start = max(rec.start, 0.0)
        events.append(
            {"name": _label(rec), "cat": "job", "ph": "X", "pid": 0,
             "tid": tid, "ts": start * 1e6, "dur": rec.wall * 1e6,
             "args": _job_args(rec)}
        )

        def emit(sp):
            # clamp display intervals into the job slice (loser truncation
            # and float scaling can leave sub-µs overhang); args keep the
            # raw measured values
            t0 = min(max(sp.t0, 0.0), rec.wall)
            dur = max(0.0, min(sp.dur, rec.wall - t0))
            events.append(
                {"name": sp.name, "cat": sp.cat, "ph": "X", "pid": 0,
                 "tid": tid, "ts": (start + t0) * 1e6, "dur": dur * 1e6,
                 "args": {**sp.args, "wall": sp.dur}}
            )
            for c in sp.children:
                emit(c)

        for sp in getattr(rec, "spans", ()):
            emit(sp)

    events.extend(_flow_events(report))
    return events


def _flow_events(report: Report) -> list[dict]:
    """Flow arrows: relations-DAG dependencies (producer end → consumer
    start), speculation loser → winner, and failure → tainted records."""
    from repro_torch.core.planner import job_reads, job_writes

    events: list[dict] = []
    fid = 0

    def arrow(cat, name, src, dst, src_ts, dst_ts):
        nonlocal fid
        fid += 1
        events.append({"ph": "s", "cat": cat, "name": name, "id": fid,
                       "pid": 0, "tid": _tid(src), "ts": src_ts * 1e6})
        events.append({"ph": "f", "bp": "e", "cat": cat, "name": name,
                       "id": fid, "pid": 0, "tid": _tid(dst),
                       "ts": dst_ts * 1e6})

    # DAG edges, re-derived from read/write sets over publish order
    last_writer: dict[str, JobRecord] = {}
    for rec in report.records:
        if rec.job is None or rec.start < 0.0:
            continue
        if rec.outcome == "ok" and rec.attempt == 0 or rec.outcome == "cancelled":
            # the attempt-0 record marks the dispatch the DAG gated on
            for rel in sorted(job_reads(rec.job)):
                w = last_writer.get(rel)
                if w is not None and w.end <= rec.start:
                    arrow("dag", f"dep:{rel}", w, rec, w.end, rec.start)
        if rec.outcome == "ok":
            for rel in sorted(job_writes(rec.job)):
                last_writer[rel] = rec

    # speculation: loser → winner of each first-completion-wins pair
    for i, clone in enumerate(report.records):
        if not (clone.speculative and clone.attempt == 1):
            continue
        orig = next(
            (r for r in report.records[:i]
             if r.job is clone.job and r.attempt == 0), None,
        )
        if orig is None:
            continue
        loser, winner = (orig, clone) if orig.cancelled else (clone, orig)
        arrow("speculation", "spec-winner", loser, winner,
              loser.start, max(winner.end, loser.start))

    # taint: each tainted record chains back to the latest prior failure
    failed: JobRecord | None = None
    for rec in report.records:
        if rec.outcome == "failed":
            failed = rec
        elif rec.outcome == "tainted" and failed is not None:
            arrow("taint", "taint", failed, rec,
                  min(failed.end, max(rec.start, 0.0)), max(rec.start, 0.0))
    return events


def write_trace(path: str, report: Report, *, title: str = "msj",
                metrics=None) -> str:
    """Write the Perfetto JSON for ``report``; returns ``path``.

    ``metrics`` (a :class:`~repro_torch.obs.metrics.MetricRegistry`) is embedded
    as ``otherData.metrics`` so a trace file carries its counters too.
    """
    doc: dict = {"traceEvents": trace_events(report, title=title),
                 "displayTimeUnit": "ms"}
    if metrics is not None:
        doc["otherData"] = {"metrics": metrics.snapshot()}
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# --------------------------------------------------------------------------
# Validation
# --------------------------------------------------------------------------

#: slack for derived µs timestamps (float scaling); args values are exact.
_EPS_US = 5e-3


def validate_trace(trace) -> list[str]:
    """Validate trace_event schema + timeline invariants; returns problem
    strings (empty == valid).

    Checks every event's required fields per phase type, per-track
    non-overlap of job slices, containment of phase slices in a job slice
    on their track, and that each flow id has exactly one ``s`` and one
    ``f`` with ``s.ts <= f.ts``.
    """
    if isinstance(trace, dict):
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level object lacks a traceEvents list"]
    elif isinstance(trace, list):
        events = trace
    else:
        return [f"trace must be a dict or list, got {type(trace).__name__}"]

    problems: list[str] = []
    by_tid_jobs: dict[int, list[tuple[float, float]]] = {}
    by_tid_phases: dict[int, list[tuple[float, float, str]]] = {}
    flows: dict[tuple[str, int], dict[str, float]] = {}

    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing/empty name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                problems.append(f"{where}: {k} must be an int")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                problems.append(f"{where}: metadata event lacks args")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: ts must be a number >= 0, got {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: dur must be a number >= 0")
                continue
            if not isinstance(ev.get("cat"), str):
                problems.append(f"{where}: slice lacks cat")
                continue
            if ev["cat"] == "job":
                args = ev.get("args")
                if not isinstance(args, dict):
                    problems.append(f"{where}: job slice lacks args")
                    continue
                for k in ("round", "wall", "start", "outcome"):
                    if k not in args:
                        problems.append(f"{where}: job args missing {k!r}")
                by_tid_jobs.setdefault(ev["tid"], []).append((ts, ts + dur))
            else:
                by_tid_phases.setdefault(ev["tid"], []).append(
                    (ts, ts + dur, ev["name"])
                )
        else:  # flow s / f
            if not isinstance(ev.get("id"), int):
                problems.append(f"{where}: flow event lacks int id")
                continue
            if ph == "f" and ev.get("bp") != "e":
                problems.append(f"{where}: flow end should carry bp='e'")
            key = (ev.get("cat", ""), ev["id"])
            side = flows.setdefault(key, {})
            if ph in side:
                problems.append(f"{where}: duplicate flow {ph} for id {key}")
            side[ph] = ts

    for tid, slices in by_tid_jobs.items():
        slices.sort()
        for (s0, e0), (s1, _e1) in zip(slices, slices[1:]):
            if s1 < e0 - _EPS_US:
                problems.append(
                    f"tid {tid}: overlapping job slices "
                    f"([{s0}, {e0}] then start {s1})"
                )
    for tid, phases in by_tid_phases.items():
        jobs = sorted(by_tid_jobs.get(tid, []))
        for ts, te, name in phases:
            if not any(js - _EPS_US <= ts and te <= je + _EPS_US
                       for js, je in jobs):
                problems.append(
                    f"tid {tid}: phase slice {name!r} [{ts}, {te}] outside "
                    "every job slice"
                )
    for key, side in flows.items():
        if set(side) != {"s", "f"}:
            problems.append(f"flow {key}: needs exactly one s and one f, "
                            f"got {sorted(side)}")
        elif side["f"] < side["s"] - _EPS_US:
            problems.append(f"flow {key}: ends before it starts")
    return problems


# --------------------------------------------------------------------------
# Reconstruction + aggregation
# --------------------------------------------------------------------------


def report_from_trace(trace) -> Report:
    """Rebuild a Report from an exported trace.

    Job identities are gone (``job=None``) but the timeline accounting is
    complete: walls/starts/rounds come from the exact floats in ``args``
    (json round-trips Python floats losslessly), in the original record
    order, so ``net_time`` / ``total_time`` / ``net_time_by_events(W)``
    reproduce the source report's values bit-exactly.
    """
    from repro_torch.core.executor import JobRecord, Report

    if isinstance(trace, dict):
        events = trace["traceEvents"]
    else:
        events = trace
    recs: list[JobRecord] = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "job":
            continue
        a = ev["args"]
        start, wall = a["start"], a["wall"]
        recs.append(
            JobRecord(
                None, int(a["round"]), wall, {}, int(a.get("attempts", 1)),
                str(a.get("backend", "")), start, start + wall,
                int(a.get("slot", -1)),
                attempt=int(a.get("attempt", 0)),
                speculative=bool(a.get("speculative", False)),
                cancelled=bool(a.get("cancelled", False)),
                outcome=str(a.get("outcome", "ok")),
            )
        )
    return Report(recs)


def audit_trace(trace) -> list:
    """Offline-sanitize an exported trace (DESIGN.md §15); returns
    :class:`~repro_torch.analysis.verifier.Finding`s (empty == clean).

    The trace is first schema-validated (:func:`validate_trace`; problems
    become ``trace-schema`` findings), then its timeline is rebuilt via
    :func:`report_from_trace` and handed to the happens-before
    sanitizer's offline mode: conflicting records — relation access sets
    recovered from the ``reads``/``writes`` the exporter embeds in each
    job slice's ``args`` — must occupy disjoint intervals of the virtual
    timeline, slots must be exclusive, and every record must satisfy
    ``end == start + wall``.  Traces exported before the access sets
    existed still get the timeline-shape checks (conflicts are just
    undetectable without ``reads``/``writes``).  Speculative attempt
    pairs are identified by (name, round, accesses) — first-completion
    -wins pairs are exempt from the race check, as in the online mode.
    """
    from repro_torch.analysis.sanitizer import sanitize_timeline
    from repro_torch.analysis.verifier import Finding

    findings = [
        Finding("error", "trace-schema", -1, (), p)
        for p in validate_trace(trace)
    ]
    report = report_from_trace(trace)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    accesses: list[tuple[frozenset, frozenset]] = []
    keys: list = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "job":
            continue
        a = ev["args"]
        reads = frozenset(a.get("reads", ()))
        writes = frozenset(a.get("writes", ()))
        accesses.append((reads, writes))
        keys.append((ev.get("name"), a.get("round"), reads, writes))
    findings.extend(sanitize_timeline(report.records, accesses, keys))
    return findings


def phase_breakdown(report: Report) -> dict[str, dict]:
    """Aggregate span walls/bytes/counts by span name across a report —
    the per-tick table ``examples/sgf_service.py`` prints.  Parent spans
    (``ft.attempt``) include their children's time; leaf phases partition
    their parent, so read the table level by level."""
    agg: dict[str, dict] = {}
    for rec in report.records:
        for root in getattr(rec, "spans", ()):
            for sp in root.walk():
                row = agg.setdefault(
                    sp.name, {"count": 0, "wall": 0.0, "bytes": 0}
                )
                row["count"] += 1
                row["wall"] += sp.dur
                row["bytes"] += int(sp.args.get("bytes", 0))
    return dict(sorted(agg.items()))
