"""Quickstart for the SGF query service (DESIGN.md §9–§11).

Eight tenants submit mixed A-family queries against catalog-resident
relations; the service fuses each tick's admissions into one multi-tenant
plan (canonical dedup + cross-tenant semi-join pooling), caches the plan
by canonical fingerprint, and runs it on the ready-queue executor under W
cluster slots: each job launches as soon as its predecessors complete and
a slot frees, with a per-job probe-backend decision from the cost model
(the event timeline and backend choices print below).  A second round of
the same traffic is served entirely from the cross-tick result cache —
zero jobs, zero shuffled bytes — and per-relation epochs keep the cache
warm across unrelated catalog registrations while invalidating exactly
the queries that read a re-registered relation.

The service is constructed with a :class:`~repro_torch.obs.Tracer`, so
every job record carries phase spans (count-exchange, forward shuffle,
probe, scatter — DESIGN.md §14): a per-tick phase breakdown table prints
below and the tick's full timeline is exported as Chrome/Perfetto JSON
to ``--trace`` (open it at https://ui.perfetto.dev).  The catalog lives
on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.sgf_service [--device cpu] [--trace PATH]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import queries as Q, ref_engine
from repro_torch.core.algebra import Atom, BSGF, all_of
from repro_torch.core.relation import resolve_device
from repro_torch.obs import Tracer, phase_breakdown, write_trace
from repro_torch.service import SGFService, catalog_from_numpy

XYZW = ("x", "y", "z", "w")
P, TENANTS, SLOTS = 8, 8, 4
ROWS = 2048  # rows per guard and per conditional relation
TRACE = "sgf_service.trace.json"


def tenant_query(t: int) -> BSGF:
    guard = "R" if t % 2 == 0 else "G"
    conds = (
        [Atom(r, "x") for r in "STUV"]  # A3-style: key sharing
        if t % 3 == 1
        else [Atom(r, v) for r, v in zip("STUV", XYZW)]  # A1/A5-style
    )
    return BSGF("Z", XYZW, Atom(guard, *XYZW), all_of(*conds))


def _tick(svc, label: str, requests) -> dict:
    """The numbers of the tick just run, with its requests."""
    return {"tick": label, "requests": requests, "jobs": svc.last_report.n_jobs,
            "bytes_shuffled": svc.last_report.bytes_shuffled(),
            "canonical": len(svc.last_batch.queries), "deduped": svc.last_batch.n_deduped,
            "last_tick": dict(svc.last_tick), "counters": svc.counters()}


def serve(workload, db_np, *, P: int = P, slots: int = SLOTS, device=None,
          trace_path: str = TRACE) -> dict:
    """The script's four ticks: one request per query of ``workload`` (one
    tenant each) over the catalog of ``db_np``; every check of the script
    raises on failure.  Returns the catalog's size, each tick's numbers and
    requests, tick 1's phase breakdown and the trace's path."""
    # 1. register relations once; queries then reference them by name
    catalog = catalog_from_numpy(db_np, P=P, device=device)
    n_relations = len(catalog)
    print(f"catalog: {n_relations} relations over P={P} shards")

    # 2. admit one tick of traffic and run it as one fused plan on the
    #    ready-queue executor under W slots; the tracer records phase spans
    #    on every job record (tracer=None would skip them at zero cost)
    svc = SGFService(catalog, slots=slots, tracer=Tracer())
    requests = [svc.submit([q]) for q in workload]
    svc.tick()
    batch, report = svc.last_batch, svc.last_report
    ticks = [_tick(svc, "cold", requests)]
    print(
        f"tick 1: {len(workload)} tenants -> {len(batch.queries)} canonical queries "
        f"({batch.n_deduped} deduped), {report.n_jobs} jobs, "
        f"{report.bytes_shuffled()} bytes shuffled, "
        f"net(W={slots})={report.event_makespan()*1e3:.1f}ms"
    )

    # the event timeline the executor recorded: one line per job, showing
    # the slot it occupied, its virtual start/end, and the per-job backend
    # the cost model picked (an MSJ job's sorted/kernel/dense decision;
    # EVAL "-")
    print(f"event timeline (W={slots} slots):")
    for rec in report.records:
        print(
            f"  slot {rec.slot}  {rec.start*1e3:7.1f} -> {rec.end*1e3:7.1f} ms"
            f"  backend={rec.backend or '-':6s}  {rec.job}"
        )
    assert report.net_time_by_events(None) == report.net_time  # W=inf identity
    assert report.net_time_by_events(1) == report.total_time  # W=1 identity

    # where the tick's time went, phase by phase (aggregated over the spans
    # the tracer recorded inside every job attempt)
    phases = phase_breakdown(report)
    print("phase breakdown (tick 1):")
    print(f"  {'phase':<16s} {'count':>5s} {'wall':>9s} {'bytes':>10s}")
    for name, agg in sorted(phases.items()):
        print(f"  {name:<16s} {agg['count']:>5d} {agg['wall']*1e3:>7.1f}ms "
              f"{agg['bytes']:>10d}")

    # the same timeline as a Chrome/Perfetto trace: per-slot tracks, nested
    # phase slices, flow arrows for DAG edges — load it at ui.perfetto.dev
    trace_path = write_trace(trace_path, report, title="tick-1", metrics=svc.metrics)
    print(f"exported trace: {trace_path}")

    # 3. verify against the set-semantics oracle (ref_engine's, by its
    #    indexed form)
    setdb = {k: {tuple(map(int, r)) for r in v} for k, v in db_np.items()}
    for req, q in zip(requests, workload):
        assert req.outputs[q.name].to_set() == ref_engine.indexed_bsgf(setdb, q)
    print("all tenant outputs agree with the oracle ✓")

    # 4. the same traffic again: every canonical query is warm in the result
    #    cache — the tick runs zero jobs and shuffles zero bytes
    warm_reqs = [svc.submit([q]) for q in workload]
    svc.tick()
    rep = svc.last_report
    ticks.append(_tick(svc, "warm", warm_reqs))
    print(
        f"tick 2: {svc.last_tick['warm_queries']} warm / "
        f"{svc.last_tick['cold_queries']} cold -> {rep.n_jobs} jobs, "
        f"{rep.bytes_shuffled()} bytes shuffled"
    )
    assert rep.n_jobs == 0 and rep.bytes_shuffled() == 0
    for req, q in zip(warm_reqs, workload):
        assert req.outputs[q.name].to_set() == ref_engine.indexed_bsgf(setdb, q)

    # 5. per-relation epochs: registering an unrelated relation keeps every
    #    cached plan and result warm ...
    svc.catalog.register("BYSTANDER", np.asarray([[0, 0]], np.int32))
    reqs = [svc.submit([q]) for q in workload]
    svc.tick()
    ticks.append(_tick(svc, "unrelated_register", reqs))
    print(f"tick 3 (unrelated register): {svc.last_report.n_jobs} jobs")
    assert svc.last_report.n_jobs == 0

    # ... while re-registering a relation the queries actually read
    # invalidates exactly its readers (here: every query conditions on S)
    svc.catalog.register("S", db_np["S"])
    reqs = [svc.submit([q]) for q in workload]
    svc.tick()
    ticks.append(_tick(svc, "dependent_register", reqs))
    print(
        f"tick 4 (S re-registered): {svc.last_tick['cold_queries']} cold, "
        f"{svc.last_tick['x_injected']} X_i served warm, "
        f"{svc.last_report.n_jobs} jobs"
    )
    assert svc.last_tick["cold_queries"] == len(svc.last_batch.queries)
    print(f"service counters: {svc.counters()}")
    return {"catalog": n_relations, "P": P, "ticks": ticks, "phases": phases,
            "trace": trace_path}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--trace", default=TRACE, help=f"Perfetto JSON of tick 1 (default {TRACE})")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    workload = [tenant_query(t) for t in range(TENANTS)]
    db_np = Q.gen_db(workload, n_guard=ROWS, n_cond=ROWS)
    out = serve(workload, db_np, device=device, trace_path=args.trace)
    for t in out["ticks"]:
        t.pop("requests")
    return {"device": str(device), **out}


if __name__ == "__main__":
    main()
