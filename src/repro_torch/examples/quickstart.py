"""Quickstart: evaluate the paper's running example (§1) end to end.

    SELECT (x,y) FROM R(x,y) WHERE (S(x,y) OR S(y,x)) AND T(x,z)

Builds a small synthetic database, plans the query under PAR / GREEDY /
1-ROUND, executes each on an 8-shard simulated mesh, checks the results
against the set-semantics oracle, and prints the paper's metrics.  The
relations live on the card unless ``--device cpu``; there every MSJ job's
``probe_backend="auto"`` resolves per job through the cost model.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import ref_engine
from repro_torch.core.algebra import And, Atom, BSGF, Or
from repro_torch.core.costmodel import HADOOP, stats_of_db
from repro_torch.core.executor import execute_plan
from repro_torch.core.planner import plan_greedy, plan_one_round, plan_par
from repro_torch.core.relation import db_from_dict, resolve_device
from repro_torch.engine.comm import SimComm

P = 8
#: the plans by short name, with the script's printed label
LABELS = {
    "PAR": "PAR     (one job per semi-join)",
    "GREEDY": "GREEDY  (gain-grouped MSJ jobs)",
    "1-ROUND": "1-ROUND (fused MSJ+EVAL)       ",
}


def make_db(n_r: int = 2000, n_s: int = 1500, n_t: int = 1000, *, domain: int = 64,
            seed: int = 0) -> dict[str, np.ndarray]:
    """Binary ``R``, ``S``, ``T`` of uniform values over ``[0, domain)``."""
    rng = np.random.default_rng(seed)
    return {
        "R": rng.integers(0, domain, (n_r, 2)).astype(np.int32),
        "S": rng.integers(0, domain, (n_s, 2)).astype(np.int32),
        "T": rng.integers(0, domain, (n_t, 2)).astype(np.int32),
    }


def running_example() -> BSGF:
    return BSGF(
        "Z", ("x", "y"), Atom("R", "x", "y"),
        And(Or(Atom("S", "x", "y"), Atom("S", "y", "x")), Atom("T", "x", "z")),
    )


def oracle(db_np, query) -> set[tuple]:
    """The set-semantics answer (``ref_engine``'s, by its indexed form)."""
    setdb = {k: {tuple(map(int, r)) for r in v} for k, v in db_np.items()}
    return ref_engine.indexed_bsgf(setdb, query)


def plans_for(query, db) -> dict:
    return {
        "PAR": plan_par([query]),
        "GREEDY": plan_greedy([query], stats_of_db(db), HADOOP),
        "1-ROUND": plan_one_round([query]),
    }


def run_plan(db, plan, want, *, P: int = P, label: str = ""):
    """Execute ``plan`` on ``SimComm(P)``; the output must equal ``want``.
    Returns (env, report)."""
    env, report = execute_plan(db, plan, SimComm(P))
    got = env["Z"].to_set()
    assert got == want, f"{label}: WRONG RESULT"
    return env, report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    db_np = make_db()
    query = running_example()
    print("query:", query)
    want = oracle(db_np, query)
    print(f"oracle: |Z| = {len(want)}")

    db = db_from_dict(db_np, P=P, device=device)
    out = {"device": str(device), "oracle_rows": len(want), "plans": {}}
    for name, plan in plans_for(query, db).items():
        env, report = run_plan(db, plan, want, label=LABELS[name])
        s = report.summary()
        print(f"{LABELS[name]}: |Z|={len(want):4d}  jobs={s['jobs']}  rounds={plan.n_rounds}  "
              f"shuffled={s['bytes_shuffled']:8d}B  net={s['net_time']*1e3:7.1f}ms  "
              f"total={s['total_time']*1e3:7.1f}ms")
        out["plans"][name] = {
            "rows": len(want), "jobs": s["jobs"], "rounds": plan.n_rounds,
            "bytes_shuffled": s["bytes_shuffled"], "net_time": s["net_time"],
            "total_time": s["total_time"],
        }
    print("all plans agree with the oracle ✓")
    return out


if __name__ == "__main__":
    main()
