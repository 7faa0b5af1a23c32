#!/usr/bin/env python3
"""The control of a cell's check: the reference with an approximate
semi-join (``bench/reference/approx.py``) put in the program's place, at
the cell's own size, judged by the same check as a run.  It has to come
out not correct on every seed.

    python3 bench/control.py --workload a3.one_round --seeds 11 12 13 [--device cuda]

Prints one JSON line per seed with the numbers compared, over one answer
of each of the configuration's queries.  Runs on the card by default;
``--rows`` overrides the configuration's rows (the CPU test's small
size).
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT)]

from bench import harness  # noqa: E402
from bench.reference import approx, datagen, semijoin  # noqa: E402


def control_steps(config: dict, seed: int, device) -> list:
    """The step a run of the cell would record, each answer computed by
    the approximate reference over the relations its request reads."""
    rels = datagen.config_rows(config, seed, device=device)
    return [{"answers": [({"query": q, "versions": {}},
                          semijoin.evaluate(q, rels, approx.bloom_member).cpu())
                         for q in config["queries"]]}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rows", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    parts = harness.cell_parts(harness.load_manifest(ROOT), args.workload, ROOT)
    config = dict(parts["config"], **({"rows": args.rows} if args.rows else {}))
    for seed in args.seeds:
        t0 = time.perf_counter()
        steps = control_steps(config, seed, args.device)
        numbers = harness.check(config, seed, steps, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "rows": config["rows"],
                          "correct": harness.passes(numbers), "seconds": time.perf_counter() - t0,
                          "check": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
