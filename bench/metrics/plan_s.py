"""Seconds per query in the planner: the benchmark's span around the
planning call (GREEDY's ``stats_of_db`` included), in the traced steps."""
from bench.readers import traced_steps


def read(record):
    steps = [s for s in traced_steps(record) if "plan" in s["spans"]]
    served = sum(s["served"] for s in steps)
    return sum(s["spans"]["plan"] for s in steps) / served if served else None
