"""Seconds per query in the executor itself: the benchmark's span around
``Executor.execute`` (to the device's end) less the operators' phase
spans of its jobs, in the traced steps."""
from bench.readers import span_self_per_query


def read(record):
    return span_self_per_query(record, "execute")
