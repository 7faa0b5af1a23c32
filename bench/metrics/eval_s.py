"""Seconds per query in the EVAL operator: the sum of its ``eval.*``
phase spans (shuffle, reduce), each ended by a device barrier."""
from bench.readers import phases_per_query


def read(record):
    return phases_per_query(record, "eval.")
