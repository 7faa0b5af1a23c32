"""Seconds per query in the MSJ operator: the sum of its ``msj.*`` phase
spans (count, bloom, forward shuffle, probe, scatter), each ended by a
device barrier, in the traced steps."""
from bench.readers import phases_per_query


def read(record):
    return phases_per_query(record, "msj.")
