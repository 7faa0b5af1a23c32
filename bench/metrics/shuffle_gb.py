"""Bytes the runner exchanged between shards per query
(``Report.bytes_shuffled()``: forward and backward messages and the count
exchange, exact), in GB, over every step of the run."""
from bench.readers import shuffled_gb_per_query as read  # noqa: F401
