"""Seconds of the window per query answered, on the executor's cells: the
whole window, set-up excluded, over every query completed in it."""
from bench.readers import window_per_query as read  # noqa: F401
