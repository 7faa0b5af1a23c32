"""Share of the profiled window in which no operation ran on the device,
in %: 100 (1 - busy / window), busy the union of the device trace's
intervals."""
from bench.readers import idle_percent as read  # noqa: F401
