"""The ``msj.probe`` stage's share of its roofline, in %: the least time
its work could take over the device time of the operations the stage
launched, from the profiler's trace.  The work is counted from the job's
exact counters, never from the kernel's arguments, so it is the same
whatever implements the stage (``bench.readers.probe_roofline_percent``)."""
from bench.readers import probe_roofline_percent as read  # noqa: F401
