"""Device operations (kernels, copies, fills) per query in the profiled
part of the window, from ``torch.profiler``'s device trace."""
from bench.readers import device_ops_per_query as read  # noqa: F401
