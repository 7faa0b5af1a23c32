"""Static plan verification + dynamic schedule sanitizing (DESIGN.md §15).

``repro_torch.analysis`` independently re-checks the obligations the planner
and executor rely on: :mod:`~repro_torch.analysis.verifier` re-derives job
conflicts from first principles and demands a covering DAG path for
every pair touching a common relation with a write;
:mod:`~repro_torch.analysis.sanitizer` clocks the schedules that actually ran
(online behind ``ExecutorConfig.sanitize=True``, offline over a Report
or an exported Perfetto trace).  ``python -m repro_torch.analysis --corpus``
runs the verifier over the bench/service plan corpus as a CI gate.
"""
from repro_torch.analysis.sanitizer import (
    SanitizerError,
    ScheduleSanitizer,
    sanitize_report,
    sanitize_timeline,
)
from repro_torch.analysis.verifier import (
    Finding,
    derive_accesses,
    errors,
    verify_nodes,
    verify_plan,
)

__all__ = [
    "Finding",
    "SanitizerError",
    "ScheduleSanitizer",
    "derive_accesses",
    "errors",
    "sanitize_report",
    "sanitize_timeline",
    "verify_nodes",
    "verify_plan",
]
