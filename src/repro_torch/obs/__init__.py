"""Observability: phase-span tracing (DESIGN.md §14).

:mod:`repro_torch.obs.tracer` — :class:`Span`/:class:`Tracer`: nested
phase spans hanging off each :class:`~repro_torch.core.executor.JobRecord`.
``tracer=None`` everywhere means *no* tracing code runs.
"""
from repro_torch.obs.tracer import Span, Tracer  # noqa: F401
