"""Phase-span tracing for the executor's event timeline (DESIGN.md §14).

A :class:`Span` is one named interval *inside* a job attempt — a pipeline
stage (``msj.shuffle.fwd``, ``msj.probe``), a retry attempt
(``ft.attempt``), or host-side bookkeeping (``ft.taint.sweep``) — with
wall seconds, free-form args (bytes, rows, outcome), and child spans.
Span times are stored **relative to the enclosing job's dispatch** so the
exporter can place them under the job slice at any virtual timeline
position, and they are rescaled whenever the executor rescales the job's
wall (``wall_scale`` straggler injection, speculation-loser truncation),
keeping every child interval inside its parent.

The contract with the hot path: *every* tracing call site guards on
``tracer is None`` (or ``tracer.enabled``) before doing any work, so the
untraced build executes the identical instruction stream — bench numbers
and outputs are bit-identical with ``tracer=None``.  A *traced* run also
executes the identical instruction stream by default: spans bracket
dispatch without syncing between stages, so enabling the tracer cannot
serialize shuffle/compute overlap (DESIGN.md §16) or change what it
measures.  ``Tracer(trace_sync=True)`` opts into the old
block-until-ready-per-stage behaviour when honest per-phase *device*
walls matter more than fidelity of the schedule being observed.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    """One traced phase: ``[t0, t0 + dur)`` relative to the job dispatch."""

    name: str
    cat: str = "phase"
    t0: float = 0.0
    dur: float = 0.0
    args: dict = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def rebase(spans: list[Span], t0: float, scale: float = 1.0) -> list[Span]:
    """Rebase absolute perf_counter times to offsets from ``t0`` and scale
    every interval by ``scale`` — the executor applies the same factor it
    applied to the job's wall (straggler injection / loser truncation), so
    spans stay nested inside the job slice.  Children share the parent's
    origin (all offsets are job-relative, not parent-relative)."""
    for sp in spans:
        sp.t0 = (sp.t0 - t0) * scale
        sp.dur *= scale
        rebase(sp.children, t0, scale)
    return spans


def scale_spans(spans: list[Span], scale: float) -> list[Span]:
    """Rescale already-rebased spans (speculation-loser truncation)."""
    for sp in spans:
        sp.t0 *= scale
        sp.dur *= scale
        scale_spans(sp.children, scale)
    return spans


class Tracer:
    """Collects nested spans via a context-manager stack.

    ``capture()`` opens a fresh collection root (one per job attempt in
    the executor) and yields the list spans land in; ``span(name)`` times
    a phase and nests it under the innermost open span.  A tracer is
    reusable and single-threaded — the executor dispatches jobs serially
    on this container, so one stack suffices.
    """

    def __init__(self, enabled: bool = True, *, trace_sync: bool = False):
        self.enabled = enabled
        #: opt-in per-stage barrier in the pipeline runner: attributes
        #: device time to phases at the cost of serializing the dispatch
        #: stream (and any comm/compute overlap).  Default off — tracing
        #: must not perturb the schedule it measures.
        self.trace_sync = trace_sync
        self._stack: list[list[Span]] = []

    def current(self) -> list[Span]:
        """The span list currently being appended to (for post-hoc
        annotation of just-recorded spans, e.g. shuffle byte counts)."""
        return self._stack[-1] if self._stack else []

    @contextmanager
    def capture(self):
        """Collect top-level spans of one job attempt into a fresh list.

        Span ``t0`` values are raw ``perf_counter`` readings until the
        caller runs :func:`rebase` against the attempt's dispatch time.
        """
        root: list[Span] = []
        self._stack.append(root)
        try:
            yield root
        finally:
            self._stack.pop()

    @contextmanager
    def span(self, name: str, cat: str = "phase", **args):
        """Time one phase; nests under the innermost open span (if any).

        Yields the :class:`Span` so callers can attach result args
        (bytes, rows, outcome) after the timed region.
        """
        sp = Span(name, cat, time.perf_counter(), 0.0, dict(args))
        if not self._stack:
            self._stack.append([])  # tolerate spans outside capture()
        self._stack[-1].append(sp)
        self._stack.append(sp.children)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.dur = time.perf_counter() - sp.t0
