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

The clock contract: ``t0`` and ``dur`` are job-relative ``perf_counter``
seconds (rebased and rescaled as above), while ``ns0`` and ``ns1`` are the
span's two ends on ``time.time_ns``, the clock ``torch.profiler`` stamps
its events with, and are never rebased or rescaled.  Every span, of any
category, also lands in :attr:`Tracer.log` as ``(ns0, ns1, name, cat,
parent)``, so a device trace's idle gaps can be put down to the program
code the host was running.  Spans of category :data:`HOST` (the
executor's ``exec.*`` and the runner's ``sim.*``) go to the log alone:
the job span trees, which the exporter and ``phase_breakdown`` read, keep
the reference's taxonomy.

The contract with the hot path: *every* tracing call site guards on
``tracer is None`` before doing any work, so the untraced build executes
the identical instruction stream — bench numbers and outputs are
bit-identical with ``tracer=None``.  A *traced* run also executes the
identical device work by default: spans bracket dispatch without syncing
between stages, and device counters annotated on spans stay tensors until
the executor resolves them from the job's own stats reads, so enabling the
tracer cannot serialize shuffle/compute overlap (DESIGN.md §16) or read
back a value the untraced run does not.  ``Tracer(trace_sync=True)`` opts
into the old block-until-ready-per-stage behaviour when honest per-phase
*device* walls matter more than fidelity of the schedule being observed.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

#: category of the spans kept in :attr:`Tracer.log` alone
HOST = "host"


@dataclass
class Span:
    """One traced phase: ``[t0, t0 + dur)`` relative to the job dispatch,
    ``[ns0, ns1]`` on the profiler's clock."""

    name: str
    cat: str = "phase"
    t0: float = 0.0
    dur: float = 0.0
    args: dict = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)
    ns0: int = 0
    ns1: int = 0

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


def host_span(tracer: "Tracer | None", name: str):
    """``tracer.span(name, HOST)``, or nothing when ``tracer`` is None."""
    return nullcontext() if tracer is None else tracer.span(name, HOST)


class Tracer:
    """Collects nested spans via a context-manager stack.

    ``capture()`` opens a fresh collection root (one per job attempt in
    the executor) and yields the list spans land in; ``span(name)`` times
    a phase and nests it under the innermost open span.  A tracer is
    single-threaded — the executor dispatches jobs serially on this
    container, so one stack suffices — and serves one request: its
    :attr:`log` grows with every span it times.
    """

    def __init__(self, *, trace_sync: bool = False):
        #: opt-in per-stage barrier in the pipeline runner: attributes
        #: device time to phases at the cost of serializing the dispatch
        #: stream (and any comm/compute overlap).  Default off — tracing
        #: must not perturb the schedule it measures.
        self.trace_sync = trace_sync
        #: every span in the order it opened, as ``(ns0, ns1, name, cat,
        #: parent)`` once it has closed (None while it is open); ``parent``
        #: is the log index of the innermost span open around it, or None
        self.log: list[tuple | None] = []
        self._open: list[int] = []
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
        (bytes, rows, outcome) after the timed region.  A :data:`HOST`
        span is logged but joins no span tree.
        """
        sp = Span(name, cat, time.perf_counter(), 0.0, dict(args), ns0=time.time_ns())
        idx = len(self.log)
        parent = self._open[-1] if self._open else None
        self.log.append(None)
        self._open.append(idx)
        tree = cat != HOST
        if tree:
            if not self._stack:
                self._stack.append([])  # tolerate spans outside capture()
            self._stack[-1].append(sp)
            self._stack.append(sp.children)
        try:
            yield sp
        finally:
            if tree:
                self._stack.pop()
            self._open.pop()
            sp.dur = time.perf_counter() - sp.t0
            sp.ns1 = time.time_ns()
            self.log[idx] = (sp.ns0, sp.ns1, name, cat, parent)
