"""Happens-before schedule sanitizer (DESIGN.md §15).

The async ready-queue walk (``Executor._execute_async``) promises that
every pair of conflicting jobs — a common relation with at least one
write — is ordered by the dependency edges it dispatched under.  The
sanitizer *checks* that promise against the schedule that actually ran,
record by record, instead of trusting the DAG builder:

* **online** (``ExecutorConfig.sanitize=True``) — a
  :class:`ScheduleSanitizer` observes every :class:`JobRecord` the walk
  emits (speculative attempts, failed records, ``narrow_job`` remainders
  and zero-wall tainted markers included) and assigns each plan node a
  vector clock: the component-wise join of its dependencies' clocks at
  completion, ticked at its own dispatch.  With one dispatch event per
  node the clock degenerates to the node's happens-before ancestor set,
  which is exactly what the race check needs: two records conflict-race
  iff their relations conflict and *neither clock dominates the other*.
  Timing is deliberately not consulted for the race check — a pair the
  scheduler happened to serialize this run but that no edge orders is
  still flagged.  Timeline-shape invariants (slot exclusivity,
  ``end == start + wall``, no dispatch before a dependency completes)
  are checked per record as they stream in.  Zero overhead when off:
  the executor holds no sanitizer object and branches on ``None``.

* **offline** (:func:`sanitize_report` / ``perfetto.audit_trace``) — a
  finished :class:`~repro_torch.core.executor.Report` (or one rebuilt from an
  exported Perfetto trace via ``report_from_trace``) carries no
  dependency edges, so happens-before degrades to the virtual timeline:
  conflicting executed records must occupy disjoint time intervals.
  Races the schedule happened to serialize are invisible offline; the
  online mode exists precisely to close that gap.

Effective access sets respect publication: every dispatched record
*reads*, but only an ``outcome == "ok"`` record's writes were published
(failed/cancelled/tainted records publish nothing), so a cancelled
speculation loser cannot write-conflict with its winner.  Attempts of
one logical job (same plan-node index online, same record key offline)
are exempt from the race check — first-completion-wins is their
synchronization discipline.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.analysis.verifier import Finding, derive_accesses
from repro_torch.core.planner import conflict_rels, dag_closure

#: relative tolerance for timeline-shape identities (floats accumulate
#: through max/min chains in the virtual schedule; the executor's own
#: arithmetic keeps end == start + wall exact, so this is pure headroom)
_EPS = 1e-9


class SanitizerError(RuntimeError):
    """Raised by a sanitized execute when the schedule shows a race or a
    broken timeline invariant.  ``findings`` carries the diagnostics
    (also left on ``Executor.last_sanitize``)."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            f"schedule sanitizer: {len(self.findings)} finding(s)\n{lines}"
        )


def _effective_accesses(rec) -> tuple[frozenset[str], frozenset[str]]:
    """``(reads, writes)`` a record actually performed: tainted records
    never dispatched (nothing), non-ok records read but published
    nothing."""
    if rec.outcome == "tainted" or rec.job is None:
        return frozenset(), frozenset()
    reads, writes = derive_accesses(rec.job)
    if rec.outcome != "ok":
        return reads, frozenset()
    return reads, writes


def _shape_findings(rec, key: int, *, add) -> None:
    """Per-record timeline-shape invariants (both modes)."""
    if rec.start < 0.0 or rec.end < 0.0:
        return  # no event info recorded (legacy path); nothing to clock
    tol = _EPS * max(1.0, abs(rec.end))
    if abs((rec.start + rec.wall) - rec.end) > tol:
        add(Finding(
            "error", "event-shape", key, (),
            f"end != start + wall ({rec.end} != {rec.start} + {rec.wall})",
        ))
    if rec.outcome == "tainted" and (rec.wall != 0.0 or rec.slot != -1):
        add(Finding(
            "error", "event-shape", key, (),
            "tainted record must be a zero-wall, slot -1 marker "
            f"(wall={rec.wall}, slot={rec.slot})",
        ))


class ScheduleSanitizer:
    """Online happens-before checker for one async execute.

    The executor calls :meth:`observe` for every record it appends (with
    the record's plan-node index and dependency edges), :meth:`complete`
    when a node's completion time is fixed, and :meth:`finish` after the
    walk drains.  See the module docstring for the clock construction.
    """

    def __init__(self, nodes: Sequence | None = None) -> None:
        self.findings: list[Finding] = []
        #: node idx -> happens-before ancestor node set (its vector clock
        #: with one event per node: dominance == superset-with-self).
        #: Pre-seeded from the full node table when the executor hands it
        #: over (exact even for tainted nodes swept before their deps
        #: dispatched); grown incrementally from observe()'s deps otherwise.
        self._clock: dict[int, frozenset[int]] = (
            dag_closure(nodes) if nodes is not None else {}
        )
        self._completed: dict[int, float] = {}
        #: executed records: (node_idx, record, reads, eff_writes)
        self._seen: list[tuple[int, object, frozenset[str], frozenset[str]]] = []
        self._slot_busy: dict[int, list[tuple[float, float, int]]] = {}

    # -- executor-facing hooks --------------------------------------------
    def observe(self, rec, node_idx: int, deps: tuple[int, ...]) -> None:
        add = self.findings.append
        if node_idx not in self._clock:
            anc: set[int] = set()
            for d in deps:
                anc.add(d)
                anc |= self._clock.get(d, frozenset())
            self._clock[node_idx] = frozenset(anc)
        _shape_findings(rec, node_idx, add=add)
        if rec.outcome == "tainted":
            return  # never dispatched: no accesses, no slot, no gating
        for d in deps:
            done = self._completed.get(d)
            if done is not None and done > rec.start + _EPS * max(1.0, done):
                add(Finding(
                    "error", "early-dispatch", node_idx, (),
                    f"dispatched at {rec.start} before dependency {d} "
                    f"completed at {done}",
                ))
        for s0, e0, other in self._slot_busy.get(rec.slot, ()):
            if rec.start < e0 and s0 < rec.end and other != node_idx:
                add(Finding(
                    "error", "slot-overlap", node_idx, (),
                    f"[{rec.start}, {rec.end}) on slot {rec.slot} overlaps "
                    f"job {other}'s [{s0}, {e0})",
                ))
        self._slot_busy.setdefault(rec.slot, []).append(
            (rec.start, rec.end, node_idx)
        )
        reads, writes = _effective_accesses(rec)
        my_clock = self._clock[node_idx]
        for o_idx, o_rec, o_reads, o_writes in self._seen:
            if o_idx == node_idx:
                continue  # attempts of one job: first-completion-wins
            rels = conflict_rels(o_reads, o_writes, reads, writes)
            if not rels:
                continue
            ordered = (
                o_idx in my_clock
                or node_idx in self._clock.get(o_idx, frozenset())
            )
            if not ordered:
                add(Finding(
                    "error", "unordered-conflict", node_idx,
                    tuple(sorted(rels)),
                    f"records of jobs {o_idx} and {node_idx} conflict on "
                    f"{', '.join(sorted(rels))} with neither clock "
                    "dominating — no dependency path orders the pair",
                ))
        self._seen.append((node_idx, rec, reads, writes))

    def complete(self, node_idx: int, end: float) -> None:
        self._completed[node_idx] = end

    def finish(self) -> list[Finding]:
        return self.findings


# --------------------------------------------------------------------------
# offline mode
# --------------------------------------------------------------------------


def sanitize_timeline(
    records: Sequence,
    accesses: Sequence[tuple[frozenset[str], frozenset[str]]] | None = None,
    keys: Sequence | None = None,
) -> list[Finding]:
    """Audit a finished record timeline without dependency edges.

    ``accesses`` overrides per-record ``(reads, writes)`` — the trace
    auditor passes sets recovered from the exported ``args`` (a
    round-tripped record's ``job`` is ``None``).  ``keys`` assigns each
    record a logical-job identity; records sharing a key (speculative
    attempts of one job) are exempt from the race check.  Effective
    writes still require ``outcome == "ok"``.
    """
    findings: list[Finding] = []
    add = findings.append
    n = len(records)
    if accesses is None:
        accesses = [_effective_accesses(r) for r in records]
    else:
        accesses = [
            (reads, writes if r.outcome == "ok" else frozenset())
            if r.outcome != "tainted" else (frozenset(), frozenset())
            for r, (reads, writes) in zip(records, accesses)
        ]
    if keys is None:
        keys = list(range(n))
    for i, rec in enumerate(records):
        _shape_findings(rec, i, add=add)
    executed = [
        i for i, r in enumerate(records)
        if r.outcome != "tainted" and r.start >= 0.0
    ]
    by_slot: dict[int, list[int]] = {}
    for i in executed:
        by_slot.setdefault(records[i].slot, []).append(i)
    for slot, idxs in by_slot.items():
        idxs = sorted(idxs, key=lambda i: (records[i].start, records[i].end))
        for a, b in zip(idxs, idxs[1:]):
            if keys[a] != keys[b] and records[b].start < records[a].end:
                add(Finding(
                    "error", "slot-overlap", b, (),
                    f"records {a} and {b} overlap on slot {slot}",
                ))
    for ai in range(len(executed)):
        for bi in range(ai + 1, len(executed)):
            a, b = executed[ai], executed[bi]
            if keys[a] == keys[b]:
                continue
            rels = conflict_rels(*accesses[a], *accesses[b])
            if not rels:
                continue
            ra, rb = records[a], records[b]
            if ra.start < rb.end and rb.start < ra.end:  # time-overlapping
                add(Finding(
                    "error", "unordered-conflict", b, tuple(sorted(rels)),
                    f"records {a} and {b} conflict on "
                    f"{', '.join(sorted(rels))} and overlap in time "
                    f"([{ra.start}, {ra.end}) vs [{rb.start}, {rb.end}))",
                ))
    return findings


def sanitize_report(report) -> list[Finding]:
    """Offline-audit a finished :class:`~repro_torch.core.executor.Report`.

    Speculative attempt pairs are identified by the job object itself
    (both attempts carry the same job), so first-completion-wins pairs
    are exempt exactly as in the online mode."""
    keys = [repr(r.job) for r in report.records]
    return sanitize_timeline(report.records, keys=keys)
