"""Dependency-driven plan executor with event-timeline accounting.

Runs a :class:`~repro_torch.core.planner.Plan` against a database, job by job,
through the comm runner (SimComm on CPU, MeshComm on a device mesh).  The
plan's job DAG (:func:`repro_torch.core.planner.job_dag`) is walked *online*: a
job launches as soon as its predecessors have completed and one of the W
cluster slots frees (event-driven list scheduling), so a straggler stalls
only its own slot instead of a whole barrier wave.  Edges are
relation-granular by default (``ExecutorConfig.dag_edges="relations"``,
DESIGN.md §12): a job waits only for the producers of relations it
actually reads, so independent strata overlap; ``dag_edges="strata"``
restores the conservative round-barrier DAG and
``ExecutorConfig.execution_mode="waves"`` the legacy barrier-wave
discipline, both for differential testing.

Straggler tolerance (``ExecutorConfig.speculate``): a dispatched job whose
wall exceeds its cost-model-scaled deadline
(:func:`repro_torch.core.costmodel.speculation_deadline`) is cloned onto a free
slot; the first attempt to complete wins, the loser is cancelled at the
winner's completion time and priced for exactly the slot time it consumed
(``JobRecord.attempt``/``speculative``/``cancelled``), so the replay
identities (W=∞ == net_time, W=1 == total_time) hold with duplicate
attempts present.  Overflow retries, injected-failure reroutes
(:class:`TransientFault`) and speculative clones of one job share a
single :class:`RetryState`, so a clone inherits learned capacity sizing
instead of relaxing ``cap_slack`` twice.

Timing semantics (see DESIGN.md §8/§11): a SimComm job serializes the
work of all P shards onto one device, so a job's wall time is a proxy for
the paper's *total time* contribution.  The executor assembles
the measured walls into a virtual W-slot event timeline
(``JobRecord.start/end/slot``); ``Report.event_makespan()`` prices the
schedule that actually ran and ``Report.net_time_by_events(W)`` re-prices
the same records under any slot budget (W=∞ reproduces ``net_time``
exactly, W=1 reproduces ``total_time``).

Per-job backend dispatch: with ``probe_backend="auto"`` each dequeued MSJ
job gets its own sorted/kernel/dense decision from the cost model
(:func:`repro_torch.core.costmodel.choose_backend`) using that job's relation
statistics — one fused multi-tenant plan can mix backends across jobs.

Fault-tolerance hooks: jobs raise :class:`CapacityFault` on exact shuffle
overflow; the supervisor (ft/supervisor.py) retries with doubled capacity
and re-dispatches straggler jobs.  ``on_job`` lets callers inject faults.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable, Sequence

import torch

from repro_torch.core.algebra import BSGF
from repro_torch.core.costmodel import Stats, choose_backend, speculation_deadline
from repro_torch.core.eval_op import EvalUnit, query_salt, run_eval
from repro_torch.core.msj import (
    FusedQuery,
    SaltTable,
    XferBuffer,
    collect_salt_table,
    conform_mask,
    make_spec,
    run_msj,
    run_msj_compute,
    run_msj_transfer,
    skew_route_of,
)
from repro_torch.core.planner import (
    DAG_EDGE_MODES,
    ComputeJob,
    EvalJob,
    Job,
    MSJJob,
    Plan,
    SkewProfileJob,
    TransferJob,
    job_dag,
    job_reads,
    job_writes,
    narrow_job,
)
from repro_torch.core.relation import Relation
from repro_torch.engine.comm import Comm
from repro_torch.obs.tracer import Span, rebase as _rebase_spans, scale_spans as _scale_spans


class CapacityFault(RuntimeError):
    """A shuffle bucket overflowed its static capacity (exact detection)."""

    def __init__(self, job, overflow: int):
        super().__init__(f"{job}: shuffle overflow of {overflow} messages")
        self.job = job
        self.overflow = overflow


class TransientFault(RuntimeError):
    """A retryable injected/external job failure (a preempted or crashed
    worker).  Raised by ``on_job`` hooks (e.g. the fault supervisor's
    injection policy); the executor's retry helper reroutes the job up to
    ``max_restarts`` times before letting it propagate."""


class PermanentFault(RuntimeError):
    """A non-retryable job failure (a poison query, a deterministic bug):
    retrying cannot help, so the retry helper lets it propagate
    immediately.  Under ``fail_policy="isolate"`` the ready-queue walk
    records the job as failed and sweeps its taint closure instead of
    aborting the plan (DESIGN.md §13).

    ``rels`` optionally *blames* specific relations (the poison tenant's
    guard, an unrecoverable lost shard's relation).  A blamed failure of a
    fused multi-tenant job is narrowed (:func:`repro_torch.core.planner.narrow_job`):
    only the units touching a blamed relation fail, the innocent remainder
    is re-dispatched — without blame the whole job is the failure unit."""

    def __init__(self, msg: str, *, rels: Iterable[str] = ()):
        super().__init__(msg)
        self.rels = frozenset(rels)


class ShardLoss(TransientFault):
    """One shard of a base relation was lost mid-execute (a failed worker
    holding that partition).  Retryable *after recovery*: the executor
    re-materializes the lost partition from its lineage sources (the
    catalog's resident rows, via ``ft/elastic.recover_shard``) before
    re-dispatching the job.  Injectors must damage ``executor.env`` (see
    ``ft/elastic.lose_shard``) before raising, so the recovery path is
    actually exercised."""

    def __init__(self, rel: str, shard: int):
        super().__init__(f"lost shard {shard} of relation {rel!r}")
        self.rel = rel
        self.shard = shard


@dataclass
class RetryState:
    """Per-plan-job retry state shared across *all* dispatches of one job:
    overflow retries, injected-failure reroutes, and speculative clones.

    Sharing one state object is what keeps the capacity ladder monotone —
    a speculative clone of a job whose original attempt already overflowed
    starts from the learned ``cap``/``slack`` instead of relaxing
    ``cap_slack`` a second time (and never mutates the ExecutorConfig).
    """

    cap: int | None = None  # learned forward-capacity override
    slack: float | None = None  # learned cap_slack override (1.0 = cleared)
    overflow_retries: int = 0
    fault_retries: int = 0

    def effective_slack(self, config: "ExecutorConfig") -> float:
        return config.cap_slack if self.slack is None else self.slack

    def on_overflow(self, config: "ExecutorConfig", stats: dict) -> None:
        """Advance the sizing ladder one step: the first relaxation drops
        deliberate undersizing (cap_slack < 1) and re-sizes from counts /
        the worst-case bound; further overflows (stale counts) double the
        observed capacity."""
        if self.effective_slack(config) < 1.0:
            self.cap, self.slack = None, 1.0
        else:
            self.cap = max(int(stats.get("forward_cap", 0)), 1) * 2
        self.overflow_retries += 1


@dataclass
class JobRecord:
    job: Job
    round_idx: int
    wall: float
    stats: dict
    attempts: int = 1
    #: probe backend the job actually ran ("" for EVAL jobs / legacy paths).
    backend: str = ""
    #: event timeline: virtual start/end (seconds) and the cluster slot the
    #: job occupied in the W-slot schedule (-1: no event info recorded).
    start: float = -1.0
    end: float = -1.0
    slot: int = -1
    #: speculative re-dispatch: dispatch index of this attempt (0 = the
    #: original), whether it was a speculative clone, and whether it lost
    #: the first-completion-wins race (cancelled at the winner's end; its
    #: ``wall`` then prices exactly the slot time consumed, keeping
    #: ``end == start + wall`` and the replay identities exact).
    attempt: int = 0
    speculative: bool = False
    cancelled: bool = False
    #: how the record ended (DESIGN.md §13): "ok" (outputs published),
    #: "failed" (restarts/retries exhausted or a PermanentFault under
    #: fail_policy="isolate"; nothing published), "tainted" (skipped
    #: without dispatch because an upstream failure poisoned a relation it
    #: reads; wall == 0.0), or "cancelled" (a speculative attempt that
    #: lost the first-completion-wins race).
    outcome: str = "ok"
    #: phase spans of this dispatch (DESIGN.md §14): count-exchange,
    #: forward shuffle, probe, scatter, retry attempts, taint sweeps —
    #: recorded only when the executor holds a Tracer, with offsets
    #: relative to ``start`` and scaled alongside ``wall`` so every span
    #: nests inside the job slice.  Empty when tracing is off; the
    #: replay identities never read spans (walls alone drive them).
    spans: list[Span] = field(default_factory=list)


@dataclass(frozen=True)
class ScheduledJob:
    """Dispatch-log entry: where one plan job landed in the event timeline,
    alongside the admission-time modeled cost the LPT ordering used."""

    idx: int  # job index in plan (job_dag) order
    round_idx: int
    slot: int
    start: float
    end: float
    est_cost: float
    attempt: int = 0  # > 0: a speculative clone of the same plan job


def int_stats(stats: dict) -> tuple[dict, str]:
    """Coerce job stats to host ints, splitting off the probe-backend tag
    (the one non-numeric entry :meth:`Executor.run_job` records)."""
    s = dict(stats)
    backend = str(s.pop("backend", ""))
    return {k: int(v) for k, v in s.items()}, backend


def _fold(values) -> float:
    """Plain left-to-right float sum (the replay identities need exactly
    the additions :meth:`Report.net_time_by_events` performs)."""
    total = 0.0
    for v in values:
        total += v
    return total


@dataclass
class Report:
    records: list[JobRecord] = field(default_factory=list)

    def _round_major(self) -> list[JobRecord]:
        """Records in stable round-major order: the relation-granular DAG
        lets the async walk dispatch (and record) a later-round job before
        an earlier round fully drains, so round-grouped accounting must
        re-bucket records into plan rounds first.  The sort is stable —
        dispatch order is preserved within a round — and is the identity
        on barrier-ordered records, keeping the replay identities
        bit-exact in both regimes."""
        return sorted(self.records, key=lambda r: r.round_idx)

    @property
    def total_time(self) -> float:
        # folded left to right, round-major, so net_time_by_events(1)
        # threads the identical float additions even when dispatch
        # interleaved rounds (the builtin sum() is compensated since
        # Python 3.12 and would not)
        return _fold(r.wall for r in self._round_major())

    @property
    def net_time(self) -> float:
        by_round: dict[int, float] = {}
        for r in self.records:
            by_round[r.round_idx] = max(by_round.get(r.round_idx, 0.0), r.wall)
        return _fold(by_round[ri] for ri in sorted(by_round))

    def net_time_under_slots(self, slots: int | None = None) -> float:
        """Makespan-style net time if each round ran on ``slots`` concurrent
        cluster slots (LPT list scheduling per round, rounds stay barriers).

        ``slots=None`` models unbounded slots and reproduces
        :attr:`net_time` exactly.
        """
        from repro_torch.core.costmodel import lpt_makespan

        by_round: dict[int, list[float]] = {}
        for r in self.records:
            by_round.setdefault(r.round_idx, []).append(r.wall)
        return _fold(lpt_makespan(by_round[ri], slots) for ri in sorted(by_round))

    def event_makespan(self) -> float | None:
        """Net time of the schedule that actually ran: the latest recorded
        event-timeline end.  ``None`` when any record lacks event info
        (e.g. a hand-built report); 0.0 for an empty report (a fully warm
        service tick runs no jobs)."""
        if any(r.end < 0.0 for r in self.records):
            return None
        return max((r.end for r in self.records), default=0.0)

    def net_time_by_events(self, slots: int | None = None) -> float:
        """Critical-path net time of the recorded walls under ``slots``
        concurrent cluster slots: replays event-driven list scheduling in
        round-major record order (stable — dispatch order within a round)
        with plan rounds as barriers.  Speculative duplicate attempts are
        ordinary records (loser walls are truncated at cancellation), so
        they price without double-counting.

        Unlike :meth:`event_makespan` this re-derives the timeline from the
        walls alone, so the same records can be priced under any W:
        ``slots=None`` (W=∞) reproduces :attr:`net_time` *exactly* and
        ``slots=1`` reproduces :attr:`total_time` *exactly* — the replay
        threads the identical float additions.
        """
        recs = self._round_major()
        if not recs:
            return 0.0
        if slots is None or math.isinf(slots):
            W = len(recs)
        else:
            W = int(slots)
            if W < 1:
                raise ValueError(f"slots must be >= 1 or None (unbounded), got {slots}")
            W = min(W, len(recs))
        slot_free = [0.0] * W
        barrier = 0.0  # every job of earlier rounds has ended by here
        makespan = 0.0
        cur_round = recs[0].round_idx
        for r in recs:
            if r.round_idx != cur_round:
                cur_round = r.round_idx
                barrier = makespan
                slot_free = [barrier] * W
            i = min(range(W), key=slot_free.__getitem__)
            end = max(slot_free[i], barrier) + r.wall
            slot_free[i] = end
            if end > makespan:
                makespan = end
        return makespan

    def bytes_shuffled(self) -> int:
        return int(
            sum(r.stats.get("bytes_fwd", 0) + r.stats.get("bytes_bwd", 0) for r in self.records)
        )

    def input_rows(self) -> int:
        return int(sum(r.stats.get("input_rows", 0) for r in self.records))

    @property
    def n_jobs(self) -> int:
        return len(self.records)

    @property
    def n_speculative(self) -> int:
        """Speculative clone dispatches recorded (0 without speculation)."""
        return sum(r.speculative for r in self.records)

    @property
    def failed_jobs(self) -> list[JobRecord]:
        """Records of jobs that exhausted their retries or hit a
        :class:`PermanentFault` under ``fail_policy="isolate"``."""
        return [r for r in self.records if r.outcome == "failed"]

    @property
    def tainted_jobs(self) -> list[JobRecord]:
        """Records of jobs skipped without dispatch because an upstream
        failure poisoned a relation they read (wall == 0.0)."""
        return [r for r in self.records if r.outcome == "tainted"]

    def tainted_relations(self) -> frozenset[str]:
        """Every relation a failed or tainted job should have written —
        the blast radius the service's partial commit excludes.  Matches
        the executor's online taint closure exactly (failed writes seed
        it, tainted writes keep it transitively closed)."""
        from repro_torch.core.planner import job_writes

        rels: set[str] = set()
        for r in self.records:
            if r.outcome in ("failed", "tainted"):
                rels |= job_writes(r.job)
        return frozenset(rels)

    def summary(self) -> dict:
        return {
            "net_time": self.net_time,
            "total_time": self.total_time,
            "jobs": self.n_jobs,
            "bytes_shuffled": self.bytes_shuffled(),
            "input_rows": self.input_rows(),
            "speculative": self.n_speculative,
            "failed": len(self.failed_jobs),
            "tainted": len(self.tainted_jobs),
        }


def guard_projection(rel: Relation, q: BSGF, name: str) -> Relation:
    """π_{guard vars}(σ_conform(guard)) — the X0 input of an EVAL unit."""
    pattern = q.guard.conform_pattern()
    out_pos = [q.guard.positions_of(v)[0] for v in q.guard.vars]
    data = rel.data.reshape(-1, rel.arity)
    valid = rel.valid.reshape(-1)
    conf = conform_mask(data, valid, pattern)
    P = rel.P
    proj = data[:, out_pos].reshape(P, rel.cap, len(out_pos))
    return Relation(name, proj, conf.reshape(P, rel.cap))


def _fused_query_of(q: BSGF, job: MSJJob) -> FusedQuery:
    return _fused_query_for_sjs(q, job.sjs, ctx=repr(job))


def _fused_query_for_sjs(q: BSGF, sjs, *, ctx: str = "") -> FusedQuery:
    """Map a fused query's atoms onto indices into ``sjs`` — the job's own
    semi-joins for the inline path, the *buffer's* semi-joins for a compute
    sub-node (a taint-narrowed compute may carry fewer sjs than the buffer
    its transfer shuffled, and decode indices must match the shuffled
    tags)."""
    atom_to_sj = {}
    for a in q.atoms:
        for i, sj in enumerate(sjs):
            if sj.guard == q.guard and sj.cond_atom == a:
                atom_to_sj[a] = i
                break
        else:
            raise ValueError(f"fused query {q.name}: atom {a} not in {ctx or sjs}")
    return FusedQuery(
        name=q.name,
        cond=q.cond,
        atom_to_sj=atom_to_sj,
        guard_rel=q.guard.rel,
        guard_pattern=q.guard.conform_pattern(),
        out_pos=tuple(q.guard.positions_of(v)[0] for v in q.out_vars),
    )


#: virtual slot id of the dedicated comm track (DESIGN.md §16): transfer
#: sub-nodes dispatch here instead of occupying a compute slot, so their
#: exchanges ride under probe work.  Chosen high enough to never collide
#: with real slot indices 0..W-1 and distinct from the exporter's taint
#: pseudo-track (obs.perfetto.TAINT_TID == 999).
COMM_SLOT = 998

#: valid ExecutorConfig.probe_backend names (validated eagerly at config
#: construction so a typo fails at service/executor setup, not at job time).
PROBE_BACKENDS = ("auto", "sorted", "kernel", "dense")

#: valid ExecutorConfig.execution_mode names.
EXECUTION_MODES = ("async", "waves")

#: valid ExecutorConfig.fail_policy names.
FAIL_POLICIES = ("abort", "isolate")


@dataclass
class ExecutorConfig:
    packing: bool = True
    bloom_bits: int = 0
    compact: bool = True
    cap_slack: float = 1.0  # 1.0 = no-overflow bound; <1 risks CapacityFault
    max_retries: int = 3
    #: reducer probe backend: "kernel" = the msj_probe hash join (the
    #: CUDA kernel on the card, its plain torch version on the CPU),
    #: "sorted" = torch sort-merge, "dense" = the quadratic oracle.  The default "auto"
    #: resolves *per job* through the cost model
    #: (costmodel.choose_backend) from that job's RelStats — rows and key
    #: width — so one plan can mix backends.
    probe_backend: str = "auto"
    #: two-phase count-sized forward shuffle (DESIGN.md §6); False restores
    #: the worst-case default_forward_cap bound.
    count_sized: bool = True
    #: (signature, key) fingerprint message layout (DESIGN.md §5); False
    #: restores the seed [kind, tag, key*KW, src, row] layout end to end.
    fingerprint: bool = True
    #: "async" walks the job DAG with a ready queue (event-driven list
    #: scheduling, DESIGN.md §11); "waves" restores the barrier-wave
    #: discipline (with unbounded slots: the seed round-by-round executor).
    execution_mode: str = "async"
    #: job-DAG edge derivation (planner.job_dag): "relations" (default)
    #: depends only on the producers of relations a job actually reads —
    #: independent strata overlap (DESIGN.md §12); "strata" restores the
    #: conservative round-barrier edges for differential testing.
    dag_edges: str = "relations"
    #: speculative re-dispatch in the async walk: clone a dispatched job
    #: onto a free slot once its wall exceeds spec_factor × its modeled
    #: cost (calibrated online to wall seconds); first completion wins.
    #: Needs per-job cost estimates (a SlotScheduler with statistics) and
    #: W >= 2 to ever fire; inert in "waves" mode.
    speculate: bool = False
    #: straggler threshold as a multiple of the job's own modeled wall
    #: (costmodel.speculation_deadline; the modeled-longest job is never
    #: flagged merely for being longest).
    spec_factor: float = 2.5
    #: what a job failure (TransientFault restarts exhausted, CapacityFault
    #: retries exhausted, or a PermanentFault) does to the rest of the
    #: plan.  "abort" (default) propagates the exception — the seed
    #: whole-plan failure domain.  "isolate" narrows a blamed failure to
    #: the poisoned units (planner.narrow_job), records them as a failed
    #: JobRecord, sweeps exactly their taint closure off the ready queue
    #: (downstream units transitively *reading* a relation they should
    #: have written are recorded as zero-wall tainted records), and keeps
    #: executing everything else — failure becomes a per-unit event
    #: (DESIGN.md §13).  Async mode only.
    fail_policy: str = "abort"
    #: elastically shrink the slot budget by one (down to 1) for the
    #: remainder of the execute after each recovered ShardLoss — the lost
    #: worker's slot is gone until the resize, so pricing W-1 slots is the
    #: honest schedule (ft/elastic.py).
    shrink_on_shard_loss: bool = False
    #: block on each job's output arrays before timing it.  Default False:
    #: the only hard sync per job is the overflow *scalar* the retry check
    #: already reads (``run_job_ft``'s ``int(stats["overflow"])``), so
    #: exact fault detection is unaffected while asynchronous CUDA launches
    #: stay in flight across jobs — a blanket ``block_until_ready`` on every
    #: output would serialize exactly the shuffle/compute overlap the
    #: transfer/compute sub-nodes exist to create (DESIGN.md §16).  True
    #: restores the blanket barrier as a timing-honesty measurement mode
    #: (per-job walls then carry full device time, at the cost of the
    #: schedule being perturbed by its own observation).
    sync_per_job: bool = False
    #: split each MSJ job into a *transfer* sub-node (count exchange +
    #: forward all_to_all, dispatched on the dedicated comm track) and a
    #: *compute* sub-node (probe + scatter, on the W cluster slots), so
    #: shard k+1's exchange rides under shard k's probe (DESIGN.md §16).
    #: Outputs are bit-identical to the inline path; async mode only.
    overlap: bool = False
    #: bound on concurrently live forward-exchange buffers under
    #: ``overlap`` (double buffering by default): transfer k may only
    #: start once buffer k - xfer_buffers has been released by its
    #: compute sub-node.
    xfer_buffers: int = 2
    #: heavy-hitter skew defense (DESIGN.md §17): split each
    #: skew-annotated MSJ job (``MSJJob.skew``, planner.annotate_skew)
    #: into a *profile* sub-node (map-side top-k sketch over the guard
    #: relations, publishing a SaltTable), a salted *transfer* (hot Req
    #: rows spread across R consecutive reducers, matching Assert rows
    #: replicated to all R), and the ordinary compute.  Outputs are
    #: bit-identical to the undefended path — replicas are bitwise-equal
    #: builds and the rid-dedup scatter keeps ≤ 1 back message per (row,
    #: tag) — only the forward load distribution changes.  Unannotated
    #: jobs run unsplit; async mode only (the split rides the same
    #: sub-node machinery as ``overlap``).
    skew_defense: bool = False
    #: happens-before schedule sanitizer (repro_torch.analysis.sanitizer,
    #: DESIGN.md §15): clock every JobRecord the async walk emits —
    #: speculative attempts, failed/tainted records, narrow_job
    #: remainders included — and raise SanitizerError on any conflicting
    #: pair the DAG left unordered or any timeline-shape violation.
    #: Outputs are untouched (the sanitizer only observes); zero overhead
    #: when False.  Async mode only — only the ready-queue walk has the
    #: per-record event timeline the clocks are built from.
    sanitize: bool = False

    def __post_init__(self):
        if self.probe_backend not in PROBE_BACKENDS:
            raise ValueError(
                f"unknown probe backend {self.probe_backend!r}; "
                f"valid names: {', '.join(PROBE_BACKENDS)}"
            )
        if self.execution_mode not in EXECUTION_MODES:
            raise ValueError(
                f"unknown execution mode {self.execution_mode!r}; "
                f"valid names: {', '.join(EXECUTION_MODES)}"
            )
        if self.dag_edges not in DAG_EDGE_MODES:
            raise ValueError(
                f"unknown dag edge mode {self.dag_edges!r}; "
                f"valid names: {', '.join(DAG_EDGE_MODES)}"
            )
        if self.fail_policy not in FAIL_POLICIES:
            raise ValueError(
                f"unknown fail policy {self.fail_policy!r}; "
                f"valid names: {', '.join(FAIL_POLICIES)}"
            )
        # incoherent combinations are rejected here, at construction —
        # a flag that would be silently ignored mid-run is a config bug
        # the user should see at setup time, not a no-op
        if self.execution_mode == "waves":
            if self.speculate:
                raise ValueError(
                    "speculate=True requires execution_mode='async': the "
                    "barrier-wave walk admits whole waves and has no "
                    "mid-wave slot to clone a straggler onto"
                )
            if self.fail_policy == "isolate":
                raise ValueError(
                    "fail_policy='isolate' requires execution_mode='async': "
                    "the barrier-wave walk has no per-job taint sweep"
                )
            if self.shrink_on_shard_loss:
                raise ValueError(
                    "shrink_on_shard_loss=True requires "
                    "execution_mode='async': waves re-admit W jobs per "
                    "barrier and never consult the shrunken slot list"
                )
            if self.sanitize:
                raise ValueError(
                    "sanitize=True requires execution_mode='async': only "
                    "the ready-queue walk emits the per-record event "
                    "timelines the happens-before clocks are built from"
                )
            if self.overlap:
                raise ValueError(
                    "overlap=True requires execution_mode='async': the "
                    "barrier-wave walk joins every wave, so a transfer "
                    "sub-node could never ride under another job's probe"
                )
            if self.skew_defense:
                raise ValueError(
                    "skew_defense=True requires execution_mode='async': "
                    "the profile/transfer/compute split rides the same "
                    "sub-node dispatch as overlap, which waves lack"
                )
        if self.xfer_buffers < 1:
            raise ValueError(
                f"xfer_buffers must be >= 1 (got {self.xfer_buffers}): the "
                "overlap walk needs at least one live exchange buffer"
            )
        if self.spec_factor <= 0.0:
            raise ValueError(
                f"spec_factor must be > 0 (got {self.spec_factor}): the "
                "speculation deadline is spec_factor x the modeled wall"
            )
        if self.cap_slack <= 0.0:
            raise ValueError(
                f"cap_slack must be > 0 (got {self.cap_slack}): it scales "
                "the forward-shuffle capacity bound"
            )
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0 (got {self.max_retries})"
            )
        if self.bloom_bits < 0:
            raise ValueError(
                f"bloom_bits must be >= 0 (got {self.bloom_bits})"
            )


def resolve_probe_backend(name: str, *, on_cuda: bool = False) -> Callable:
    """Map an ExecutorConfig.probe_backend name to a probe_fn callable.

    ``"auto"`` routes through the cost model
    (:func:`repro_torch.core.costmodel.choose_backend`).  The executor
    resolves per-job statistics first (:meth:`Executor._probe_backend_for`)
    and passes a concrete name here; a bare ``"auto"`` carries no
    statistics and degenerates to the hash-join kernel when ``on_cuda`` and
    torch sort-merge elsewhere.
    """
    from repro_torch.core import msj

    if name == "auto":
        name = choose_backend(None, None, on_cuda=on_cuda)
    if name == "sorted":
        return msj.probe_sorted
    if name == "dense":
        return msj.probe_dense
    if name == "kernel":
        from repro_torch.kernels.msj_probe import ops as probe_ops

        return probe_ops.probe_bucketed
    raise ValueError(
        f"unknown probe backend {name!r}; valid names: {', '.join(PROBE_BACKENDS)}"
    )


class Executor:
    """Executes plans; the unit the fault supervisor wraps.

    ``stats`` (optional) backs the per-job ``"auto"`` backend decision;
    without it static capacity bounds of the resident relations are used
    (no device sync on the hot path).
    """

    def __init__(
        self,
        db: dict[str, Relation],
        comm: Comm,
        config: ExecutorConfig | None = None,
        *,
        stats: Stats | None = None,
        lineage: dict[str, Relation] | None = None,
        tracer=None,
        metrics=None,
    ):
        self.env: dict[str, Relation] = dict(db)
        self.comm = comm
        self.config = config or ExecutorConfig()
        self.stats = stats
        #: phase-span tracer (repro_torch.obs.Tracer) — None (default) keeps the
        #: hot path bit-identical to the untraced build; enabled tracing
        #: syncs per pipeline stage so spans carry honest device time
        #: (DESIGN.md §14).
        self.tracer = tracer
        #: metric registry (repro_torch.obs.MetricRegistry) — when present,
        #: execute() publishes msj.*/ft.* counters from each report.
        self.metrics = metrics
        #: durable lineage sources for shard-loss recovery: relation name →
        #: the authoritative Relation a lost partition is re-materialized
        #: from (the catalog's resident rows in the service).  Default
        #: is the initial ``db`` mapping — base relations are recoverable,
        #: in-flight intermediates are not (their producers would have to
        #: re-run; under fail_policy="isolate" that surfaces as a failed
        #: job instead of an abort).
        self.lineage: dict[str, Relation] = dict(db) if lineage is None else dict(lineage)
        #: findings of the last sanitized async walk (config.sanitize);
        #: populated just before SanitizerError is raised, [] on a clean run
        self.last_sanitize: list = []
        #: dispatch log of the last :meth:`execute` call.
        self.schedule: list[ScheduledJob] = []
        #: fault-tolerance counters of the last :meth:`execute` call
        #: (overflow retries, injected-failure reroutes, speculative
        #: clone dispatches, shard-loss recoveries) — what the
        #: supervisor's FTStats reads.
        self.ft_counters: dict[str, int] = dict(
            overflow_retries=0, fault_retries=0, speculative=0, shard_recoveries=0
        )

    # -- per-job backend decision ------------------------------------------
    def _probe_backend_for(self, job: MSJJob) -> str:
        """Resolve ``probe_backend="auto"`` for ONE job: per-shard build /
        probe row estimates and key width feed the cost model, so jobs of
        one plan can land on different backends."""
        name = self.config.probe_backend
        if name != "auto":
            return name
        spec = make_spec(list(job.sjs))
        P = max(getattr(self.comm, "P", 1), 1)

        def rows(rel_name: str) -> float | None:
            if self.stats is not None and rel_name in self.stats.rels:
                return self.stats.rel(rel_name).rows
            rel = self.env.get(rel_name)
            # static capacity upper bound — no device sync on the hot path
            return float(rel.P * rel.cap) if rel is not None else None

        build = [rows(s.rel) for s in spec.sigs]
        probe = [rows(i.guard_rel) for i in spec.sj_info]
        b = sum(build) / P if build and all(v is not None for v in build) else None
        p = sum(probe) / P if probe and all(v is not None for v in probe) else None
        # the kernel is priced from where the job's relations live, not
        # from whether the process has a card: CPU-resident data on a
        # machine with a GPU runs the plain version and is not a kernel job
        on_cuda = any(
            isinstance(self.env.get(r), Relation) and self.env[r].data.is_cuda
            for r in {s.rel for s in spec.sigs} | {i.guard_rel for i in spec.sj_info}
        )
        return choose_backend(b, p, spec.key_width, on_cuda=on_cuda)

    # -- single jobs -------------------------------------------------------
    def run_job(
        self,
        job: Job,
        *,
        cap_override: int | None = None,
        cap_slack: float | None = None,
    ) -> tuple[dict, dict]:
        if isinstance(job, MSJJob):
            fused = tuple(_fused_query_of(q, job) for q in job.fused)
            backend = self._probe_backend_for(job)
            outs, stats = run_msj(
                self.env,
                list(job.sjs),
                self.comm,
                packing=self.config.packing,
                fused=fused,
                bloom_bits=self.config.bloom_bits,
                forward_cap=cap_override,
                probe_fn=resolve_probe_backend(backend),
                fingerprint=self.config.fingerprint,
                count_sized=self.config.count_sized,
                cap_slack=self.config.cap_slack if cap_slack is None else cap_slack,
                tracer=self.tracer,
            )
            stats["input_rows"] = sum(
                int(self.env[r].count()) for r in _msj_input_rels(job, self.env)
            )
            stats["backend"] = backend
            return outs, stats
        if isinstance(job, SkewProfileJob):
            # profile sub-node (DESIGN.md §17): the map-side top-k sketch
            # over the base job's guard relations, merged on host into the
            # SaltTable the paired salted transfer routes by.  No
            # communication, no Relation output — the table is routing
            # metadata, published raw under the %salt name.
            ann = job.base.skew
            if ann is None:
                raise RuntimeError(
                    f"{job}: base job carries no skew annotation (was the "
                    "plan re-annotated after the DAG was built?)"
                )
            table = collect_salt_table(
                self.env,
                list(job.base.sjs),
                R=ann.R,
                threshold=ann.threshold,
                fingerprint=self.config.fingerprint,
            )
            stats = {
                "overflow": 0,
                "hot_keys": sum(
                    1 for _, fps in table.counts
                    for _, n in fps if n >= table.threshold
                ),
                "input_rows": sum(
                    int(self.env[r].count()) for r in job_reads(job)
                ),
            }
            return {job.salt: table}, stats
        if isinstance(job, TransferJob):
            # transfer sub-node (DESIGN.md §16): count exchange + forward
            # all_to_all of the base MSJ job; publishes the in-flight
            # exchange as an XferBuffer under the %xfer name instead of
            # probing it.  The capacity ladder applies here — overflow is a
            # property of the forward shuffle, so the retry state's learned
            # cap/slack land on this sub-node (satellite: a prefetched
            # transfer's CapacityFault blames *its own* RetryState).
            skew = None
            if job.salt:
                table = self.env.get(job.salt)
                if not isinstance(table, SaltTable):
                    raise RuntimeError(
                        f"{job}: environment entry {job.salt!r} is not a "
                        "salt table (was the profile sub-node skipped?)"
                    )
                skew = skew_route_of(
                    table,
                    make_spec(
                        list(job.base.sjs), fingerprint=self.config.fingerprint
                    ),
                )
            buf, stats = run_msj_transfer(
                job.buffer,
                self.env,
                list(job.base.sjs),
                self.comm,
                packing=self.config.packing,
                bloom_bits=self.config.bloom_bits,
                forward_cap=cap_override,
                fingerprint=self.config.fingerprint,
                count_sized=self.config.count_sized,
                cap_slack=self.config.cap_slack if cap_slack is None else cap_slack,
                tracer=self.tracer,
                skew=skew,
            )
            stats["input_rows"] = sum(
                int(self.env[r].count()) for r in _msj_input_rels(job.base, self.env)
            )
            return ({job.buffer: buf} if job.buffer else {}), stats
        if isinstance(job, ComputeJob):
            # compute sub-node: probe + scatter against the buffered
            # exchange.  Spec/layout rebuild from the BUFFER's sjs (never
            # the possibly-narrowed compute base) so decode matches the
            # shuffled tags; outputs are filtered to this node's writes so
            # a narrowed compute can't resurrect dropped units' outputs.
            buf = self.env[job.buffer]
            if not isinstance(buf, XferBuffer):
                raise RuntimeError(
                    f"{job}: environment entry {job.buffer!r} is not a "
                    "transfer buffer (was the transfer sub-node skipped?)"
                )
            fused = tuple(
                _fused_query_for_sjs(q, buf.sjs, ctx=f"buffer {buf.name!r}")
                for q in job.base.fused
            )
            backend = self._probe_backend_for(job.base)
            outs, stats = run_msj_compute(
                self.env,
                buf,
                self.comm,
                fused=fused,
                probe_fn=resolve_probe_backend(backend),
                tracer=self.tracer,
            )
            writes = job_writes(job)
            outs = {k: v for k, v in outs.items() if k in writes}
            stats["backend"] = backend
            return outs, stats
        # EVAL job
        env = dict(self.env)
        units = []
        input_rows = 0
        for q, xin in zip(job.queries, job.atom_inputs):
            x0 = f"{q.name}#G"
            env[x0] = guard_projection(self.env[q.guard.rel], q, x0)
            out_pos = tuple(q.guard.vars.index(v) for v in q.out_vars)
            units.append(
                EvalUnit(
                    q.name, x0, tuple(xin), tuple(q.atoms), q.cond, out_pos,
                    salt=query_salt(q),
                )
            )
            input_rows += int(env[x0].count()) + sum(int(self.env[x].count()) for x in xin)
        outs, stats = run_eval(env, units, self.comm, tracer=self.tracer)
        stats["input_rows"] = input_rows
        return outs, stats

    def run_job_ft(
        self,
        job: Job,
        on_job: Callable | None = None,
        *,
        state: RetryState | None = None,
        max_restarts: int = 0,
    ) -> tuple[dict, dict, int]:
        """Run with retries: exact shuffle-overflow recovery (the capacity
        ladder of :class:`RetryState`) and rerouting of injected/external
        :class:`TransientFault` failures (up to ``max_restarts``).

        ``state`` carries the retry state across dispatches of the same
        plan job; the speculative clone path passes the original's state so
        learned capacity sizing is inherited rather than re-derived (the
        ExecutorConfig itself is never mutated — deliberate undersizing
        stays in force for later jobs and plans).
        """
        state = RetryState() if state is None else state
        tr = self.tracer
        traced = tr is not None and getattr(tr, "enabled", False)
        attempts = 0
        while True:
            attempts += 1
            sp = None
            try:
                if traced:
                    # one span per dispatch attempt: retries and capacity
                    # re-runs show up as sibling ft.attempt slices with the
                    # pipeline phase spans nested inside (DESIGN.md §14)
                    with tr.span("ft.attempt", cat="attempt",
                                 attempt=attempts) as sp:
                        if on_job is not None:
                            on_job(job, attempts)
                        outs, stats = self.run_job(
                            job, cap_override=state.cap, cap_slack=state.slack
                        )
                else:
                    if on_job is not None:
                        on_job(job, attempts)
                    outs, stats = self.run_job(
                        job, cap_override=state.cap, cap_slack=state.slack
                    )
            except TransientFault as fault:
                if sp is not None:
                    sp.args["outcome"] = type(fault).__name__
                state.fault_retries += 1
                self.ft_counters["fault_retries"] += 1
                if isinstance(fault, ShardLoss):
                    # recover *before* the budget check: the lost partition
                    # must be re-materialized even if this job gives up, or
                    # every later job reading the relation computes on a
                    # silently-damaged copy
                    self._recover_shard(fault)
                if state.fault_retries > max_restarts:
                    raise
                continue
            ovf = int(stats.get("overflow", 0))
            if ovf == 0:
                if sp is not None:
                    sp.args["outcome"] = "ok"
                return outs, stats, attempts
            if sp is not None:
                sp.args["outcome"] = "overflow"
            if state.overflow_retries >= self.config.max_retries:
                raise CapacityFault(job, ovf)
            state.on_overflow(self.config, stats)
            self.ft_counters["overflow_retries"] += 1

    def _recover_shard(self, fault: ShardLoss) -> None:
        """Re-materialize a lost base-relation partition from lineage
        (DESIGN.md §13): the durable source rows are resident in the
        catalog, so the damaged in-memory copy is spliced back
        bit-identically (``ft/elastic.recover_shard``, which builds new
        tensors and never writes the source; a source resident at a
        different P is re-partitioned first).  Without a lineage source the
        loss is unrecoverable and escalates to a :class:`PermanentFault`."""
        src = self.lineage.get(fault.rel)
        if src is None:
            raise PermanentFault(
                f"shard {fault.shard} of {fault.rel!r} lost with no lineage "
                "source (in-flight intermediate); cannot re-materialize",
                rels={fault.rel},
            ) from fault
        from repro_torch.ft.elastic import recover_shard

        self.env[fault.rel] = recover_shard(
            self.env[fault.rel], src, fault.shard
        )
        self.ft_counters["shard_recoveries"] += 1

    def _taint_sweep(
        self,
        pending: dict,
        seed_rels: Iterable[str],
        end: float,
        report: "Report",
        end_at: dict[int, float],
        san=None,
    ) -> None:
        """Propagate a failure's taint through the not-yet-dispatched jobs
        (DESIGN.md §13): any pending job reading a tainted relation is
        *narrowed* (:func:`repro_torch.core.planner.narrow_job`) — its poisoned
        units are recorded as a zero-wall tainted JobRecord (start == end
        at the failure, slot -1, so every replay identity holds trivially)
        and their writes join the closure; the untouched units stay
        queued.  Jobs related only by anti/output (WAR/WAW) dependences
        never read a tainted relation and keep running."""
        rels = set(seed_rels)
        changed = True
        while changed:
            changed = False
            for ti, tn in list(pending.items()):
                if not (tn.reads & rels):
                    continue
                kept, dropped = narrow_job(tn.job, rels)
                if dropped is None:
                    continue  # reads overlap but no unit touches the taint
                changed = True
                rels |= job_writes(dropped)
                taint_rec = JobRecord(dropped, tn.round_idx, 0.0, {}, 0,
                                      "none", end, end, -1, outcome="tainted")
                report.records.append(taint_rec)
                if san is not None:
                    san.observe(taint_rec, ti, tn.deps)
                if kept is None:
                    end_at[ti] = end
                    del pending[ti]
                    if san is not None:
                        san.complete(ti, end)
                else:
                    pending[ti] = replace(
                        tn, job=kept, reads=job_reads(kept),
                        writes=job_writes(kept),
                    )

    # -- job-granular entry (what the ready-queue walk drives) -------------
    def _attempt(
        self,
        job: Job,
        on_job: Callable | None,
        state: RetryState,
        max_restarts: int,
        wall_scale: Callable | None,
        attempt: int,
    ) -> tuple[dict, dict, int, float, list[Span]]:
        """One timed dispatch attempt: run to completion (with retries) and
        measure its wall, without publishing outputs (first-completion-wins
        decides what gets published).  ``wall_scale(job, attempt)`` scales
        the measured wall in the *virtual* timeline — the fault-injection
        hook benchmarks/tests use to create deterministic stragglers.

        When tracing is on, the attempt's phase spans are captured,
        rebased to offsets from the dispatch, and scaled by the same
        factor as the wall, so they nest inside the virtual job slice."""
        tr = self.tracer
        traced = tr is not None and getattr(tr, "enabled", False)
        spans: list[Span] = []
        t0 = time.perf_counter()
        if traced:
            with tr.capture() as spans:
                outs, stats, attempts = self.run_job_ft(
                    job, on_job, state=state, max_restarts=max_restarts
                )
                if self.config.sync_per_job:
                    _block(outs)
        else:
            outs, stats, attempts = self.run_job_ft(
                job, on_job, state=state, max_restarts=max_restarts
            )
            if self.config.sync_per_job:
                _block(outs)
        measured = time.perf_counter() - t0
        wall = measured
        if wall_scale is not None:
            wall *= float(wall_scale(job, attempt))
        if spans:
            _rebase_spans(spans, t0, wall / measured if measured > 0.0 else 1.0)
        return outs, stats, attempts, wall, spans

    def _publish(self, outs: dict) -> None:
        for name, rel in outs.items():
            # XferBuffers and SaltTables are in-flight sub-node state, not
            # relations: never compacted, never committed, dropped from the
            # env once their consumer sub-node completes
            if self.config.compact and isinstance(rel, Relation):
                rel = rel.compacted()
            self.env[name] = rel

    def execute_job(
        self,
        job: Job,
        round_idx: int,
        report: Report,
        *,
        on_job: Callable | None = None,
        max_restarts: int = 0,
        wall_scale: Callable | None = None,
    ) -> JobRecord:
        """Run one job to completion: time it, publish its outputs into the
        environment, and append a :class:`JobRecord` to ``report``."""
        outs, stats, attempts, wall, spans = self._attempt(
            job, on_job, RetryState(), max_restarts, wall_scale, 0
        )
        self._publish(outs)
        ints, backend = int_stats(stats)
        rec = JobRecord(job, round_idx, wall, ints, attempts, backend, spans=spans)
        report.records.append(rec)
        return rec

    # -- whole plans -------------------------------------------------------
    def execute(
        self,
        plan: Plan,
        *,
        slots: int | None = None,
        est: dict[int, float] | None = None,
        on_job: Callable | None = None,
        max_restarts: int = 0,
        wall_scale: Callable | None = None,
        nodes: tuple | None = None,
    ) -> tuple[dict, Report]:
        """Run a whole plan under ``config.execution_mode``.

        ``slots`` bounds the concurrent cluster slots W (None = unbounded);
        ``est`` maps job-DAG indices to modeled costs for LPT ordering and
        speculation deadlines (the slot scheduler's admission-time
        estimate; absent = plan order, speculation inert); ``max_restarts``
        bounds :class:`TransientFault` reroutes per job (the supervisor's
        policy); ``wall_scale(job, attempt)`` scales measured walls in the
        virtual timeline (deterministic straggler injection).

        * ``"async"`` (default) — dependency-driven ready-queue walk of
          :func:`repro_torch.core.planner.job_dag` under ``config.dag_edges``:
          a job launches as soon as its predecessors completed and a slot
          frees (event-driven list scheduling); a straggler stalls only
          its own slot, and with ``config.speculate`` is additionally
          cloned onto a free slot past its cost-model deadline (first
          completion wins).
        * ``"waves"`` — the legacy barrier discipline: at most W ready jobs
          per wave, the whole wave joins before the next is admitted.  With
          ``slots=None`` and ``dag_edges="strata"`` waves coincide with
          plan rounds (the seed barrier-round executor), kept for
          differential testing.  No speculation.

        Jobs still *execute* serially on this container (SimComm serializes
        shard work onto the host — DESIGN.md §8); the recorded
        ``JobRecord.start/end/slot`` timeline is the virtual W-slot
        schedule assembled from the measured walls, which
        ``Report.event_makespan()`` / ``net_time_by_events`` price.

        ``nodes`` overrides the job DAG the walk runs (default:
        ``job_dag(plan, config.dag_edges)``) — the seam the mutation
        differential tests use to execute a deliberately corrupted DAG
        and show that what the verifier flags really does race
        (DESIGN.md §15).
        """
        if slots is not None and slots < 1:
            raise ValueError(f"slots must be >= 1 or None (unbounded), got {slots}")
        if nodes is None:
            nodes = job_dag(
                plan,
                edges=self.config.dag_edges,
                overlap=self.config.overlap,
                skew=self.config.skew_defense,
            )
        else:
            nodes = tuple(nodes)
        if est is None:
            est = {n.idx: 0.0 for n in nodes}
        self.schedule = []
        self.ft_counters = dict(
            overflow_retries=0, fault_retries=0, speculative=0, shard_recoveries=0
        )
        if self.config.execution_mode == "waves":
            if self.config.fail_policy == "isolate":
                raise ValueError(
                    "fail_policy='isolate' requires execution_mode='async': "
                    "the barrier-wave walk has no per-job taint sweep"
                )
            env, report = self._execute_waves(
                nodes, slots, est, on_job, max_restarts, wall_scale
            )
        else:
            env, report = self._execute_async(
                nodes, slots, est, on_job, max_restarts, wall_scale
            )
        if self.metrics is not None:
            self._publish_metrics(report)
        return env, report

    def _publish_metrics(self, report: Report) -> None:
        """Fold one execute's report into the metric registry (DESIGN.md
        §14): engine work under ``msj.*``, fault tolerance under ``ft.*``."""
        m = self.metrics
        m.counter("msj.jobs").add(report.n_jobs)
        m.counter("msj.shuffle.bytes").add(report.bytes_shuffled())
        m.counter("ft.speculative.dispatches").add(self.ft_counters["speculative"])
        m.counter("ft.failed.jobs").add(len(report.failed_jobs))
        m.counter("ft.taint.jobs").add(len(report.tainted_jobs))
        # retry-ladder counters (overflow/fault/shard recovery) are the
        # supervisor's: FTStats publishes them under ft.* from the same
        # ft_counters, so publishing here too would double-count when the
        # registry is shared
        wall = m.histogram("msj.job.wall")
        for r in report.records:
            if r.outcome == "ok":
                wall.observe(r.wall)

    def _execute_async(
        self, nodes, slots, est, on_job, max_restarts=0, wall_scale=None
    ) -> tuple[dict, Report]:
        """Event-driven ready-queue walk (DESIGN.md §11/§12).

        Dispatch rule: take the slot that frees earliest; among jobs whose
        predecessors have all completed by then, start the longest modeled
        one (LPT).  If every ready job is still blocked on in-flight
        predecessors, the slot idles until the earliest one unblocks.

        Speculation (``config.speculate``): once a dispatched job's wall
        exceeds its deadline (``spec_factor ×`` its modeled cost, scaled
        online to wall seconds by completed attempts), a clone is launched
        on the earliest-freeing *other* slot — but only when the clone
        could still win.  First completion wins: the winner's outputs are
        published and release dependants; the loser is cancelled at the
        winner's end, its record priced for exactly the slot time consumed
        (``end == start + wall`` holds for every record, so the replay
        identities are unaffected by duplicate attempts).
        """
        report = Report()
        san = None
        self.last_sanitize = []
        if self.config.sanitize:
            # lazy import: the analysis layer sits above core and is only
            # paid for when the sanitizer is actually on
            from repro_torch.analysis.sanitizer import ScheduleSanitizer

            san = ScheduleSanitizer(nodes)
        n_slots = len(nodes) if slots is None else max(1, min(slots, len(nodes)))
        slot_free = [0.0] * max(n_slots, 1)
        end_at: dict[int, float] = {}
        pending = {n.idx: n for n in nodes}
        # online model-units -> wall-seconds calibration: median of the
        # per-attempt wall/cost ratios (robust to one inflated wall, e.g.
        # residual compilation on the first dispatch)
        ratios: list[float] = []

        def ready_at(node) -> float:
            return max((end_at[d] for d in node.deps), default=0.0)

        def maybe_shrink(recov0: int) -> None:
            # elastic shrink after a recovered shard loss (DESIGN.md §13):
            # drop the latest-freeing slot so the remainder of the execute
            # runs at W-1 — the cluster just demonstrated a slot is flaky
            nonlocal n_slots
            if (
                self.config.shrink_on_shard_loss
                and self.ft_counters["shard_recoveries"] > recov0
                and len(slot_free) > 1
            ):
                slot_free.pop(max(range(len(slot_free)), key=slot_free.__getitem__))
                n_slots = len(slot_free)

        isolate = self.config.fail_policy == "isolate"

        # -- shuffle/compute overlap (DESIGN.md §16) -----------------------
        # Transfer sub-nodes dispatch on a dedicated single-slot comm track
        # (virtual slot COMM_SLOT), so a forward exchange rides under probe
        # work on the W compute slots; the buffer pool bounds how many
        # shuffled-but-unprobed exchanges are alive at once (double
        # buffering by default): transfer k may only start once buffer
        # k - xfer_buffers was released by its compute sub-node.
        overlapped = any(isinstance(n.job, TransferJob) for n in nodes)
        comm_free = 0.0
        max_bufs = max(1, self.config.xfer_buffers)
        compute_of = {
            n.job.buffer: n.idx for n in nodes if isinstance(n.job, ComputeJob)
        }
        buf_computes: list[int] = []  # consumer idx per created buffer, in order

        def buffer_gate() -> float | None:
            """Earliest virtual time the next transfer may start under the
            buffer bound, or None while the pool is exhausted (a compute
            holding one of the last ``max_bufs`` buffers hasn't ended)."""
            need = len(buf_computes) + 1 - max_bufs
            if need <= 0:
                return 0.0
            freed = sorted(end_at[ci] for ci in buf_computes if ci in end_at)
            if len(freed) < need:
                return None
            return freed[need - 1]

        while pending:
            ready = [n for n in pending.values() if all(d in end_at for d in n.deps)]
            if not ready:
                raise RuntimeError("job DAG has a cycle (malformed plan)")
            if overlapped:
                xfers = [n for n in ready if isinstance(n.job, TransferJob)]
                work = [n for n in ready if not isinstance(n.job, TransferJob)]
            else:
                xfers, work = [], ready
            pick = None  # (start, node, slot, on_comm)
            if work:
                s = min(range(len(slot_free)), key=slot_free.__getitem__)
                startable = [n for n in work if ready_at(n) <= slot_free[s]]
                if startable:
                    cand = min(startable, key=lambda n: (-est[n.idx], n.idx))
                    pick = (slot_free[s], cand, s, False)
                else:
                    cand = min(work, key=lambda n: (ready_at(n), -est[n.idx], n.idx))
                    pick = (ready_at(cand), cand, s, False)
            if xfers:
                gate = buffer_gate()
                if gate is not None:
                    cand = min(
                        xfers,
                        key=lambda n: (
                            max(ready_at(n), comm_free, gate), -est[n.idx], n.idx
                        ),
                    )
                    t_x = max(ready_at(cand), comm_free, gate)
                    # ties go to the comm track: starting the exchange
                    # early is what hides it under compute
                    if pick is None or t_x <= pick[0]:
                        pick = (t_x, cand, COMM_SLOT, True)
            if pick is None:
                # unreachable on a well-formed overlap DAG: a gated pool
                # implies max_bufs live buffers whose paired computes are
                # ready (their only extra dep is the completed transfer)
                raise RuntimeError(
                    "overlap dispatch deadlocked on the exchange buffer pool"
                )
            start, node, s, on_comm = pick
            state = RetryState()
            recov0 = self.ft_counters["shard_recoveries"]
            t0 = time.perf_counter()
            try:
                outs, stats, attempts, wall, spans = self._attempt(
                    node.job, on_job, state, max_restarts, wall_scale, 0
                )
            except (TransientFault, CapacityFault, PermanentFault) as exc:
                if not isolate:
                    raise
                # blast-radius isolation (DESIGN.md §13): record the failure,
                # sweep its taint closure off the ready queue, and keep
                # every other job running.  A blamed PermanentFault narrows
                # the failed job first — only the units touching a blamed
                # relation fail, the innocent remainder of a fused
                # multi-tenant job is re-dispatched.  The failed record is
                # priced for the slot time it actually consumed; tainted
                # jobs are zero-wall markers (start == end at the failure),
                # so the event-replay identities hold unchanged.
                wall = time.perf_counter() - t0
                end = start + wall
                attempts = max(1, state.fault_retries + state.overflow_retries)
                blamed = frozenset(getattr(exc, "rels", ()) or ())
                kept = dropped = None
                if blamed:
                    kept, dropped = narrow_job(node.job, blamed)
                if dropped is None:  # no blame (or blame touches nothing):
                    kept, dropped = None, node.job  # the whole job failed
                rec = JobRecord(dropped, node.round_idx, wall, {}, attempts,
                                "none", start, end, s, outcome="failed")
                report.records.append(rec)
                if san is not None:
                    san.observe(rec, node.idx, node.deps)
                self.schedule.append(
                    ScheduledJob(node.idx, node.round_idx, s, start, end,
                                 est[node.idx], 0)
                )
                if on_comm:
                    comm_free = end
                else:
                    slot_free[s] = end
                if kept is None:
                    end_at[node.idx] = end
                    del pending[node.idx]
                    if san is not None:
                        san.complete(node.idx, end)
                    if isinstance(node.job, ComputeJob):
                        # the buffer is dead either way: release its pool
                        # slot (end_at above) and drop the exchange state
                        self.env.pop(node.job.buffer, None)
                    elif isinstance(node.job, TransferJob) and node.job.salt:
                        # a fully-failed salted transfer was the salt's
                        # only consumer; a narrowed remainder (kept above)
                        # still needs it and keeps it live
                        self.env.pop(node.job.salt, None)
                else:
                    pending[node.idx] = replace(
                        node, job=kept, reads=job_reads(kept),
                        writes=job_writes(kept),
                    )
                # blamed inputs seed the sweep alongside the failed writes:
                # a downstream unit guarding directly on a poisoned base
                # relation must drop even though that relation has a clean
                # producer (none — it's a base input)
                tr = self.tracer
                if tr is not None and getattr(tr, "enabled", False):
                    t_sweep = time.perf_counter()
                    n0 = len(report.records)
                    self._taint_sweep(
                        pending, job_writes(dropped) | blamed, end, report,
                        end_at, san,
                    )
                    rec.spans.append(Span(
                        "ft.taint.sweep", "phase", wall,
                        time.perf_counter() - t_sweep,
                        {"tainted_jobs": len(report.records) - n0},
                    ))
                else:
                    self._taint_sweep(
                        pending, job_writes(dropped) | blamed, end, report,
                        end_at, san,
                    )
                maybe_shrink(recov0)
                continue
            end = start + wall
            deadline = speculation_deadline(
                est[node.idx],
                scale=sorted(ratios)[len(ratios) // 2] if ratios else None,
                factor=self.config.spec_factor,
                slots=n_slots,
            )
            clone = None
            # the comm track is a single slot — there is no second comm
            # slot to clone a straggling transfer onto
            if self.config.speculate and wall > deadline and not on_comm:
                others = [i for i in range(len(slot_free)) if i != s]
                if others:
                    s2 = min(others, key=slot_free.__getitem__)
                    t2 = max(start + deadline, slot_free[s2])
                    if t2 < end:  # the clone could still win
                        try:
                            outs2, stats2, attempts2, wall2, spans2 = self._attempt(
                                node.job, on_job, state, max_restarts, wall_scale, 1
                            )
                            clone = (outs2, stats2, attempts2, wall2, spans2, s2, t2)
                            self.ft_counters["speculative"] += 1
                        except (TransientFault, CapacityFault, PermanentFault):
                            # speculation is an optimization: a clone that
                            # dies (injected faults / exhausted shared
                            # retry budget) must not abort a plan whose
                            # original attempt already completed
                            clone = None
            if clone is None:
                self._publish(outs)
                ints, backend = int_stats(stats)
                rec = JobRecord(node.job, node.round_idx, wall, ints, attempts,
                                backend, start, end, s, spans=spans)
                recs = [rec]
                win_end = end
            else:
                outs2, stats2, attempts2, wall2, spans2, s2, t2 = clone
                end2 = t2 + wall2
                win_end = min(end, end2)  # ties go to the original
                clone_wins = end2 < end
                self._publish(outs2 if clone_wins else outs)
                ints, backend = int_stats(stats)
                ints2, backend2 = int_stats(stats2)
                # the loser's wall is truncated at the winner's end; its
                # spans shrink by the same factor so they stay inside the
                # cancelled slice (the winner's factor is exactly 1.0)
                if spans and wall > 0.0:
                    _scale_spans(spans, (win_end - start) / wall)
                if spans2 and wall2 > 0.0:
                    _scale_spans(spans2, (win_end - t2) / wall2)
                rec = JobRecord(
                    node.job, node.round_idx, win_end - start, ints, attempts,
                    backend, start, win_end, s,
                    attempt=0, cancelled=clone_wins,
                    outcome="cancelled" if clone_wins else "ok", spans=spans,
                )
                rec2 = JobRecord(
                    node.job, node.round_idx, win_end - t2, ints2, attempts2,
                    backend2, t2, win_end, s2,
                    attempt=1, speculative=True, cancelled=not clone_wins,
                    outcome="ok" if clone_wins else "cancelled", spans=spans2,
                )
                slot_free[s2] = rec2.end
                recs = [rec, rec2]
            # calibrate on the winning attempt (its wall is the full
            # measured one; the loser's is truncated at cancellation)
            if est[node.idx] > 0.0:
                win_wall = next(r.wall for r in recs if not r.cancelled)
                ratios.append(win_wall / est[node.idx])
            for r in recs:
                report.records.append(r)
                if san is not None:
                    san.observe(r, node.idx, node.deps)
                self.schedule.append(
                    ScheduledJob(node.idx, node.round_idx, r.slot, r.start,
                                 r.end, est[node.idx], r.attempt)
                )
            if on_comm:
                comm_free = rec.end
            else:
                slot_free[s] = rec.end
            end_at[node.idx] = win_end
            del pending[node.idx]
            if san is not None:
                san.complete(node.idx, win_end)
            if overlapped:
                if isinstance(node.job, TransferJob):
                    if node.job.buffer:
                        buf_computes.append(
                            compute_of.get(node.job.buffer, node.idx)
                        )
                    # the salt table has exactly one consumer — this
                    # transfer — so it is dead once the exchange completed
                    if node.job.salt:
                        self.env.pop(node.job.salt, None)
                elif isinstance(node.job, ComputeJob):
                    self.env.pop(node.job.buffer, None)
            maybe_shrink(recov0)
        if san is not None:
            from repro_torch.analysis.sanitizer import SanitizerError

            self.last_sanitize = san.finish()
            if self.last_sanitize:
                raise SanitizerError(self.last_sanitize)
        return self.env, report

    def _execute_waves(
        self, nodes, slots, est, on_job, max_restarts=0, wall_scale=None
    ) -> tuple[dict, Report]:
        """Barrier-wave discipline: admit ≤ W ready jobs (LPT), join them
        all, repeat.  Every admitted job starts at the wave barrier on its
        own slot, so the event timeline prices Σ_waves max_wall."""
        report = Report()
        done: set[int] = set()
        pending = list(nodes)
        wave_start = 0.0
        while pending:
            ready = [n for n in pending if all(d in done for d in n.deps)]
            if not ready:
                raise RuntimeError("job DAG has a cycle (malformed plan)")
            # LPT: longest modeled job first; plan order breaks ties so the
            # schedule is deterministic.
            ready.sort(key=lambda n: (-est[n.idx], n.idx))
            admitted = ready if slots is None else ready[:slots]
            wave_end = wave_start
            for si, n in enumerate(admitted):
                rec = self.execute_job(
                    n.job, n.round_idx, report, on_job=on_job,
                    max_restarts=max_restarts, wall_scale=wall_scale,
                )
                rec.start, rec.end, rec.slot = wave_start, wave_start + rec.wall, si
                wave_end = max(wave_end, rec.end)
                self.schedule.append(
                    ScheduledJob(n.idx, n.round_idx, si, rec.start, rec.end, est[n.idx])
                )
                done.add(n.idx)
            pending = [n for n in pending if n.idx not in done]
            wave_start = wave_end
        return self.env, report


def _block(outs: dict) -> None:
    """Wait for the device work behind a job's output relations."""
    if any(isinstance(v, Relation) and v.data.is_cuda for v in outs.values()):
        torch.cuda.synchronize()


def _msj_input_rels(job: MSJJob, env) -> set[str]:
    rels = set()
    for sj in job.sjs:
        rels.add(sj.guard.rel)
        rels.add(sj.cond_atom.rel)
    return rels


def execute_plan(
    db: dict[str, Relation],
    plan: Plan,
    comm: Comm,
    config: ExecutorConfig | None = None,
) -> tuple[dict[str, Relation], Report]:
    """One-shot convenience wrapper."""
    ex = Executor(db, comm, config)
    return ex.execute(plan)
