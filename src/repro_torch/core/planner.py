"""Query planners: GREEDY-BSGF, GREEDY-SGF, brute-force OPT, and the
SEQ / PAR / GREEDY / 1-ROUND strategies of Section 5.

Plan IR
-------
A :class:`Plan` is a sequence of :class:`Round`s; jobs within a round may
run in parallel on the cluster, rounds are barriers.  :func:`job_dag`
exposes the same structure as a job-level dependency DAG, which the
ready-queue executor (``Executor.execute``, DESIGN.md §11/§12) walks
online — rounds then constrain *precedence*, not wave membership.  The
default ``edges="relations"`` mode derives edges from each job's
read/write sets (:func:`job_reads` / :func:`job_writes`): a job depends
only on the jobs that *produce* a relation it actually reads, so
independent strata overlap; ``edges="strata"`` keeps the conservative
round-barrier reading for differential testing.  Two job kinds mirror
the paper's operators:

* :class:`MSJJob` — one multi-semi-join job.  ``sjs`` are the equations to
  evaluate; ``fused`` are BSGF queries whose Boolean formula is applied
  *inside* the job on the route-back bitmap (the 1-ROUND path, generalized
  beyond the paper's shared-key condition — DESIGN.md §7).
* :class:`EvalJob` — one EVAL job computing ``Z := X0 ∧ φ`` for one or
  more BSGF queries of a stratum.

Correctness note (negation vs. projection): the paper's §4.4 projects each
X_i to the query's output variables w̄ *before* EVAL.  Under negation that
is unsound when w̄ drops a guard variable the condition depends on (two
guard rows collapsing onto one output tuple can disagree on C).  Our plans
therefore project X_i to the **full guard-variable tuple** and EVAL
projects to w̄ at output; the fused 1-ROUND path is row-aligned and
unaffected.  See DESIGN.md §2 and tests/test_planner.py.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable, Sequence

from repro_torch.core.algebra import (
    Atom,
    BSGF,
    Cond,
    Not,
    Or,
    SGF,
    SemiJoin,
    cond_atoms,
)
from repro_torch.core.costmodel import (
    CostConstants,
    HADOOP,
    RelStats,
    SKEW_FACTOR,
    SkewDefense,
    Stats,
    BYTES_PER_CELL,
    choose_skew,
    eval_job_cost,
    lpt_makespan,
    msj_compute_cost,
    msj_job_cost,
    msj_profile_cost,
    msj_transfer_cost,
)

MB = 1e6


# --------------------------------------------------------------------------
# Plan IR
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MSJJob:
    sjs: tuple[SemiJoin, ...]
    fused: tuple[BSGF, ...] = ()
    #: skew-defense annotation (DESIGN.md §17), attached by
    #: :func:`annotate_skew`.  Inert unless the executor runs with
    #: ``skew_defense=True`` — an annotated plan executes identically to
    #: an unannotated one otherwise (the differential seam the property
    #: suite exploits).  Part of the frozen identity, so plan-cache keys
    #: pin the skew decision.
    skew: SkewDefense | None = None

    def __repr__(self):
        f = f" fused={[q.name for q in self.fused]}" if self.fused else ""
        s = f" skew=R{self.skew.R}" if self.skew is not None else ""
        return f"MSJ({[s_.out for s_ in self.sjs]}{f}{s})"


@dataclass(frozen=True)
class EvalJob:
    queries: tuple[BSGF, ...]
    # per query: name of the X relation backing each conditional atom
    atom_inputs: tuple[tuple[str, ...], ...]

    def __repr__(self):
        return f"EVAL({[q.name for q in self.queries]})"


#: prefix of the synthetic buffer relations a :class:`TransferJob`
#: publishes.  ``%`` cannot appear in a schema or pooled ``X<i>@...``
#: name, so buffer names never collide with real relations and are
#: ignored by the service's partial-commit bookkeeping.
XFER_PREFIX = "%xfer"


def is_xfer_rel(name: str) -> bool:
    """True for the synthetic shuffle-buffer relations of overlap mode."""
    return name.startswith(XFER_PREFIX)


#: prefix of the synthetic salt-table relations a :class:`SkewProfileJob`
#: publishes (DESIGN.md §17).  Same namespace rules as ``%xfer``: ``%``
#: keeps them out of schemas, pooled names, and partial-commit bookkeeping.
SALT_PREFIX = "%salt"


def is_salt_rel(name: str) -> bool:
    """True for the synthetic salt-table relations of the skew defense."""
    return name.startswith(SALT_PREFIX)


@dataclass(frozen=True)
class TransferJob:
    """Overlap-mode sub-node owning an MSJ job's count exchange + forward
    ``all_to_all`` (DESIGN.md §16).  It reads the base job's inputs and
    publishes one synthetic buffer relation (the exchanged messages plus
    the map-side carry) that the paired :class:`ComputeJob` consumes.  A
    narrowed *dropped* part with an empty ``buffer`` writes nothing: the
    kept part still produces the buffer, so partial taint must not kill
    the paired compute wholesale.

    A skew-split transfer (DESIGN.md §17) additionally reads ``salt`` —
    the :class:`~repro_torch.core.msj.SaltTable` its paired
    :class:`SkewProfileJob` published; hot keys from the table are salted
    across sub-shards during the forward exchange."""

    base: MSJJob
    buffer: str
    salt: str = ""

    def __repr__(self):
        s = f"<~{self.salt}" if self.salt else ""
        return f"XFER({self.buffer}{s}:{[sj.out for sj in self.base.sjs]})"


@dataclass(frozen=True)
class ComputeJob:
    """Overlap-mode sub-node owning an MSJ job's probe + route-back +
    scatter.  Reads the paired transfer's buffer (and the base inputs,
    which the scatter gathers from) and writes the base job's outputs."""

    base: MSJJob
    buffer: str

    def __repr__(self):
        f = f" fused={[q.name for q in self.base.fused]}" if self.base.fused else ""
        return f"PROBE({self.buffer}:{[s.out for s in self.base.sjs]}{f})"


@dataclass(frozen=True)
class SkewProfileJob:
    """Skew-defense sub-node owning one MSJ job's heavy-hitter profile
    pass (DESIGN.md §17): scan the guard relations map-side, run the
    bounded top-k sketch per signature, and publish the merged
    :class:`~repro_torch.core.msj.SaltTable` under ``salt``.  No communication
    — the sketch merge is host-side — so it runs on a compute slot, not
    the comm track.  Reads only the base job's *guard* relations (hotness
    is a probe-side property)."""

    base: MSJJob
    salt: str

    def __repr__(self):
        return f"SKEW({self.salt}:{[sj.out for sj in self.base.sjs]})"


Job = MSJJob | EvalJob | TransferJob | ComputeJob | SkewProfileJob


@dataclass(frozen=True)
class Round:
    jobs: tuple[Job, ...]


@dataclass(frozen=True)
class Plan:
    rounds: tuple[Round, ...]

    @property
    def n_jobs(self) -> int:
        return sum(len(r.jobs) for r in self.rounds)

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)

    def __repr__(self):
        lines = [f"Plan({self.n_rounds} rounds, {self.n_jobs} jobs)"]
        for i, r in enumerate(self.rounds):
            lines.append(f"  round {i}: " + "; ".join(map(repr, r.jobs)))
        return "\n".join(lines)


def concat_plans(plans: Iterable[Plan]) -> Plan:
    rounds: list[Round] = []
    for p in plans:
        rounds.extend(p.rounds)
    return Plan(tuple(rounds))


@dataclass(frozen=True)
class JobNode:
    """One job of a plan as a DAG vertex (see :func:`job_dag`)."""

    idx: int
    job: Job
    round_idx: int
    deps: tuple[int, ...]  # indices of jobs that must finish first
    #: relation names this job reads / produces (drives ``edges="relations"``)
    reads: frozenset[str] = frozenset()
    writes: frozenset[str] = frozenset()


def job_reads(job: Job) -> frozenset[str]:
    """Relation names a job reads: guard + conditional relations of an MSJ
    job (fused formulas evaluate on the in-job route-back bitmap, so a
    fused query adds nothing beyond its guard and atoms), and the guard
    projections plus X_i inputs of an EVAL job."""
    if isinstance(job, MSJJob):
        rels: set[str] = set()
        for sj in job.sjs:
            rels.add(sj.guard.rel)
            rels.add(sj.cond_atom.rel)
        for q in job.fused:
            rels.add(q.guard.rel)
            rels.update(a.rel for a in q.atoms)
        return frozenset(rels)
    if isinstance(job, TransferJob):
        salt = frozenset({job.salt}) if job.salt else frozenset()
        return job_reads(job.base) | salt
    if isinstance(job, ComputeJob):
        # the probe decodes the buffer; the scatter gathers from the base
        # inputs (guard rows project through reps/confs), so a compute
        # node reads both
        return job_reads(job.base) | frozenset({job.buffer})
    if isinstance(job, SkewProfileJob):
        # the sketch scans the probe side only: guard relations
        return frozenset(
            {sj.guard.rel for sj in job.base.sjs}
            | {q.guard.rel for q in job.base.fused}
        )
    rels = {q.guard.rel for q in job.queries}
    for xin in job.atom_inputs:
        rels.update(xin)
    return frozenset(rels)


def job_writes(job: Job) -> frozenset[str]:
    """Relation names a job publishes into the environment: the X_i
    equation outputs and fused query outputs of an MSJ job, or the query
    outputs of an EVAL job (mirrors run_msj / run_eval return keys)."""
    if isinstance(job, MSJJob):
        return frozenset({sj.out for sj in job.sjs} | {q.name for q in job.fused})
    if isinstance(job, TransferJob):
        return frozenset({job.buffer}) if job.buffer else frozenset()
    if isinstance(job, ComputeJob):
        return job_writes(job.base)
    if isinstance(job, SkewProfileJob):
        return frozenset({job.salt}) if job.salt else frozenset()
    return frozenset(q.name for q in job.queries)


#: valid :func:`job_dag` edge modes (mirrored by ExecutorConfig.dag_edges).
DAG_EDGE_MODES = ("relations", "strata")


def job_dag(
    plan: Plan, edges: str = "relations", *, overlap: bool = False,
    skew: bool = False,
) -> tuple[JobNode, ...]:
    """Job-level dependency DAG of a plan.

    ``edges="relations"`` (default) derives edges from read/write sets:
    job J depends exactly on the most recent prior producers of the
    relations J reads (flow dependences), plus anti/output dependences
    when a later round reuses an intermediate name (two strata pooling
    the same (guard, atom) pair at the same pool index produce colliding
    ``X<i>@guard|atom`` names; the WAR/WAW edges keep reuse of a name
    safe under out-of-round execution).  Jobs of one round are committed
    against the state of *earlier* rounds only — the Plan IR guarantees
    same-round jobs are independent — so every edge crosses a round
    boundary and the relation DAG is a subgraph of the strata DAG's
    transitive closure.

    ``edges="strata"`` is the conservative pre-§12 reading: rounds are
    barriers, every job depends on all jobs of the previous round.  With
    W=∞ slots and ``execution_mode="waves"`` the admitted waves then
    coincide exactly with the plan's rounds.

    ``overlap=True`` (DESIGN.md §16) splits every MSJ job into a
    :class:`TransferJob` (count exchange + forward ``all_to_all``) and a
    :class:`ComputeJob` (probe + route-back + scatter).  The pair shares
    one synthetic ``%xfer<idx>`` buffer relation; the buffer RAW edge
    (transfer → compute) is the one *intentional* same-round edge in the
    DAG — everything else still crosses a round boundary — so a job's
    probe becomes ready the moment its own exchange lands, not when the
    whole round's shuffle completes.

    ``skew=True`` (DESIGN.md §17) splits every MSJ job carrying a
    ``skew`` annotation into a *triple*: :class:`SkewProfileJob` (sketch →
    ``%salt<idx>``) → :class:`TransferJob` (salted/replicated forward
    exchange, reading the salt table) → :class:`ComputeJob`.  The salt
    RAW edge (profile → transfer) and the buffer RAW edge (transfer →
    compute) are the two intentional same-round edges.  Annotated jobs
    split regardless of ``overlap``; unannotated jobs follow the overlap
    setting — and with ``skew=False`` an annotated plan degenerates to
    plain (or overlap-pair) nodes, the differential seam the property
    suite executes both sides of.
    """
    if edges not in DAG_EDGE_MODES:
        raise ValueError(
            f"unknown dag edge mode {edges!r}; valid names: {', '.join(DAG_EDGE_MODES)}"
        )

    def split(job: Job, at: int) -> tuple[Job, ...]:
        if skew and isinstance(job, MSJJob) and job.skew is not None:
            buf, salt = f"{XFER_PREFIX}{at}", f"{SALT_PREFIX}{at}"
            return (
                SkewProfileJob(job, salt),
                TransferJob(job, buf, salt),
                ComputeJob(job, buf),
            )
        if overlap and isinstance(job, MSJJob):
            buf = f"{XFER_PREFIX}{at}"
            return (TransferJob(job, buf), ComputeJob(job, buf))
        return (job,)

    nodes: list[JobNode] = []
    idx = 0
    if edges == "strata":
        prev: tuple[int, ...] = ()
        for ri, rnd in enumerate(plan.rounds):
            cur: list[int] = []
            for job in rnd.jobs:
                for sub in split(job, idx):
                    deps = prev
                    if isinstance(sub, ComputeJob):
                        deps = prev + (idx - 1,)  # buffer RAW on the transfer
                    elif isinstance(sub, TransferJob) and sub.salt:
                        deps = prev + (idx - 1,)  # salt RAW on the profile
                    nodes.append(
                        JobNode(idx, sub, ri, deps, job_reads(sub), job_writes(sub))
                    )
                    cur.append(idx)
                    idx += 1
            prev = tuple(cur)
        return tuple(nodes)
    last_writer: dict[str, int] = {}
    readers: dict[str, list[int]] = {}  # readers since the last write
    for ri, rnd in enumerate(plan.rounds):
        staged: list[tuple[int, frozenset, frozenset]] = []
        for job in rnd.jobs:
            xfer_idx: int | None = None
            salt_idx: int | None = None
            for sub in split(job, idx):
                reads, writes = job_reads(sub), job_writes(sub)
                deps: set[int] = set()
                for r in reads:
                    if r in last_writer:  # flow (RAW): producer of what we read
                        deps.add(last_writer[r])
                for r in writes:
                    if r in last_writer:  # output (WAW): don't clobber early
                        deps.add(last_writer[r])
                    deps.update(readers.get(r, ()))  # anti (WAR)
                if isinstance(sub, ComputeJob):
                    deps.add(xfer_idx)  # buffer RAW on the paired transfer
                elif isinstance(sub, TransferJob):
                    if sub.salt:
                        deps.add(salt_idx)  # salt RAW on the paired profile
                    xfer_idx = idx
                elif isinstance(sub, SkewProfileJob):
                    salt_idx = idx
                nodes.append(JobNode(idx, sub, ri, tuple(sorted(deps)), reads, writes))
                staged.append((idx, reads, writes))
                idx += 1
        # commit the whole round at once: same-round jobs never see each
        # other (the IR contract: jobs of a round may run in parallel;
        # the profile→transfer salt edge and transfer→compute buffer edge
        # above are the sole exceptions and are added explicitly rather
        # than through the bookkeeping)
        for i, reads, _ in staged:
            for r in reads:
                readers.setdefault(r, []).append(i)
        for i, _, writes in staged:
            for r in writes:
                last_writer[r] = i
                readers[r] = []
    return tuple(nodes)


def conflict_rels(
    reads_a: frozenset[str],
    writes_a: frozenset[str],
    reads_b: frozenset[str],
    writes_b: frozenset[str],
) -> frozenset[str]:
    """Relations on which two jobs conflict: a common relation that at
    least one side writes (RAW, WAR or WAW).  Read-read sharing is not a
    conflict.  This is the reference relation the verifier and the
    schedule sanitizer both check edge coverage against (DESIGN.md §15)."""
    return (writes_a & (reads_b | writes_b)) | (reads_a & writes_b)


def conflicting_pairs(
    nodes: Sequence[JobNode],
) -> list[tuple[int, int, frozenset[str]]]:
    """All job pairs ``(i, j)`` with ``i < j`` that conflict, with the
    conflicting relations.  O(n^2) by construction — this is the *spec*,
    independent of the one-pass last-writer bookkeeping in
    :func:`job_dag`, so a bug there cannot hide here."""
    out: list[tuple[int, int, frozenset[str]]] = []
    for a in nodes:
        for b in nodes:
            if a.idx >= b.idx:
                continue
            rels = conflict_rels(a.reads, a.writes, b.reads, b.writes)
            if rels:
                out.append((a.idx, b.idx, rels))
    return out


def dag_closure(nodes: Sequence[JobNode]) -> dict[int, frozenset[int]]:
    """Transitive predecessor sets of a job DAG: ``closure[j]`` is every
    node index reachable from ``j`` by following ``deps`` edges.  Nodes
    are processed in index order, so forward (contract-violating) deps
    simply don't close — the verifier reports them separately."""
    closure: dict[int, frozenset[int]] = {}
    for n in sorted(nodes, key=lambda n: n.idx):
        anc: set[int] = set()
        for d in n.deps:
            anc.add(d)
            anc |= closure.get(d, frozenset())
        closure[n.idx] = frozenset(anc)
    return closure


def uncovered_conflicts(
    nodes: Sequence[JobNode],
    closure: dict[int, frozenset[int]] | None = None,
) -> list[tuple[int, int, frozenset[str]]]:
    """Edge-cover query: conflicting pairs with **no** covering dependency
    path in the DAG.  Any entry is a latent data race — the async ready
    queue is free to run the pair in either order or concurrently.  Pairs
    inside one round are *always* uncovered (every DAG edge crosses a
    round boundary); they are returned too and the verifier classifies
    them as IR-contract violations."""
    if closure is None:
        closure = dag_closure(nodes)
    return [
        (i, j, rels)
        for i, j, rels in conflicting_pairs(nodes)
        if i not in closure.get(j, frozenset())
    ]


def taint_closure(
    nodes: Iterable[JobNode], tainted_rels: Iterable[str]
) -> tuple[frozenset[int], frozenset[str]]:
    """Blast radius of a failure, over read/write sets (DESIGN.md §13).

    Given the relations a failed job should have written (``tainted_rels``)
    and the not-yet-executed ``nodes``, returns the node indices that must
    be skipped — every job transitively *reading* a tainted relation —
    plus the closed tainted-relation set (the skipped jobs' writes join
    it, which is what makes the closure transitive).  Jobs related to the
    failure only by anti/output (WAR/WAW) dependences never read a
    tainted relation and stay runnable; a healthy re-writer of a tainted
    *name* does not clear the taint (conservative on cross-stratum name
    reuse — readers of the re-written name are still skipped).
    """
    rels = set(tainted_rels)
    tainted: set[int] = set()
    pending = list(nodes)
    changed = True
    while changed:  # nodes arrive in plan order, so this converges fast
        changed = False
        for n in pending:
            if n.idx not in tainted and n.reads & rels:
                tainted.add(n.idx)
                rels |= n.writes
                changed = True
    return frozenset(tainted), frozenset(rels)


def narrow_job(job: Job, tainted: Iterable[str]) -> tuple[Job | None, Job | None]:
    """Split a job against a tainted-relation set: ``(kept, dropped)``.

    Fused multi-tenant jobs are shared failure domains — one MSJ job
    carries many tenants' equations, one EVAL job many tenants' Boolean
    evaluations.  Skipping the whole job over one poisoned input would
    cliff the tick; instead the job is *narrowed* to the units that touch
    no tainted relation (DESIGN.md §13):

    * MSJ — equations whose guard or conditional relation is tainted are
      dropped, as are fused queries whose guard or any atom relation is
      tainted (a fused query's equations share its guard, so its
      equations drop with it).
    * EVAL — per-query units whose guard or any X_i input is tainted are
      dropped.

    Either side of the split is ``None`` when empty.  ``kept`` touching
    no tainted relation is the invariant the executor's sweep relies on
    for convergence; ``dropped`` carries exactly the poisoned units, so
    recording it as a tainted :class:`~repro_torch.core.executor.JobRecord`
    makes ``Report.tainted_relations`` transitively exact.
    """
    rels = set(tainted)
    if isinstance(job, TransferJob):
        if job.salt and job.salt in rels:
            # the profile pass never published the salt table: the salted
            # exchange cannot run at all (its routing input is poisoned),
            # so the whole transfer drops and takes the buffer with it —
            # which in turn drops the paired compute via its buffer read
            return None, TransferJob(job.base, job.buffer, job.salt)
        kept_b, dropped_b = narrow_job(job.base, rels)
        kept = (
            TransferJob(kept_b, job.buffer, job.salt)
            if kept_b is not None
            else None
        )
        # a partially-narrowed transfer still produces the buffer from its
        # kept units, so the dropped part must not write (= taint) the
        # buffer name; only a fully-dropped transfer takes the buffer with
        # it, which in turn drops the paired compute via its buffer read
        dropped = (
            TransferJob(
                dropped_b, "" if kept_b is not None else job.buffer, job.salt
            )
            if dropped_b is not None
            else None
        )
        return kept, dropped
    if isinstance(job, SkewProfileJob):
        # narrows like its base: the surviving units' sketch is still
        # valid for the (separately narrowed) transfer because the salt
        # table is keyed by signature triple, not positional sig_id
        kept_b, dropped_b = narrow_job(job.base, rels)
        kept = SkewProfileJob(kept_b, job.salt) if kept_b is not None else None
        dropped = (
            SkewProfileJob(dropped_b, "" if kept_b is not None else job.salt)
            if dropped_b is not None
            else None
        )
        return kept, dropped
    if isinstance(job, ComputeJob):
        if job.buffer in rels:  # exchange never landed: nothing to probe
            return None, ComputeJob(job.base, job.buffer)
        kept_b, dropped_b = narrow_job(job.base, rels)
        kept = ComputeJob(kept_b, job.buffer) if kept_b is not None else None
        dropped = ComputeJob(dropped_b, job.buffer) if dropped_b is not None else None
        return kept, dropped
    if isinstance(job, MSJJob):
        bad_sj = lambda sj: sj.guard.rel in rels or sj.cond_atom.rel in rels  # noqa: E731
        bad_q = lambda q: q.guard.rel in rels or any(  # noqa: E731
            a.rel in rels for a in q.atoms
        )
        keep_sjs = tuple(sj for sj in job.sjs if not bad_sj(sj))
        keep_fused = tuple(q for q in job.fused if not bad_q(q))
        drop_sjs = tuple(sj for sj in job.sjs if bad_sj(sj))
        drop_fused = tuple(q for q in job.fused if bad_q(q))
        # a fused query routes back on its equations' bitmaps: if any of
        # them dropped, the query cannot evaluate in-job
        fused_alive = []
        for q in keep_fused:
            eqs = {(q.guard, a) for a in q.atoms}
            if all((sj.guard, sj.cond_atom) not in eqs or not bad_sj(sj) for sj in job.sjs):
                fused_alive.append(q)
            else:
                drop_fused = drop_fused + (q,)
        keep_fused = tuple(fused_alive)
        kept = MSJJob(keep_sjs, keep_fused) if keep_sjs else None
        dropped = (
            MSJJob(drop_sjs, drop_fused) if (drop_sjs or drop_fused) else None
        )
        return kept, dropped
    pairs = list(zip(job.queries, job.atom_inputs))
    bad = lambda q, xin: q.guard.rel in rels or any(x in rels for x in xin)  # noqa: E731
    keep = [(q, xin) for q, xin in pairs if not bad(q, xin)]
    drop = [(q, xin) for q, xin in pairs if bad(q, xin)]
    kept = (
        EvalJob(tuple(q for q, _ in keep), tuple(x for _, x in keep)) if keep else None
    )
    dropped = (
        EvalJob(tuple(q for q, _ in drop), tuple(x for _, x in drop)) if drop else None
    )
    return kept, dropped


def estimate_job_costs(
    nodes: Sequence[JobNode],
    stats: "Stats",
    consts: CostConstants = HADOOP,
    *,
    model: str = "gumbo",
) -> dict[int, float]:
    """Modeled per-job cost for each DAG node, in node (plan) order so
    ``register_output`` feeds later rounds — the admission-time estimate
    both the slot scheduler's LPT ordering and the executor's speculation
    deadlines consume.  ``stats`` is copied; the caller's is untouched."""
    import copy

    st = copy.deepcopy(stats)
    return {n.idx: job_cost(n.job, st, consts, model=model) for n in nodes}


# --------------------------------------------------------------------------
# Semi-join pooling for a stratum (set of BSGF queries)
# --------------------------------------------------------------------------


def full_guard_vars(q: BSGF) -> tuple[str, ...]:
    return q.guard.vars


def pooled_semijoins(queries: Sequence[BSGF]) -> tuple[list[SemiJoin], dict]:
    """Distinct semi-joins of a stratum + per-(query, atom) output names.

    Equations project to the *full guard tuple* (see module docstring).
    Two (guard, atom) pairs are merged into one equation — the paper's
    "lower number of distinct semi-joins" effect for same-level queries.
    """
    pool: dict[tuple, SemiJoin] = {}
    atom_x: dict[tuple[str, Atom], str] = {}
    for q in queries:
        for a in q.atoms:
            key = (q.guard, a)
            if key not in pool:
                sj = SemiJoin(
                    out=f"X{len(pool)}@{q.guard.rel}|{a.rel}",
                    out_vars=full_guard_vars(q),
                    guard=q.guard,
                    cond_atom=a,
                )
                pool[key] = sj
            atom_x[(q.name, a)] = pool[key].out
    return list(pool.values()), atom_x


def eval_job_for(queries: Sequence[BSGF], atom_x: dict) -> EvalJob:
    return EvalJob(
        queries=tuple(queries),
        atom_inputs=tuple(
            tuple(atom_x[(q.name, a)] for a in q.atoms) for q in queries
        ),
    )


# --------------------------------------------------------------------------
# BSGF-OPT: gain-greedy + brute force (Theorem 1: NP-complete)
# --------------------------------------------------------------------------

CostFn = Callable[[Sequence[SemiJoin]], float]


def default_costfn(
    stats: Stats, consts: CostConstants = HADOOP, *, model: str = "gumbo"
) -> CostFn:
    return lambda group: msj_job_cost(list(group), stats, consts, model=model)


def gain(si: Sequence[SemiJoin], sj: Sequence[SemiJoin], costfn: CostFn) -> float:
    return costfn(si) + costfn(sj) - costfn(list(si) + list(sj))


def greedy_group(sjs: Sequence[SemiJoin], costfn: CostFn) -> list[list[SemiJoin]]:
    """GREEDY-BSGF: start from singletons, repeatedly merge the pair with
    the largest positive gain."""
    groups: list[list[SemiJoin]] = [[s] for s in sjs]
    while len(groups) > 1:
        best, best_pair = 0.0, None
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                g = gain(groups[i], groups[j], costfn)
                if g > best:
                    best, best_pair = g, (i, j)
        if best_pair is None:
            break
        i, j = best_pair
        groups[i] = groups[i] + groups[j]
        del groups[j]
    return groups


def _set_partitions(items: list):
    """All set partitions (Bell-number enumeration; use for ≤ ~8 items)."""
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in _set_partitions(rest):
        for i in range(len(part)):
            yield part[:i] + [[first] + part[i]] + part[i + 1 :]
        yield [[first]] + part


def brute_force_group(
    sjs: Sequence[SemiJoin], costfn: CostFn
) -> tuple[list[list[SemiJoin]], float]:
    """OPT(Q): exhaustive BSGF-OPT (exponential; small queries only)."""
    best, best_cost = None, float("inf")
    for part in _set_partitions(list(sjs)):
        c = sum(costfn(g) for g in part)
        if c < best_cost:
            best, best_cost = part, c
    return best, best_cost


# --------------------------------------------------------------------------
# Strategies for one stratum (a set of independent BSGF queries)
# --------------------------------------------------------------------------


def _is_literal(c: Cond) -> bool:
    return isinstance(c, Atom) or (isinstance(c, Not) and isinstance(c.child, Atom))


def _conj_literals(c: Cond) -> list[Cond] | None:
    """Flatten a pure conjunction of literals, else None."""
    if _is_literal(c):
        return [c]
    if hasattr(c, "left") and type(c).__name__ == "And":
        l = _conj_literals(c.left)
        r = _conj_literals(c.right)
        if l is not None and r is not None:
            return l + r
    return None


def _disj_of_conjs(c: Cond) -> list[list[Cond]] | None:
    """Flatten a top-level disjunction of conjunctions of literals."""
    conj = _conj_literals(c)
    if conj is not None:
        return [conj]
    if isinstance(c, Or):
        l = _disj_of_conjs(c.left)
        r = _disj_of_conjs(c.right)
        if l is not None and r is not None:
            return l + r
    return None


def plan_par(queries: Sequence[BSGF]) -> Plan:
    """PAR: every distinct semi-join in its own MSJ job, one EVAL round."""
    sjs, atom_x = pooled_semijoins(queries)
    r1 = Round(tuple(MSJJob((s,)) for s in sjs))
    r2 = Round((eval_job_for(queries, atom_x),))
    if not sjs:  # condition-free queries
        return Plan((r2,))
    return Plan((r1, r2))


def plan_greedy(
    queries: Sequence[BSGF],
    stats: Stats,
    consts: CostConstants = HADOOP,
    *,
    model: str = "gumbo",
    optimal: bool = False,
) -> Plan:
    """GREEDY (GOPT) / brute-force (OPT) grouping + one EVAL round."""
    sjs, atom_x = pooled_semijoins(queries)
    costfn = default_costfn(stats, consts, model=model)
    if not sjs:
        return Plan((Round((eval_job_for(queries, atom_x),)),))
    if optimal:
        groups, _ = brute_force_group(sjs, costfn)
    else:
        groups = greedy_group(sjs, costfn)
    r1 = Round(tuple(MSJJob(tuple(g)) for g in groups))
    r2 = Round((eval_job_for(queries, atom_x),))
    return Plan((r1, r2))


def plan_one_round(queries: Sequence[BSGF], *, faithful: bool = False) -> Plan:
    """1-ROUND: one MSJ job with the Boolean formulas fused in.

    ``faithful=True`` enforces the paper's applicability condition (all
    conditional atoms of a query share one join key, or the condition uses
    only disjunction/negation); the generalized route-back fusion works for
    any BSGF and is the default.
    """
    if faithful:
        for q in queries:
            keys = {tuple(q.join_key(a)) for a in q.atoms}
            if len(keys) > 1:
                raise ValueError(
                    f"1-ROUND (faithful) needs a shared join key; {q.name} has {keys}"
                )
    sjs, _ = pooled_semijoins(queries)
    return Plan((Round((MSJJob(tuple(sjs), fused=tuple(queries)),)),))


def plan_seq(q: BSGF) -> Plan:
    """SEQ: the classic semi-join reducer chain.

    Conjunctions chain ``guard ⋉ κ1 ⋉ κ2 ...`` (anti-join for negated
    literals), narrowing the guard each round.  A top-level disjunction of
    conjunctions runs one chain per disjunct (in parallel) + a final union
    EVAL.  Other shapes have no sequential plan (paper footnote 4).
    """
    if q.cond is None:
        return plan_one_round([q])
    disj = _disj_of_conjs(q.cond)
    if disj is None:
        raise ValueError(f"no sequential plan for non-DNF-able condition {q.cond}")

    gvars = q.guard.vars
    chains: list[list[BSGF]] = []
    for ci, conj in enumerate(disj):
        prev_atom = q.guard
        chain: list[BSGF] = []
        for li, lit in enumerate(conj):
            last = li == len(conj) - 1
            single = len(disj) == 1
            name = (
                q.name
                if (last and single)
                else f"{q.name}~c{ci}s{li}"
            )
            out_vars = q.out_vars if (last and single) else gvars
            chain.append(BSGF(name, out_vars, prev_atom, lit))
            prev_atom = Atom(name, *gvars)
        chains.append(chain)

    depth = max(len(c) for c in chains)
    rounds = []
    for d in range(depth):
        jobs = []
        for chain in chains:
            if d < len(chain):
                step = chain[d]
                sjs, _ = pooled_semijoins([step])
                jobs.append(MSJJob(tuple(sjs), fused=(step,)))
        rounds.append(Round(tuple(jobs)))
    if len(chains) > 1:
        # union of the chain outputs: Z := guard-projection ∧ (OR of chains)
        atoms = [Atom(c[-1].name, *gvars) for c in chains]
        union_q = BSGF(q.name, q.out_vars, q.guard, _or_all(atoms))
        atom_x = {(q.name, a): a.rel for a in atoms}
        rounds.append(Round((eval_job_for([union_q], atom_x),)))
    return Plan(tuple(rounds))


def _or_all(atoms: Sequence[Atom]) -> Cond:
    out: Cond = atoms[0]
    for a in atoms[1:]:
        out = Or(out, a)
    return out


# --------------------------------------------------------------------------
# SGF-OPT: multiway topological sorts (Theorem 2: NP-complete)
# --------------------------------------------------------------------------


def overlap(q: BSGF, stratum: Sequence[BSGF]) -> int:
    rels = set()
    for p in stratum:
        rels |= p.relations
    return len(q.relations & rels)


def greedy_sgf(sgf: SGF) -> list[list[BSGF]]:
    """GREEDY-SGF: the blue/red multiway-topological-sort heuristic
    (Section 4.6), maximizing relation overlap within strata."""
    deps = sgf.dependency_graph()  # name -> set of predecessor names
    blue = {q.name for q in sgf}
    strata: list[list[BSGF]] = []
    placed: dict[str, int] = {}  # name -> stratum index

    while blue:
        # D: blue vertices with no blue predecessors
        D = [n for n in blue if not (deps[n] & blue)]
        D.sort(key=lambda n: [q.name for q in sgf].index(n))
        u = None
        best = (0, None)  # (overlap, stratum index)
        for cand in D:
            q = sgf.by_name(cand)
            lo = max((placed[p] + 1 for p in deps[cand]), default=0)
            for i in range(lo, len(strata)):
                ov = overlap(q, strata[i])
                if ov > best[0]:
                    best = (ov, i)
                    u = cand
        if u is None:
            u = D[0]
            q = sgf.by_name(u)
            lo = max((placed[p] + 1 for p in deps[u]), default=0)
            if lo >= len(strata):
                strata.append([])
            # no positive overlap anywhere valid: open a new stratum at the end
            idx = len(strata) - 1 if lo <= len(strata) - 1 and not strata[-1] else None
            if idx is None:
                strata.append([])
                idx = len(strata) - 1
            strata[idx].append(q)
            placed[u] = idx
        else:
            q = sgf.by_name(u)
            strata[best[1]].append(q)
            placed[u] = best[1]
        blue.remove(u)
    return [s for s in strata if s]


def levels_of(sgf: SGF) -> list[list[BSGF]]:
    """PARUNIT strata: classic level-by-level topological layering."""
    deps = sgf.dependency_graph()
    level: dict[str, int] = {}
    for q in sgf:  # definition order is a valid topological order
        level[q.name] = max((level[p] + 1 for p in deps[q.name]), default=0)
    n_levels = max(level.values(), default=0) + 1
    return [[q for q in sgf if level[q.name] == lv] for lv in range(n_levels)]


def brute_force_sgf(
    sgf: SGF, stratum_cost: Callable[[Sequence[BSGF]], float]
) -> tuple[list[list[BSGF]], float]:
    """OPT over all multiway topological sorts (tiny queries only)."""
    names = [q.name for q in sgf]
    deps = sgf.dependency_graph()
    best, best_cost = None, float("inf")

    def valid(strata: list[list[str]]) -> bool:
        pos = {n: i for i, s in enumerate(strata) for n in s}
        return all(pos[p] < pos[n] for n in names for p in deps[n])

    for part in _set_partitions(names):
        for order in itertools.permutations(part):
            strata = [list(s) for s in order]
            if not valid(strata):
                continue
            c = sum(stratum_cost([sgf.by_name(n) for n in s]) for s in strata)
            if c < best_cost:
                best, best_cost = [
                    [sgf.by_name(n) for n in s] for s in strata
                ], c
    return best, best_cost


# --------------------------------------------------------------------------
# Full-SGF strategies (Section 5.3)
# --------------------------------------------------------------------------


def plan_sgf(
    sgf: SGF,
    strategy: str,
    stats: Stats | None = None,
    consts: CostConstants = HADOOP,
    *,
    model: str = "gumbo",
) -> Plan:
    """SEQUNIT / PARUNIT / GREEDY (=GREEDY-SGF) / ONE_ROUND plans."""
    if strategy == "sequnit":
        strata = [[q] for q in sgf]
        return concat_plans(plan_par(s) for s in strata)
    if strategy == "parunit":
        return concat_plans(plan_par(s) for s in levels_of(sgf))
    if strategy == "greedy":
        assert stats is not None, "GREEDY-SGF needs statistics"
        strata = greedy_sgf(sgf)
        plans = []
        for s in strata:
            plans.append(plan_greedy(s, stats, consts, model=model))
            _register_stratum_outputs(s, stats)
        return concat_plans(plans)
    if strategy == "one_round":
        strata = levels_of(sgf)
        return concat_plans(plan_one_round(s) for s in strata)
    raise ValueError(strategy)


def _register_stratum_outputs(queries: Sequence[BSGF], stats: Stats) -> None:
    """Feed estimated output sizes forward so later strata can be costed."""
    for q in queries:
        rows = stats.rel(q.guard.rel).rows
        est = rows
        for a in q.atoms:  # crude independence estimate
            est *= stats.sel.get((q.guard.rel, a.rel), stats.default_sel) ** 0.5
        stats.register_output(q.name, max(est, 1.0), len(q.out_vars))


# --------------------------------------------------------------------------
# Skew-defense annotation (DESIGN.md §17)
# --------------------------------------------------------------------------


def annotate_skew(
    plan: Plan,
    stats: Stats,
    P: int,
    *,
    packing: bool = True,
    skew_factor: float = SKEW_FACTOR,
    force_R: int | None = None,
    threshold: int | None = None,
) -> Plan:
    """Annotate each MSJ job whose heavy-hitter evidence justifies
    splitting with a :class:`~repro_torch.core.costmodel.SkewDefense`.

    Evidence comes from ``RelStats.heavy_hitters`` (``stats_of_db(...,
    heavy_hitters=k)`` or catalog plumbing): per single-key semi-join, the
    guard's key-column hitters are the probe side and the cond atom's the
    build side.  Multi-key signatures carry no per-column evidence — the
    run-time profile pass still defends them once annotated, but the
    plan-time decision stays conservative and skips them.

    ``force_R`` annotates every MSJ job unconditionally (corpus / test
    plumbing — exercises the profile→transfer→compute split without
    needing hitter evidence); ``threshold`` overrides the run-time
    hot-count bar in either mode.
    """
    rounds = []
    for r in plan.rounds:
        jobs = []
        for job in r.jobs:
            if not isinstance(job, MSJJob) or not job.sjs:
                jobs.append(job)
                continue
            if force_R is not None:
                ann = SkewDefense(
                    R=int(force_R), threshold=int(threshold or 1), hot=()
                )
                jobs.append(replace(job, skew=ann))
                continue
            probe_rows, build_rows = 0.0, 0.0
            probe_h: dict[int, int] = {}
            build_h: dict[int, int] = {}
            for sj in job.sjs:
                try:
                    gs = stats.rel(sj.guard.rel)
                    bs = stats.rel(sj.cond_atom.rel)
                except KeyError:
                    continue
                probe_rows = max(probe_rows, gs.rows)
                build_rows += bs.rows
                kv = sj.key_vars
                if len(kv) != 1:
                    continue
                gcol = sj.guard.positions_of(kv[0])[0]
                bcol = sj.cond_atom.positions_of(kv[0])[0]
                for v, n in gs.hitters_for(gcol):
                    probe_h[v] = max(probe_h.get(v, 0), int(n))
                for v, n in bs.hitters_for(bcol):
                    build_h[v] = max(build_h.get(v, 0), int(n))
            ann = choose_skew(
                probe_rows,
                build_rows,
                tuple(sorted(probe_h.items(), key=lambda vn: (-vn[1], vn[0]))),
                P,
                build_hitters=tuple(
                    sorted(build_h.items(), key=lambda vn: (-vn[1], vn[0]))
                ),
                packing=packing,
                skew_factor=skew_factor,
            )
            if ann is not None and threshold is not None:
                ann = replace(ann, threshold=int(threshold))
            jobs.append(replace(job, skew=ann) if ann is not None else job)
        rounds.append(Round(tuple(jobs)))
    return Plan(tuple(rounds))


# --------------------------------------------------------------------------
# Modeled plan cost (total / net) — what the experiments report
# --------------------------------------------------------------------------


def job_cost(
    job: Job, stats: Stats, consts: CostConstants = HADOOP, *, model: str = "gumbo"
) -> float:
    if isinstance(job, MSJJob):
        c = msj_job_cost(list(job.sjs), stats, consts, model=model, skew=job.skew)
        for q in job.fused:
            stats.register_output(
                q.name, stats.rel(q.guard.rel).rows * stats.default_sel, len(q.out_vars)
            )
        for sj in job.sjs:
            stats.register_output(sj.out, stats.out_rows(sj), len(sj.out_vars))
        return c
    if isinstance(job, SkewProfileJob):
        # one scan over the guard inputs to sketch hot keys; registers
        # nothing — the salt table is routing metadata, not a relation
        return msj_profile_cost(list(job.base.sjs), stats, consts)
    if isinstance(job, TransferJob):
        # priced before the paired compute in node order; registers
        # nothing — the outputs only exist once the compute publishes
        return msj_transfer_cost(
            list(job.base.sjs), stats, consts, model=model, skew=job.base.skew
        )
    if isinstance(job, ComputeJob):
        c = msj_compute_cost(
            list(job.base.sjs), stats, consts, model=model, skew=job.base.skew
        )
        for q in job.base.fused:
            stats.register_output(
                q.name, stats.rel(q.guard.rel).rows * stats.default_sel, len(q.out_vars)
            )
        for sj in job.base.sjs:
            stats.register_output(sj.out, stats.out_rows(sj), len(sj.out_vars))
        return c
    # EVAL: X0 (guard projection) + the X_i inputs per query
    sizes: list[RelStats] = []
    out_mb = 0.0
    for q, xin in zip(job.queries, job.atom_inputs):
        g = stats.rel(q.guard.rel)
        sizes.append(RelStats(rows=g.rows, arity=len(q.guard.vars)))
        for name in xin:
            sizes.append(stats.rel(name))
        out_rows = g.rows * stats.default_sel
        stats.register_output(q.name, out_rows, len(q.out_vars))
        out_mb += out_rows * len(q.out_vars) * BYTES_PER_CELL / MB
    return eval_job_cost(sizes, out_mb, consts, model=model)


def plan_cost(
    plan: Plan,
    stats: Stats,
    consts: CostConstants = HADOOP,
    *,
    model: str = "gumbo",
    slots: int | None = None,
) -> dict:
    """Modeled total/net cost; net = Σ_rounds makespan of the round's jobs.

    ``slots`` bounds how many jobs the cluster runs concurrently (the
    service scheduler's W); the per-round makespan is then the LPT
    list-scheduling makespan on W machines.  ``slots=None`` (unbounded)
    reduces to the classic ``Σ_rounds max_job`` — bit-identical to the
    pre-slot behaviour.
    """
    import copy

    st = copy.deepcopy(stats)
    total, net = 0.0, 0.0
    for r in plan.rounds:
        costs = [job_cost(j, st, consts, model=model) for j in r.jobs]
        total += sum(costs)
        net += lpt_makespan(costs, slots)
    return {"total": total, "net": net, "rounds": plan.n_rounds, "jobs": plan.n_jobs}
