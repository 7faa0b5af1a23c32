"""Static plan verifier (DESIGN.md §15).

Re-derives every obligation the planner/executor pair relies on from
first principles — its own walk over the job IR, not
:func:`~repro_torch.core.planner.job_reads` — so a bug in the production
read/write derivation cannot hide from the checker that is supposed to
catch it.  The rules:

==================== ======== ===================================================
rule                 severity what it checks
==================== ======== ===================================================
``arity``            error    every use of a relation (guard/cond atom, X_i
                              input, schema entry, write) agrees on one arity
``dangling-read``    error*   a read with no earlier-round producer and no
                              schema/base entry (*warning without a schema)
``dead-write``       warning  an ``X_i`` equation output no later job consumes
                              (fused queries consume their equations in-job)
``namespace``        error    canonical batches use ``q<i>`` outputs and
                              ``v<i>`` variables; any ``X<i>@g|a``-shaped name
                              must agree with its equation's guard/atom rels
``readset-mismatch`` error    a DAG node's recorded reads/writes differ from
                              the sets re-derived from its job
``same-round-conflict`` error two jobs of one round conflict — violates the
                              Plan IR contract that rounds are parallel-safe
``uncovered-conflict``  error a cross-round conflicting pair with no covering
                              dependency path in the DAG (a latent data race)
``cycle``            error    a dep edge points forward (deps must reference
                              earlier node indices; with that, acyclicity)
``stratum-monotone`` error    a dep edge that does not cross a round boundary
                              forward
==================== ======== ===================================================

The core obligation is ``uncovered-conflict``: for every job pair
touching a common relation with at least one write, a covering path must
exist in ``job_dag(plan, edges="relations")`` — otherwise the async
ready queue, speculation clones and ``narrow_job`` splits are all free
to expose the race.  The conflict relation itself
(:func:`~repro_torch.core.planner.conflicting_pairs`) and the edge-cover query
(:func:`~repro_torch.core.planner.uncovered_conflicts`) live in the planner as
the shared reference; this module feeds them access sets derived
independently from the jobs.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping, Sequence

from repro_torch.core.algebra import Atom, BSGF
from repro_torch.core.planner import (
    ComputeJob,
    EvalJob,
    Job,
    JobNode,
    MSJJob,
    Plan,
    SkewProfileJob,
    TransferJob,
    conflict_rels,
    conflicting_pairs,
    dag_closure,
    full_guard_vars,
    is_salt_rel,
    is_xfer_rel,
    job_dag,
)

#: finding severities, most severe first
SEVERITIES = ("error", "warning")

_Q_NAME = re.compile(r"^q\d+$")
_V_NAME = re.compile(r"^v\d+$")
_X_NAME = re.compile(r"^X\d+@(?P<guard>[^|]+)\|(?P<atom>.+)$")


@dataclass(frozen=True)
class Finding:
    """One verifier/sanitizer diagnostic.

    ``job`` is the offending node index (``-1`` for plan-level findings);
    ``rels`` the relation names involved, sorted for determinism.
    """

    severity: str
    rule: str
    job: int
    rels: tuple[str, ...]
    message: str

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        where = f"job {self.job}" if self.job >= 0 else "plan"
        rels = f" [{', '.join(self.rels)}]" if self.rels else ""
        return f"{self.severity}:{self.rule} @ {where}{rels}: {self.message}"


def errors(findings: Sequence[Finding]) -> list[Finding]:
    """The error-severity subset (what CI gates fail on)."""
    return [f for f in findings if f.severity == "error"]


# --------------------------------------------------------------------------
# first-principles access derivation (independent of planner.job_reads)
# --------------------------------------------------------------------------


def derive_accesses(job: Job) -> tuple[frozenset[str], frozenset[str]]:
    """``(reads, writes)`` of a job, re-derived by walking the job IR.

    Deliberately *not* implemented via ``job_reads``/``job_writes`` — the
    whole point of the verifier is to catch a drifted production
    derivation (rule ``readset-mismatch``)."""
    reads: set[str] = set()
    writes: set[str] = set()
    if isinstance(job, MSJJob):
        for sj in job.sjs:
            reads.add(sj.guard.rel)
            reads.add(sj.cond_atom.rel)
            writes.add(sj.out)
        for q in job.fused:
            reads.add(q.guard.rel)
            reads.update(a.rel for a in q.atoms)
            writes.add(q.name)
    elif isinstance(job, EvalJob):
        for q, xins in zip(job.queries, job.atom_inputs):
            reads.add(q.guard.rel)
            reads.update(xins)
            writes.add(q.name)
    elif isinstance(job, TransferJob):
        # transfer sub-node (DESIGN.md §16): reads everything the base MSJ
        # job reads (the map stage stacks every input relation) plus, when
        # salted, the profile pass's salt table (DESIGN.md §17); writes
        # only the in-flight exchange buffer — never the base outputs
        base_reads, _ = derive_accesses(job.base)
        reads.update(base_reads)
        if job.salt:
            reads.add(job.salt)
        if job.buffer:
            writes.add(job.buffer)
    elif isinstance(job, SkewProfileJob):
        # profile sub-node (DESIGN.md §17): scans only the base job's
        # *guard* relations (hotness is a probe-side property — the build
        # side is replicated, never salted) and writes the salt table
        for sj in job.base.sjs:
            reads.add(sj.guard.rel)
        for q in job.base.fused:
            reads.add(q.guard.rel)
        if job.salt:
            writes.add(job.salt)
    elif isinstance(job, ComputeJob):
        # compute sub-node: the base accesses plus a RAW read of the
        # exchange buffer its transfer twin produced in the *same* round
        base_reads, base_writes = derive_accesses(job.base)
        reads.update(base_reads)
        reads.add(job.buffer)
        writes.update(base_writes)
    else:  # pragma: no cover - future job kinds must be taught here
        raise TypeError(f"unknown job kind {type(job).__name__}")
    return frozenset(reads), frozenset(writes)


def _atom_uses(job: Job) -> list[tuple[str, int, str]]:
    """Every ``(relation, arity, role)`` use a job makes, atom by atom.

    Transfer sub-nodes use the base job's guard/cond atoms (the map stage
    reads them) but produce no relation-shaped output — the exchange
    buffer has no arity; compute sub-nodes replay every base use (the
    probe/scatter side materializes the ``X_i``/fused outputs)."""
    if isinstance(job, ComputeJob):
        return _atom_uses(job.base)
    if isinstance(job, SkewProfileJob):
        # the sketch scans guard relations only; the salt table it writes
        # is routing metadata without an arity
        uses = []
        for sj in job.base.sjs:
            uses.append((sj.guard.rel, sj.guard.arity, "guard"))
        for q in job.base.fused:
            uses.append((q.guard.rel, q.guard.arity, "guard"))
        return uses
    if isinstance(job, TransferJob):
        uses = []
        for sj in job.base.sjs:
            uses.append((sj.guard.rel, sj.guard.arity, "guard"))
            uses.append((sj.cond_atom.rel, sj.cond_atom.arity, "cond"))
        for q in job.base.fused:
            uses.append((q.guard.rel, q.guard.arity, "guard"))
            for a in q.atoms:
                uses.append((a.rel, a.arity, "cond"))
        return uses
    uses: list[tuple[str, int, str]] = []
    if isinstance(job, MSJJob):
        for sj in job.sjs:
            uses.append((sj.guard.rel, sj.guard.arity, "guard"))
            uses.append((sj.cond_atom.rel, sj.cond_atom.arity, "cond"))
            uses.append((sj.out, len(sj.out_vars), "x-out"))
        for q in job.fused:
            uses.append((q.guard.rel, q.guard.arity, "guard"))
            for a in q.atoms:
                uses.append((a.rel, a.arity, "cond"))
            uses.append((q.name, len(q.out_vars), "q-out"))
    else:
        for q, xins in zip(job.queries, job.atom_inputs):
            uses.append((q.guard.rel, q.guard.arity, "guard"))
            want = len(full_guard_vars(q))
            for x in xins:
                uses.append((x, want, "x-in"))
            uses.append((q.name, len(q.out_vars), "q-out"))
    return uses


def _sub_edge(a: JobNode, b: JobNode) -> bool:
    """True when ``a -> b`` is an intentional same-round sub-edge of one
    split MSJ job: the transfer→compute buffer RAW pair (DESIGN.md §16) or
    the profile→transfer salt RAW pair (DESIGN.md §17) — ordered by an
    explicit DAG edge even though the sub-nodes share the base job's
    round."""
    if (
        isinstance(a.job, TransferJob)
        and isinstance(b.job, ComputeJob)
        and bool(a.job.buffer)
        and a.job.buffer == b.job.buffer
        and a.round_idx == b.round_idx
    ):
        return True
    return (
        isinstance(a.job, SkewProfileJob)
        and isinstance(b.job, TransferJob)
        and bool(a.job.salt)
        and a.job.salt == b.job.salt
        and a.round_idx == b.round_idx
    )


def _sub_edge_rels(a: JobNode) -> set[str]:
    """The relation a sanctioned same-round sub-edge is allowed to carry:
    the producer's buffer or salt name, nothing else."""
    if isinstance(a.job, TransferJob):
        return {a.job.buffer}
    if isinstance(a.job, SkewProfileJob):
        return {a.job.salt}
    return set()


_XFER_NAME = re.compile(r"^%xfer\d+$")
_SALT_NAME = re.compile(r"^%salt\d+$")


# --------------------------------------------------------------------------
# the verifier
# --------------------------------------------------------------------------


def verify_plan(
    plan: Plan,
    *,
    schema: Mapping[str, int] | None = None,
    nodes: Sequence[JobNode] | None = None,
    edges: str = "relations",
    canonical: bool = False,
) -> list[Finding]:
    """Verify a plan (and optionally a prebuilt/mutated DAG) statically.

    ``schema`` maps base-relation names to arities (e.g. from
    ``Catalog``); with it, dangling reads are errors and base arities are
    cross-checked.  Without it, base relations are inferred and dangling
    reads downgrade to warnings.  ``nodes`` defaults to
    ``job_dag(plan, edges)``; pass a mutated node tuple to check a DAG
    that did not come from the production builder.  ``canonical=True``
    additionally enforces the service namespace discipline
    (``q<i>``/``v<i>`` names from ``plan_cache.canonicalize``).
    """
    if nodes is None:
        nodes = job_dag(plan, edges)
    findings: list[Finding] = []
    add = findings.append

    # -- per-node derived accesses + node bookkeeping -----------------------
    derived: dict[int, tuple[frozenset[str], frozenset[str]]] = {}
    by_idx: dict[int, JobNode] = {}
    for n in nodes:
        derived[n.idx] = derive_accesses(n.job)
        by_idx[n.idx] = n
        d_reads, d_writes = derived[n.idx]
        if (n.reads, n.writes) != (d_reads, d_writes):
            drift = sorted((n.reads ^ d_reads) | (n.writes ^ d_writes))
            add(Finding(
                "error", "readset-mismatch", n.idx, tuple(drift),
                "node read/write sets disagree with the sets derived from "
                f"the job (drift: {', '.join(drift)})",
            ))

    # -- arity typecheck ----------------------------------------------------
    arity: dict[str, tuple[int, int]] = {}  # rel -> (arity, first job idx)
    if schema:
        arity.update({r: (a, -1) for r, a in schema.items()})
    for n in nodes:
        for rel, ar, role in _atom_uses(n.job):
            seen = arity.get(rel)
            if seen is None:
                arity[rel] = (ar, n.idx)
            elif seen[0] != ar:
                add(Finding(
                    "error", "arity", n.idx, (rel,),
                    f"{role} use of {rel!r} at arity {ar} but job "
                    f"{seen[1]} (or schema) uses arity {seen[0]}",
                ))

    # -- dangling reads / dead writes ---------------------------------------
    written_by: dict[str, list[int]] = {}
    for n in nodes:
        for r in derived[n.idx][1]:
            written_by.setdefault(r, []).append(n.idx)
    read_by: dict[str, list[int]] = {}
    for n in nodes:
        for r in derived[n.idx][0]:
            read_by.setdefault(r, []).append(n.idx)
    for n in nodes:
        for r in sorted(derived[n.idx][0]):
            producers = [
                i for i in written_by.get(r, ())
                if by_idx[i].round_idx < n.round_idx
                # an exchange buffer (or salt table) is produced by a
                # sub-node twin in the SAME round; that is sound only
                # because an explicit dep edge orders the pair, so demand
                # the edge here
                or (
                    (is_xfer_rel(r) or is_salt_rel(r))
                    and i in n.deps
                    and by_idx[i].round_idx == n.round_idx
                )
            ]
            if producers or (schema is not None and r in schema):
                continue
            if schema is None and not written_by.get(r):
                continue  # no schema: a never-written name is assumed base
            sev = "error" if schema is not None else "warning"
            add(Finding(
                sev, "dangling-read", n.idx, (r,),
                f"reads {r!r} but no earlier round writes it and it is "
                "not a base relation",
            ))
    for n in nodes:
        job = n.job
        if isinstance(job, ComputeJob):
            job = job.base  # the compute half materializes the X_i outputs
        if not isinstance(job, MSJJob):
            continue
        for sj in job.sjs:
            consumed_in_job = any(
                q.guard == sj.guard and sj.cond_atom in q.atoms
                for q in job.fused
            )
            consumed_later = any(
                i for i in read_by.get(sj.out, ())
                if by_idx[i].round_idx > n.round_idx
            )
            if not consumed_in_job and not consumed_later:
                add(Finding(
                    "warning", "dead-write", n.idx, (sj.out,),
                    f"equation output {sj.out!r} is never consumed by a "
                    "later job or an in-job fused query",
                ))

    # -- namespace discipline -----------------------------------------------
    for n in nodes:
        job = n.job
        if isinstance(job, TransferJob):
            # the transfer half carries no equations of its own; its one
            # name is the exchange buffer, which must live in the %xfer
            # namespace (the % sigil can never collide with schema names
            # or X<i>@guard|atom-pooled intermediates)
            if job.buffer and not _XFER_NAME.match(job.buffer):
                add(Finding(
                    "error", "namespace", n.idx, (job.buffer,),
                    f"exchange buffer {job.buffer!r} is not "
                    "%xfer<i>-shaped",
                ))
            if job.salt and not _SALT_NAME.match(job.salt):
                add(Finding(
                    "error", "namespace", n.idx, (job.salt,),
                    f"salt table {job.salt!r} is not %salt<i>-shaped",
                ))
            continue
        if isinstance(job, SkewProfileJob):
            # the profile half's one name is the salt table it publishes;
            # the % sigil keeps it clear of schema and pooled names
            if job.salt and not _SALT_NAME.match(job.salt):
                add(Finding(
                    "error", "namespace", n.idx, (job.salt,),
                    f"salt table {job.salt!r} is not %salt<i>-shaped",
                ))
            continue
        if isinstance(job, ComputeJob):
            job = job.base  # equations/names live on the base MSJ job
        sjs = job.sjs if isinstance(job, MSJJob) else ()
        for sj in sjs:
            m = _X_NAME.match(sj.out)
            if m and (m["guard"] != sj.guard.rel or m["atom"] != sj.cond_atom.rel):
                add(Finding(
                    "error", "namespace", n.idx, (sj.out,),
                    f"intermediate name {sj.out!r} disagrees with its "
                    f"equation ({sj.guard.rel!r} |> {sj.cond_atom.rel!r})",
                ))
            elif canonical and not m:
                add(Finding(
                    "error", "namespace", n.idx, (sj.out,),
                    f"canonical plan: equation output {sj.out!r} is not "
                    "X<i>@guard|atom-shaped",
                ))
        if canonical:
            queries: tuple[BSGF, ...] = (
                job.fused if isinstance(job, MSJJob) else job.queries
            )
            for q in queries:
                if not _Q_NAME.match(q.name):
                    add(Finding(
                        "error", "namespace", n.idx, (q.name,),
                        f"canonical plan: query output {q.name!r} is not "
                        "q<i>-shaped",
                    ))
                bad_vars = sorted(
                    v for v in set(q.guard.vars) | {
                        v for a in q.atoms for v in a.vars
                    } if not _V_NAME.match(v)
                )
                if bad_vars:
                    add(Finding(
                        "error", "namespace", n.idx, (q.name,),
                        "canonical plan: non-canonical variables "
                        f"{', '.join(bad_vars)} in {q.name!r}",
                    ))

    # -- DAG shape: backward deps, stratum monotonicity ---------------------
    for n in nodes:
        for d in n.deps:
            if d not in by_idx or d >= n.idx:
                add(Finding(
                    "error", "cycle", n.idx, (),
                    f"dep {d} does not reference an earlier node "
                    "(deps must be acyclic and index-ordered)",
                ))
            elif by_idx[d].round_idx >= n.round_idx and not _sub_edge(
                by_idx[d], n
            ):
                add(Finding(
                    "error", "stratum-monotone", n.idx, (),
                    f"dep edge {d} -> {n.idx} does not cross a round "
                    f"boundary forward ({by_idx[d].round_idx} -> "
                    f"{n.round_idx})",
                ))

    # -- the core obligation: every conflicting pair is edge-covered --------
    closure = dag_closure(nodes)
    for i, j, rels in conflicting_pairs(nodes):
        a, b = by_idx[i], by_idx[j]
        if a.round_idx == b.round_idx:
            # the sanctioned same-round conflicts are the sub-edges of a
            # split MSJ job: the transfer→compute buffer RAW pair and the
            # profile→transfer salt RAW pair — and only when the explicit
            # edge actually covers the pair (a mutated DAG with that edge
            # deleted must fail here)
            if (
                _sub_edge(a, b)
                and rels <= _sub_edge_rels(a)
                and i in closure.get(j, frozenset())
            ):
                continue
            add(Finding(
                "error", "same-round-conflict", j, tuple(sorted(rels)),
                f"jobs {i} and {j} of round {a.round_idx} conflict on "
                f"{', '.join(sorted(rels))} — the IR contract says "
                "same-round jobs are independent",
            ))
        elif i not in closure.get(j, frozenset()):
            add(Finding(
                "error", "uncovered-conflict", j, tuple(sorted(rels)),
                f"jobs {i} and {j} conflict on {', '.join(sorted(rels))} "
                "but no dependency path covers the pair — the ready "
                "queue may race them",
            ))
    return findings


def verify_nodes(nodes: Sequence[JobNode]) -> list[Finding]:
    """Edge-cover + shape checks on a bare node tuple (no Plan needed).

    Used by the sanitizer's static pre-pass and the mutation test suite,
    where the DAG under test did not come from ``job_dag``."""
    findings: list[Finding] = []
    by_idx = {n.idx: n for n in nodes}
    for n in nodes:
        for d in n.deps:
            if d not in by_idx or d >= n.idx:
                findings.append(Finding(
                    "error", "cycle", n.idx, (),
                    f"dep {d} does not reference an earlier node",
                ))
    closure = dag_closure(nodes)
    for i, j, rels in conflicting_pairs(nodes):
        if i not in closure.get(j, frozenset()):
            findings.append(Finding(
                "error", "uncovered-conflict", j, tuple(sorted(rels)),
                f"jobs {i} and {j} conflict on {', '.join(sorted(rels))} "
                "with no covering path",
            ))
    return findings
