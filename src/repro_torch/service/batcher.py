"""Admission batcher + SGF query service.

Mirrors the slot discipline of the decode batcher (serve/batcher.py) at
the query layer: requests queue up, each *tick* drains up to
``max_admit`` of them and fuses the admitted queries into **one**
multi-tenant plan.  Fusion is where the paper's multi-query machinery
pays off across tenants:

* admitted queries are alpha-renamed into a canonical namespace
  (``q0, q1, ...``) and *deduplicated* on their canonical form — two
  tenants submitting the structurally-same query evaluate it once;
* the canonical batch is planned as one SGF with GREEDY-SGF /
  GREEDY-BSGF, so the stratum-level semi-join pooling merges shared
  (guard, atom) pairs across tenants into single MSJ equations and all
  same-stratum Boolean evaluations share one EVAL job;
* per-request outputs are scattered back by request id from the fused
  environment.

Plans are cached by canonical fingerprint (plan_cache.py); materialized
results and EVAL inputs are cached across ticks (result_cache.py) keyed
by per-relation catalog epochs, so each tick partitions its fused batch
into *warm* queries (served by scatter — zero jobs, zero shuffled bytes)
and *cold* queries (planned and executed, results inserted on
completion).  Execution runs on the ready-queue executor under W cluster
slots (scheduler.py estimates, core/executor.py dispatches — a job
launches as soon as its predecessors complete and a slot frees, with a
per-job probe-backend decision) over catalog-resident relations
(catalog.py).  DESIGN.md §9–§11.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.core.algebra import BSGF, SGF
from repro_torch.core.costmodel import CostConstants, HADOOP, Stats
from repro_torch.core.executor import Executor, ExecutorConfig, Report
from repro_torch.core.planner import (
    MSJJob,
    Plan,
    Round,
    _register_stratum_outputs,
    annotate_skew,
    concat_plans,
    job_dag,
    levels_of,
    plan_greedy,
)
from repro_torch.core.relation import Relation
from repro_torch.engine.comm import Comm, SimComm
from repro_torch.obs.metrics import MetricRegistry, counter_attr
from repro_torch.service.catalog import Catalog, query_deps
from repro_torch.service.plan_cache import PlanCache, canonical_query_key, canonicalize
from repro_torch.service.result_cache import ResultCache, xmat_content_key
from repro_torch.service.scheduler import SlotScheduler


@dataclass
class QueryRequest:
    """One tenant's submission: an ordered batch of BSGF queries (an SGF
    body); outputs are filled in under the tenant's own names.

    Failure-domain fields (DESIGN.md §13): a request whose outputs land
    in a tick's taint closure is *failed for that tick only* — ``failures``
    counts those events, ``retry_after`` is the absolute tick number at
    which the service re-admits it (exponential backoff), and ``failed``
    marks terminal abandonment (its tenant entered quarantine).
    """

    rid: int
    queries: tuple[BSGF, ...]
    outputs: dict[str, Relation] = field(default_factory=dict)
    done: bool = False
    tenant: int = 0
    failures: int = 0
    retry_after: int = -1  # absolute tick eligible for re-admission; -1 = n/a
    failed: bool = False  # terminal: budget exhausted, tenant quarantined
    error: str = ""  # last failure description (empty while clean)


@dataclass(frozen=True)
class FusedBatch:
    """The admitted requests of one tick, fused into a canonical batch."""

    requests: tuple[QueryRequest, ...]
    queries: tuple[BSGF, ...]  # canonical, deduplicated across requests
    out_map: dict[tuple[int, str], str]  # (rid, tenant name) -> canonical name

    @property
    def n_submitted(self) -> int:
        return sum(len(r.queries) for r in self.requests)

    @property
    def n_deduped(self) -> int:
        return self.n_submitted - len(self.queries)


def fuse_requests(requests: Sequence[QueryRequest]) -> FusedBatch:
    """Canonicalize and dedup the queries of the admitted requests.

    Queries are processed in admission order; each query's canonical key
    (plan_cache.canonical_query_key, with references to the *same
    request's* earlier outputs following the rename) either joins an
    existing canonical query or appends a new one.  Cross-request
    dependencies are not allowed — tenants only see catalog relations and
    their own intermediate outputs.
    """
    seen: dict[tuple, str] = {}
    queries: list[BSGF] = []
    out_map: dict[tuple[int, str], str] = {}
    for req in requests:
        local: dict[str, str] = {}  # this request's name -> canonical name
        for q in req.queries:
            key = canonical_query_key(q, local)
            name = seen.get(key)
            if name is None:
                name = f"q{len(queries)}"
                seen[key] = name
                queries.append(BSGF(name, key[0], key[1], key[2]))
            local[q.name] = name
            out_map[(req.rid, q.name)] = name
    return FusedBatch(tuple(requests), tuple(queries), out_map)


class QuarantinedError(RuntimeError):
    """Submission rejected: the tenant is quarantined after exhausting its
    retry budget (DESIGN.md §13).  Carries the re-admission tick."""

    def __init__(self, tenant: int, until: int):
        super().__init__(f"tenant {tenant} quarantined until tick {until}")
        self.tenant = tenant
        self.until = until


class PlanVerificationError(RuntimeError):
    """A fused plan failed the pre-execution static verifier (DESIGN.md
    §15): it types wrong, reads something nothing produces, or leaves a
    conflicting job pair uncovered by the DAG.  Raised before the plan
    reaches the scheduler; ``findings`` carries the diagnostics."""

    def __init__(self, findings):
        self.findings = list(findings)
        lines = "\n".join(f"  {f}" for f in self.findings)
        super().__init__(
            f"plan verifier: {len(self.findings)} error finding(s)\n{lines}"
        )


@dataclass(frozen=True)
class RetryPolicy:
    """Per-request retry budget + tenant quarantine policy (DESIGN.md §13).

    A request failed by a tick (its outputs taint-reachable) is retried
    with exponential backoff: re-admission at
    ``tick + backoff_base * 2**(failures-1)`` ticks.  After
    ``max_failures`` failures the request is abandoned and its tenant
    quarantined for ``quarantine_ticks * 2**(strikes-1)`` ticks; on
    re-admission the tenant's strike count decays by ``strike_decay``
    (a long-clean tenant earns its way back to short quarantines).
    """

    max_failures: int = 3
    backoff_base: int = 1
    quarantine_ticks: int = 8
    strike_decay: float = 0.5

    def backoff(self, failures: int) -> int:
        return self.backoff_base * 2 ** max(failures - 1, 0)

    def quarantine(self, strikes: float) -> int:
        return self.quarantine_ticks * 2 ** max(int(strikes) - 1, 0)


class AdmissionBatcher:
    """FIFO request queue drained ``max_admit`` requests per tick.

    ``submit`` rejects a rid already queued (double-submission of the same
    request object would double-scatter its outputs); ``requeue`` is the
    idempotent re-admission path — a failed tick putting its batch back
    and a backoff expiry re-admitting the same request must not collide
    into a duplicate (the satellite-6 regression)."""

    def __init__(self, *, max_admit: int = 16):
        self.max_admit = max_admit
        self.queue: list[QueryRequest] = []

    def submit(self, req: QueryRequest) -> None:
        if any(r.rid == req.rid for r in self.queue):
            raise ValueError(f"request {req.rid} is already queued")
        self.queue.append(req)

    def requeue(self, reqs: Sequence[QueryRequest], *, front: bool = False) -> None:
        """Re-admit ``reqs``, silently skipping any already queued."""
        queued = {r.rid for r in self.queue}
        fresh = [r for r in reqs if r.rid not in queued]
        if front:
            self.queue[:0] = fresh
        else:
            self.queue.extend(fresh)

    def drain(self) -> list[QueryRequest]:
        admitted, self.queue = self.queue[: self.max_admit], self.queue[self.max_admit :]
        return admitted

    def __len__(self) -> int:
        return len(self.queue)


class SGFService:
    """The query service: catalog + plan cache + batcher + slot scheduler.

    ::

        svc = SGFService(catalog, slots=4)
        req = svc.submit([query])          # enqueue, returns the request
        svc.tick()                         # drain, fuse, plan/cache, run
        req.outputs["Z"]                   # tenant-named Relation

    ``slots=None`` models unbounded cluster slots (W=∞): scheduler waves
    then coincide with plan rounds and net-time accounting matches the
    barrier executor exactly.
    """

    #: service-level counters, registry-backed (DESIGN.md §14) — the
    #: attribute API (``svc.quarantines``, ``svc.warm_served += n``) is
    #: unchanged; the same numbers are also reachable as ``svc.tick.*`` /
    #: ``svc.req.*`` / ``svc.tenant.*`` metrics in ``self.metrics``.
    warm_served = counter_attr("svc.tick.warm_queries")
    cold_executed = counter_attr("svc.tick.cold_queries")
    failed_requests = counter_attr("svc.req.failed")
    retries_scheduled = counter_attr("svc.req.retries")
    quarantines = counter_attr("svc.tenant.quarantines")
    #: pre-execution plan-verifier findings (repro_torch.analysis, DESIGN.md
    #: §15): every finding on a fused plan about to execute counts here;
    #: error-severity findings additionally abort the tick.
    verify_findings = counter_attr("svc.verify.findings")

    def __init__(
        self,
        catalog: Catalog,
        *,
        comm: Comm | None = None,
        config: ExecutorConfig | None = None,
        slots: int | None = None,
        max_admit: int = 16,
        consts: CostConstants = HADOOP,
        model: str = "gumbo",
        cache_capacity: int = 128,
        result_cache_capacity: int = 256,
        retry_policy: RetryPolicy | None = None,
        tracer=None,
        metrics: MetricRegistry | None = None,
    ):
        self.catalog = catalog
        self.comm = comm or SimComm(catalog.P)
        self.config = config or ExecutorConfig()
        self.slots = slots
        self.consts = consts
        self.model = model
        #: one registry for the whole service: plan/result cache, per-tick
        #: service counters, and every per-tick Executor publish into it
        #: (DESIGN.md §14); pass your own to aggregate across services.
        self.metrics = metrics if metrics is not None else MetricRegistry()
        #: phase-span tracer threaded into each tick's Executor; None (the
        #: default) keeps execution byte-identical to the untraced service.
        self.tracer = tracer
        self.batcher = AdmissionBatcher(max_admit=max_admit)
        self.cache = PlanCache(capacity=cache_capacity, metrics=self.metrics)
        #: cross-tick result/X_i materializations; capacity 0 disables
        #: (every tick then executes fully cold, the pre-cache behaviour)
        self.results = ResultCache(
            capacity=result_cache_capacity, metrics=self.metrics
        )
        self.retry_policy = retry_policy or RetryPolicy()
        self.reports: list[Report] = []
        self.last_report: Report | None = None
        self.last_batch: FusedBatch | None = None
        self.last_tick: dict = {}
        self._next_rid = 0
        #: failure-domain state (DESIGN.md §13)
        self.tick_no = 0
        self.delayed: list[QueryRequest] = []  # backing off, by retry_after
        self.quarantine_until: dict[int, int] = {}  # tenant -> tick
        self.strikes: dict[int, float] = {}  # tenant -> decayed strike count
        #: fault-injection seam for chaos tests/benchmarks: forwarded to the
        #: executor's ready-queue walk each tick; injectors needing the live
        #: environment (ShardLoss) reach it via ``self._executor.env``.
        self.on_job = None
        self.max_restarts = 0
        self._executor: Executor | None = None

    # -- admission ---------------------------------------------------------
    def submit(
        self, queries: Sequence[BSGF] | SGF | BSGF, *, tenant: int = 0
    ) -> QueryRequest:
        self._check_quarantine(tenant)
        if isinstance(queries, BSGF):
            queries = [queries]
        elif isinstance(queries, SGF):
            queries = list(queries.queries)
        else:
            queries = list(queries)
        names = [q.name for q in queries]
        if len(set(names)) != len(names):
            # fusion alpha-renames before SGF's own duplicate check could
            # run; catch it here or the earlier duplicate silently loses
            raise ValueError(f"duplicate output names in request: {names}")
        self.catalog.validate(queries)
        req = QueryRequest(self._next_rid, tuple(queries), tenant=tenant)
        self._next_rid += 1
        self.batcher.submit(req)
        return req

    def _check_quarantine(self, tenant: int) -> None:
        """Gate admission on quarantine; expiry is the *decayed
        re-admission* point — the tenant's strike count halves (by
        ``strike_decay``), so repeat offenders face exponentially longer
        quarantines while a reformed tenant works back to the base."""
        until = self.quarantine_until.get(tenant)
        if until is None:
            return
        if self.tick_no < until:
            raise QuarantinedError(tenant, until)
        del self.quarantine_until[tenant]
        self.strikes[tenant] = self.strikes.get(tenant, 0.0) * self.retry_policy.strike_decay

    # -- one service tick --------------------------------------------------
    def _plan_batch(self, queries: Sequence[BSGF], stats: Stats) -> Plan:
        """Level-layered strata + GREEDY-BSGF grouping within each stratum.

        Unlike GREEDY-SGF's overlap heuristic (which serializes
        non-overlapping tenants into separate strata), dependency-level
        layering always co-schedules independent tenants, so their Boolean
        evaluations share one EVAL job and their semi-joins enter one
        grouping pool — the cross-tenant sharing the service exists for.

        ``stats`` is mutated (stratum output estimates feed forward);
        callers pass a private copy.
        """
        plans = []
        for stratum in levels_of(SGF(list(queries))):
            plans.append(plan_greedy(stratum, stats, self.consts, model=self.model))
            _register_stratum_outputs(stratum, stats)
        return concat_plans(plans)

    def _closures(self, batch: FusedBatch) -> dict[str, tuple[tuple, frozenset]]:
        """Per canonical query: its self-contained cache identity.

        The *closure* of a query is the query plus its transitive
        intra-batch dependencies, re-canonicalized as a standalone batch —
        a content key independent of where the query landed in this tick's
        fused namespace.  Alongside it the closure's base-relation deps,
        from which the per-relation epoch key is built.
        """
        canon = list(batch.queries)
        names = {q.name for q in canon}
        trans: dict[str, set[str]] = {}
        meta: dict[str, tuple[tuple, frozenset]] = {}
        for q in canon:
            t: set[str] = set()
            for r in q.relations:
                if r in names:  # refs point at earlier batch outputs only
                    t |= trans[r] | {r}
            trans[q.name] = t
            closure = [p for p in canon if p.name in t] + [q]
            blob = tuple(repr(cq) for cq in canonicalize(closure)[0])
            meta[q.name] = (blob, query_deps(closure))
        return meta

    @staticmethod
    def _xmat_deps(sj, local_names: set[str]) -> frozenset | None:
        """Dep set of one semi-join materialization, or None when it has no
        catalog-stable cache key (tick-relative guard/atom relation).  The
        single source of the eligibility rule — lookup (:meth:`_trim_plan`)
        and insertion (:meth:`_insert_results`) must agree on it."""
        if sj.guard.rel in local_names or sj.cond_atom.rel in local_names:
            return None
        return frozenset((sj.guard.rel, sj.cond_atom.rel))

    def _trim_plan(
        self, plan: Plan, local_names: set[str]
    ) -> tuple[Plan, dict[str, Relation]]:
        """Serve warm X_i materializations: drop each MSJ equation whose
        materialization is cached for the current dep epochs, returning the
        trimmed plan plus the ``X name -> Relation`` injections.

        Only non-fused jobs over catalog relations are eligible — fused
        jobs apply their Boolean formula on the in-job route-back bitmap,
        and ``local_names`` (canonical intermediates) are tick-relative, so
        neither has a catalog-stable content key.
        """
        injected: dict[str, Relation] = {}
        rounds: list[Round] = []
        for rnd in plan.rounds:
            jobs: list = []
            for job in rnd.jobs:
                if not isinstance(job, MSJJob) or job.fused:
                    jobs.append(job)
                    continue
                keep = []
                for sj in job.sjs:
                    deps = self._xmat_deps(sj, local_names)
                    rel = None
                    if deps is not None:
                        rel = self.results.get(
                            "xmat", xmat_content_key(sj), self.catalog.dep_epochs(deps)
                        )
                    if rel is None:
                        keep.append(sj)
                    else:
                        injected[sj.out] = rel.rename(sj.out)
                if len(keep) == len(job.sjs):
                    jobs.append(job)
                elif keep:
                    jobs.append(MSJJob(tuple(keep)))
            if jobs:
                rounds.append(Round(tuple(jobs)))
        return Plan(tuple(rounds)), injected

    def _insert_results(
        self,
        plan: Plan,
        cold: Sequence[BSGF],
        meta: dict,
        local_names: set[str],
        env: dict,
        tainted: frozenset[str] = frozenset(),
    ) -> None:
        """Populate the result cache from a completed cold execution.

        The *partial commit* rule (DESIGN.md §13): a materialization in the
        tick's taint closure (``tainted`` — every relation a failed or
        tainted job should have written) is withheld — its bytes are either
        absent from ``env`` or stale, and a warm hit would replay the
        poison into later ticks."""
        for rnd in plan.rounds:
            for job in rnd.jobs:
                if not isinstance(job, MSJJob) or job.fused:
                    continue
                for sj in job.sjs:
                    deps = self._xmat_deps(sj, local_names)
                    if deps is None:
                        continue
                    if sj.out in tainted or sj.out not in env:
                        self.results.partial_skipped += 1
                        continue
                    self.results.put(
                        "xmat",
                        xmat_content_key(sj),
                        self.catalog.dep_epochs(deps),
                        env[sj.out],
                        deps,
                    )
        for q in cold:
            if q.name in tainted or q.name not in env:
                self.results.partial_skipped += 1
                continue
            blob, deps = meta[q.name]
            self.results.put(
                "query", blob, self.catalog.dep_epochs(deps), env[q.name], deps
            )

    def _run_batch(self, batch: FusedBatch) -> tuple[dict, Report]:
        """Warm/cold partition + cold execution of one fused batch.

        Warm canonical queries are served straight from the result cache
        (zero jobs, zero shuffled bytes — they never reach the scheduler);
        the cold remainder is planned (plan cache, keyed by the per-relation
        epochs of its transitive base deps), trimmed of warm X_i
        materializations, executed on the W-slot scheduler, and inserted
        into the cache for later ticks.
        """
        canon = list(batch.queries)
        meta = self._closures(batch)
        # sweep entries orphaned by catalog mutations (they can never hit
        # again but would pin their arrays until LRU pressure)
        self.results.evict_stale(self.catalog.rel_epochs)
        warm: dict[str, Relation] = {}
        cold: list[BSGF] = []
        for q in canon:
            blob, deps = meta[q.name]
            rel = self.results.get("query", blob, self.catalog.dep_epochs(deps))
            if rel is None:
                cold.append(q)
            else:
                warm[q.name] = rel.rename(q.name)
        self.last_tick = info = {
            "canonical_queries": len(canon),
            "warm_queries": len(warm),
            "cold_queries": len(cold),
            "x_injected": 0,
        }
        if not cold:
            return dict(warm), Report()

        # plan the cold sub-batch; warm outputs it reads act as base
        # relations with exact statistics (their rows are resident)
        cold_deps = frozenset().union(*(meta[q.name][1] for q in cold))
        warm_read = {r for q in cold for r in q.relations} & set(warm)
        stats = copy.deepcopy(self.catalog.stats())
        for name in warm_read:
            stats.register_output(name, float(warm[name].count()), warm[name].arity)
        # the epoch key also pins *which queries* occupy the warm slots the
        # cold batch reads (their closure blobs): an identical-looking cold
        # batch fed by a differently-defined warm upstream must not reuse a
        # plan costed with the old upstream's cardinality.  It also pins
        # the skew decision (DESIGN.md §17): the defense annotates the
        # trimmed plan per tick from hitter evidence, so a config/sketch
        # flip must not serve a plan whose annotation era differs
        epoch_key = (
            self.catalog.dep_epochs(cold_deps),
            tuple(sorted((n, meta[n][0]) for n in warm_read)),
            ("skew", self.config.skew_defense, self.catalog.heavy_hitters),
        )
        plan, _hit = self.cache.get_or_plan(
            cold,
            epoch_key,
            lambda: self._plan_batch(cold, copy.deepcopy(stats)),
            canonical=True,
        )

        local_names = set(warm) | {q.name for q in cold}
        plan, injected = self._trim_plan(plan, local_names)
        info["x_injected"] = len(injected)
        if self.config.skew_defense:
            # annotate AFTER trimming — _trim_plan rebuilds MSJ jobs from
            # their surviving equations, which would drop any earlier
            # annotation; the evidence is the catalog's heavy-hitter
            # sketch (Catalog(heavy_hitters=k)), absent which no job ever
            # qualifies and the defense is a structural no-op
            plan = annotate_skew(
                plan, stats, self.catalog.P, packing=self.config.packing
            )
            info["skew_defended"] = sum(
                1 for rnd in plan.rounds for job in rnd.jobs
                if isinstance(job, MSJJob) and job.skew is not None
            )
        self._verify_plan(plan, warm, injected)
        # injected X relations must be visible to the scheduler's LPT cost
        # estimates; ``stats`` is tick-private (the planner lambda took its
        # own copy) and the scheduler copies again before mutating
        for name, rel in injected.items():
            stats.register_output(name, float(rel.count()), rel.arity)
        # stats also feed the executor's per-job "auto" backend decision
        # lineage = the catalog's durable relations only: warm/injected
        # entries are cache-resident copies whose loss is indistinguishable
        # from a cold miss, but base-relation shards re-materialize from
        # the catalog rows bit-identically (DESIGN.md §13)
        ex = Executor(
            {**self.catalog.db(), **warm, **injected}, self.comm, self.config,
            stats=stats, lineage=self.catalog.db(),
            tracer=self.tracer, metrics=self.metrics,
        )
        self._executor = ex  # chaos injectors reach the live env here
        sched = SlotScheduler(
            ex,
            slots=self.slots,
            stats=stats,
            consts=self.consts,
            model=self.model,
        )
        try:
            env, report = sched.execute(
                plan, on_job=self.on_job, max_restarts=self.max_restarts
            )
        finally:
            self._executor = None
        tainted = report.tainted_relations()
        self._insert_results(plan, cold, meta, local_names, env, tainted)
        return env, report

    def _verify_plan(self, plan: Plan, warm: dict, injected: dict) -> None:
        """Statically verify a fused plan immediately before execution
        (repro_torch.analysis, DESIGN.md §15): the schema is the catalog plus
        this tick's warm/injected materializations, so dangling reads and
        arity drift are errors, and every conflicting job pair must be
        covered by a DAG edge under the executor's edge mode.  All
        findings count into ``svc.verify.findings``; error-severity
        findings abort the tick (a racy or ill-typed plan must not reach
        the scheduler — the tick's requests then retry with backoff)."""
        from repro_torch.analysis import errors as _errors, verify_plan

        schema = {n: r.arity for n, r in self.catalog.db().items()}
        schema.update({n: r.arity for n, r in warm.items()})
        schema.update({n: r.arity for n, r in injected.items()})
        # verify the DAG shape that will actually execute: overlap and the
        # skew defense add sub-nodes with their own sanctioned same-round
        # RAW edges, which must be covered in the executed node set
        nodes = job_dag(
            plan,
            self.config.dag_edges,
            overlap=self.config.overlap,
            skew=self.config.skew_defense,
        )
        findings = verify_plan(
            plan, schema=schema, nodes=nodes, edges=self.config.dag_edges,
            canonical=True,
        )
        self.verify_findings += len(findings)
        errs = _errors(findings)
        if errs:
            raise PlanVerificationError(errs)

    def _readmit_delayed(self) -> None:
        """Move backing-off requests whose ``retry_after`` has arrived back
        into the admission queue; a quarantined tenant's requests stay
        delayed until the quarantine lifts (their clock is pushed out)."""
        still: list[QueryRequest] = []
        for req in self.delayed:
            until = self.quarantine_until.get(req.tenant)
            if until is not None and self.tick_no < until:
                req.retry_after = max(req.retry_after, until)
                still.append(req)
            elif self.tick_no >= req.retry_after:
                self.batcher.requeue([req])
            else:
                still.append(req)
        self.delayed = still

    def _fail_request(self, req: QueryRequest, poisoned: Sequence[str]) -> None:
        """One request's outputs were taint-reachable this tick: charge its
        retry budget; schedule backoff re-admission or — budget exhausted —
        abandon it and quarantine its tenant (DESIGN.md §13)."""
        pol = self.retry_policy
        req.failures += 1
        req.error = f"tick {self.tick_no}: tainted outputs {list(poisoned)}"
        self.failed_requests += 1
        if req.failures >= pol.max_failures:
            strikes = self.strikes.get(req.tenant, 0.0) + 1.0
            self.strikes[req.tenant] = strikes
            self.quarantine_until[req.tenant] = self.tick_no + pol.quarantine(strikes)
            self.quarantines += 1
            req.failed = True
            req.retry_after = -1
        else:
            req.retry_after = self.tick_no + pol.backoff(req.failures)
            self.delayed.append(req)
            self.retries_scheduled += 1

    def tick(self) -> list[QueryRequest]:
        """Drain the queue, run one fused job wave-set, scatter outputs.

        Commits *partially* (DESIGN.md §13): requests whose outputs fall in
        the tick's taint closure are failed — charged against their retry
        budget via :meth:`_fail_request` — while every other co-admitted
        request is served and cached exactly as a clean tick would.

        Returns the completed requests (empty list if the queue was empty;
        failed requests are excluded — they carry ``failures``/``error``).
        """
        self.tick_no += 1
        self._readmit_delayed()
        admitted = self.batcher.drain()
        if not admitted:
            return []
        prev_tick = self.last_tick
        try:
            batch = fuse_requests(admitted)
            env, report = self._run_batch(batch)
        except Exception:
            # don't lose co-admitted tenants to one failing tick (e.g. a
            # CapacityFault after max retries under fail_policy="abort"):
            # put the batch back in FIFO order so a caller can retry or
            # re-admit after fixing capacity; last_tick must keep
            # describing the last *successful* tick, like
            # last_report/last_batch.  requeue (not a raw splice) so a
            # request that also sits in the delayed queue can't collide
            # into a duplicate
            self.last_tick = prev_tick
            self.batcher.requeue(admitted, front=True)
            raise
        poisoned = report.tainted_relations() & {q.name for q in batch.queries}
        completed: list[QueryRequest] = []
        for req in batch.requests:
            mine = {batch.out_map[(req.rid, q.name)] for q in req.queries}
            hit = sorted(mine & poisoned)
            if hit:
                self._fail_request(req, hit)
                continue
            for q in req.queries:
                cname = batch.out_map[(req.rid, q.name)]
                req.outputs[q.name] = env[cname].rename(q.name)
            req.done = True
            completed.append(req)
        self.last_tick["poisoned_queries"] = len(poisoned)
        self.last_tick["failed_requests"] = len(batch.requests) - len(completed)
        self.warm_served += self.last_tick.get("warm_queries", 0)
        self.cold_executed += self.last_tick.get("cold_queries", 0)
        # per-request tick latency: every request admitted this tick waited
        # out the tick's net (critical-path) time, warm hits included
        lat = self._net_time(report)
        hist = self.metrics.histogram("svc.tick.latency")
        for _ in batch.requests:
            hist.observe(lat)
        self.reports.append(report)
        self.last_report = report
        self.last_batch = batch
        return completed

    def run(self) -> None:
        """Tick until the queue is empty."""
        while len(self.batcher):
            self.tick()

    # -- introspection -----------------------------------------------------
    def _net_time(self, report: Report) -> float:
        """Net time of one tick: prefer the event timeline the executor
        actually recorded (an LPT re-derivation from per-round walls can
        disagree with the real schedule); fall back to the modeled
        makespan only for records without event info."""
        makespan = report.event_makespan()
        if makespan is None:
            return report.net_time_under_slots(self.slots)
        return makespan

    def counters(self) -> dict:
        c = self.cache.counters()
        rc = self.results.counters()
        c["result_size"] = rc.pop("size")
        c.update(rc)
        c["warm_queries"] = self.warm_served
        c["cold_queries"] = self.cold_executed
        c["ticks"] = len(self.reports)
        c["failed_requests"] = self.failed_requests
        c["retries_scheduled"] = self.retries_scheduled
        c["quarantines"] = self.quarantines
        c["delayed"] = len(self.delayed)
        c["quarantined_tenants"] = len(self.quarantine_until)
        c["jobs"] = sum(r.n_jobs for r in self.reports)
        c["bytes_shuffled"] = sum(r.bytes_shuffled() for r in self.reports)
        c["net_time"] = sum(self._net_time(r) for r in self.reports)
        c["total_time"] = sum(r.total_time for r in self.reports)
        lat = self.metrics.histogram("svc.tick.latency")
        c["tick_latency_p50"] = lat.percentile(0.50)
        c["tick_latency_p95"] = lat.percentile(0.95)
        c["tick_latency_p99"] = lat.percentile(0.99)
        return c
