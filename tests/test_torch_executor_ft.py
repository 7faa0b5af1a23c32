"""Port differential: the executor's fault-tolerant scheduling.

The reference's own scenarios (``tests/test_speculation.py``,
``test_failure_domains.py``, ``test_async_executor.py``,
``test_job_dag.py``) run through both packages on the same numpy data:
speculative re-dispatch (a clone that wins, a clone that loses, a clone
that dies, the shared retry state relaxed once, the supervisor's
speculation), injected-failure rerouting, ``fail_policy="isolate"`` with
its taint closure, ``shrink_on_shard_loss``, ``execution_mode="waves"``
against the async walk, and ``dag_edges="strata"`` against
``"relations"``.  Each scenario is one function of a package namespace
(``REF`` or ``PORT``), so both packages run the same body.  The reference
runs its ``"sorted"`` backend, the port its ``"kernel"`` backend (the
plain versions on the CPU).

**The clock.**  The walls drive speculation, the dispatch order and every
start and end, so they are made deterministic first: both executor
modules' ``time`` attribute is replaced by one :class:`Clock`, whose
``perf_counter()`` moves only inside the ``on_job`` hook, by a whole
number of seconds per job and attempt.  Every wall, start and end is then
an integer, and a sum of them is exact whether it is folded left to right
(the port's ``Report``) or compensated (the reference's builtin ``sum()``
on Python >= 3.12).  Both executors read the clock at the same places
(``_attempt``, and the failure path of the async walk); nothing else on
these paths reads it.  The reference scenarios' warm-up runs made real
walls uniform for its calibration; under this clock they are moot and
are left out.

Under the clock, held exactly: every output relation's ``data`` and
``valid``; each ``JobRecord``'s job, round, slot, start, end, wall,
attempt, attempts, speculative and cancelled flags, outcome and integer
stats (the backend name differs by design); the dispatch log; the
report's speculative count, failed jobs and tainted relations;
``Executor.ft_counters``; and the outputs against the set oracle
``ref_engine``.  No tolerance: every value is an int32, a bool, a count
or an integer second.

The reference compiles on the CPU (its pipeline stages whole, by
``jit_stages`` of ``tests/test_torch_msj.py``; its host-side operations
each per shape), so every scenario runs at 64 rows per relation at P = 2
(the reference's own tests use 32, 64, 96 and 128 rows) with static
forward capacities
(``count_sized=False``: one capacity per relation shape, not one per job;
``tests/test_torch_executor.py`` holds the count-sized shuffle), a
scenario that several tests read is one module-scoped fixture, and the
fault-free A4 run is shared.
"""
import itertools
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.executor as jex  # noqa: E402
import repro.service.scheduler as jscheduler  # noqa: E402
from repro import service as jservice  # noqa: E402
from repro.core import algebra as jalgebra, costmodel as jcost, planner as jplan  # noqa: E402
from repro.core import queries as JQ  # noqa: E402
from repro.core.relation import db_from_dict as jdb_from_dict  # noqa: E402
from repro.engine.comm import SimComm as JSimComm  # noqa: E402
from repro.ft import elastic as jelastic, supervisor as jsupervisor  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
import repro_torch.service.scheduler as tscheduler  # noqa: E402
from repro_torch import service as tservice  # noqa: E402
from repro_torch.core import algebra, costmodel, planner, queries, ref_engine  # noqa: E402
from repro_torch.core.relation import Relation, db_from_dict  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402
from repro_torch.ft import elastic, supervisor  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401
from test_torch_msj import jit_stages  # noqa: E402, F401

pytestmark = pytest.mark.usefixtures("jit_stages")

P = 2
N = 64
XYZW = ("x", "y", "z", "w")

REF = SimpleNamespace(
    name="repro", ex=jex, alg=jalgebra, cost=jcost, plan=jplan, Q=JQ, elastic=jelastic,
    sup=jsupervisor, svc=jservice, sched=jscheduler, Comm=JSimComm, backend="sorted",
    db=lambda db_np, P: jdb_from_dict(db_np, P=P),
    catalog=lambda db_np, P: jservice.catalog_from_numpy(db_np, P=P),
)
PORT = SimpleNamespace(
    name="repro_torch", ex=tex, alg=algebra, cost=costmodel, plan=planner, Q=queries,
    elastic=elastic, sup=supervisor, svc=tservice, sched=tscheduler, Comm=SimComm,
    backend="kernel",
    db=lambda db_np, P: db_from_dict(db_np, P=P, device="cpu"),
    catalog=lambda db_np, P: tservice.catalog_from_numpy(db_np, P=P, device="cpu"),
)


def cfg(pkg, **kw):
    """The package's config: its backend, and static forward capacities
    (``count_sized=False``), so the reference compiles one capacity per
    relation shape and not one per job."""
    return pkg.ex.ExecutorConfig(probe_backend=pkg.backend, count_sized=False, **kw)


# --------------------------------------------------------------------------
# the injected clock
# --------------------------------------------------------------------------


def one_second(job, attempt) -> int:
    return 1


def by_job(job, attempt) -> int:
    """1-3 s by the job's repr (equal in both packages), so the async walk's
    choices depend on the walls."""
    return 1 + zlib.crc32(repr(job).encode()) % 3


class Clock:
    """``perf_counter()`` that moves only when an ``on_job`` hook ticks it,
    by ``step(job, attempt)`` whole seconds."""

    def __init__(self, step=one_second):
        self.t, self.step = 0, step

    def perf_counter(self) -> float:
        return float(self.t)

    def hook(self, inject=None):
        def on_job(job, attempt):
            self.t += self.step(job, attempt)
            if inject is not None:
                inject(job, attempt)

        return on_job


def both(scenario, step=one_second, **kw):
    """``scenario(pkg, clock, **kw)`` through the reference, then the port,
    each with its executor module reading a fresh :class:`Clock`."""
    out = []
    for pkg in (REF, PORT):
        clock = Clock(step)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pkg.ex, "time", clock)
            out.append(scenario(pkg, clock, **kw))
    return tuple(out)


# --------------------------------------------------------------------------
# what is compared
# --------------------------------------------------------------------------


def relations(env) -> dict:
    return {k: v for k, v in env.items() if hasattr(v, "valid") and hasattr(v, "data")}


def arrays(rel) -> tuple:
    if isinstance(rel, Relation):
        return rel.data.numpy(), rel.valid.numpy()
    return np.asarray(rel.data), np.asarray(rel.valid)


def assert_same_env(jenv, tenv):
    j, t = relations(jenv), relations(tenv)
    assert sorted(j) == sorted(t)
    for k in j:
        (jd, jv), (td, tv) = arrays(j[k]), arrays(t[k])
        np.testing.assert_array_equal(jd, td, err_msg=k)
        np.testing.assert_array_equal(jv, tv, err_msg=k)


def records(rep) -> list:
    return [(repr(r.job), r.round_idx, r.slot, r.start, r.end, r.wall, r.attempt, r.attempts,
             r.speculative, r.cancelled, r.outcome, r.stats) for r in rep.records]


def schedule(log) -> list:
    return [(s.idx, s.round_idx, s.slot, s.start, s.end, s.attempt, s.est_cost) for s in log]


def assert_same_report(jrep, trep):
    assert records(jrep) == records(trep)
    for r in trep.records:
        # a whole number of seconds, unless cut at the winner's end
        assert r.cancelled or float(r.wall).is_integer()
        assert r.backend in ("", "none", "kernel")
    assert jrep.n_speculative == trep.n_speculative
    assert [repr(r.job) for r in jrep.failed_jobs] == [repr(r.job) for r in trep.failed_jobs]
    assert jrep.tainted_relations() == trep.tainted_relations()
    for rep in (jrep, trep):
        assert rep.net_time_by_events(None) == rep.net_time
        assert rep.net_time_by_events(1) == rep.total_time


def assert_same_run(j, t):
    """Outputs, records, dispatch log and fault counters of two runs."""
    assert_same_env(j["env"], t["env"])
    assert_same_report(j["rep"], t["rep"])
    assert schedule(j["schedule"]) == schedule(t["schedule"])
    assert j["ft"] == t["ft"]


def run_of(env, rep, ex, log=None) -> dict:
    return {"env": env, "rep": rep, "schedule": list(ex.schedule if log is None else log),
            "ft": dict(ex.ft_counters)}


def set_oracle(db_np, qs) -> dict:
    setdb = {k: {tuple(map(int, r)) for r in v} for k, v in db_np.items()}
    out = {}
    for q in qs:
        out[q.name] = ref_engine.eval_bsgf(setdb, q)
        setdb[q.name] = out[q.name]
    return out


def assert_oracle(env, db_np, qs, names=None):
    want = set_oracle(db_np, qs)
    for name in names or [q.name for q in qs]:
        assert env[name].to_set() == want[name], name


# --------------------------------------------------------------------------
# speculation (tests/test_speculation.py)
# --------------------------------------------------------------------------


def fused_star(pkg, n_jobs: int = 6, n_rows: int = N, seed: int = 0):
    """``_fused_star_scenario``: one round of fused single-equation MSJ jobs
    over distinct guards, the minimal shape where a straggling slot can be
    backfilled."""
    A, B, all_of = pkg.alg.Atom, pkg.alg.BSGF, pkg.alg.all_of
    rng = np.random.default_rng(seed)
    qs, db_np = [], {}
    for i in range(n_jobs):
        qs.append(B(f"Z{i}", XYZW, A(f"G{i}", *XYZW), all_of(A("S", "x"))))
        db_np[f"G{i}"] = rng.integers(0, 64, (n_rows, 4)).astype(np.int32)
    db_np["S"] = rng.integers(0, 64, (n_rows, 1)).astype(np.int32)
    jobs = []
    for q in qs:
        sjs, _ = pkg.plan.pooled_semijoins([q])
        jobs.append(pkg.plan.MSJJob(tuple(sjs), fused=(q,)))
    return qs, db_np, pkg.plan.Plan((pkg.plan.Round(tuple(jobs)),)), jobs


def test_speculation_deadline_matches_reference():
    """``costmodel.speculation_deadline``: monotone in the modeled cost,
    never firing at one slot, uncalibrated or unmodeled."""
    for est, scale, slots, factor in itertools.product(
            (0.0, 1.0, 2.0, 5.0, 100.0), (None, 0.0, 0.5, 1.0), (None, 1, 2, 4), (2.5, 3.0)):
        got = costmodel.speculation_deadline(est, scale=scale, slots=slots, factor=factor)
        assert got == jcost.speculation_deadline(est, scale=scale, slots=slots, factor=factor)
    ds = [costmodel.speculation_deadline(c, scale=0.5, slots=4) for c in (1.0, 2.0, 5.0, 10.0)]
    assert ds == sorted(ds) and len(set(ds)) == len(ds)
    assert costmodel.speculation_deadline(100.0, scale=1.0, slots=1) == float("inf")


def straggler(target, first, clone=1.0):
    return lambda job, attempt: (first if attempt == 0 else clone) if job is target else 1.0


def star_run(pkg, clock, *, speculate, slots=2, first=30.0, clone=1.0, inject=None,
             executor=None, **config):
    qs, db_np, plan, jobs = fused_star(pkg)
    db = pkg.db(db_np, P)
    Ex = executor or pkg.ex.Executor
    ex = Ex(dict(db), pkg.Comm(P), cfg(pkg, speculate=speculate, **config))
    sched = pkg.sched.SlotScheduler(ex, slots=slots, stats=pkg.cost.stats_of_db(db))
    env, rep = sched.execute(plan, on_job=clock.hook(inject),
                             wall_scale=straggler(jobs[-1], first, clone))
    return {**run_of(env, rep, ex, sched.schedule), "jobs": jobs, "qs": qs, "db_np": db_np,
            "ex": ex}


@pytest.fixture(scope="module")
def straggler_runs():
    """The 30x straggler with speculation off, then on."""
    return {spec: both(star_run, speculate=spec) for spec in (False, True)}


def test_star_data_and_plan_match_reference():
    jqs, jdb, jplan_, _ = fused_star(REF)
    tqs, tdb, tplan, _ = fused_star(PORT)
    assert repr(jqs) == repr(tqs) and repr(jplan_.rounds) == repr(tplan.rounds)
    for k in jdb:
        np.testing.assert_array_equal(jdb[k], tdb[k])


@pytest.mark.parametrize("spec", [False, True])
def test_injected_straggler_matches_reference(straggler_runs, spec):
    j, t = straggler_runs[spec]
    assert_same_run(j, t)
    assert_oracle(t["env"], t["db_np"], t["qs"])


def test_injected_straggler_first_completion_wins(straggler_runs):
    (_, off), (_, on) = straggler_runs[False], straggler_runs[True]
    assert_same_env(off["env"], on["env"])
    rep, target = on["rep"], on["jobs"][-1]
    assert rep.n_speculative == 1 and rep.n_jobs == len(on["jobs"]) + 1
    assert on["ft"]["speculative"] == 1
    dup = [r for r in rep.records if r.job is target]
    assert {r.attempt for r in dup} == {0, 1}
    assert sum(r.cancelled for r in dup) == 1 and sum(r.speculative for r in dup) == 1
    assert dup[0].end == dup[1].end and dup[0].slot != dup[1].slot
    winner = next(r for r in dup if not r.cancelled)
    loser = next(r for r in dup if r.cancelled)
    assert winner.speculative and not loser.speculative  # the clone won
    assert loser.wall < 30.0 * winner.wall
    assert rep.event_makespan() < off["rep"].event_makespan()
    assert [s.attempt for s in on["schedule"]].count(1) == 1


def test_no_speculation_at_one_slot():
    """The straggler 10x slower under W = 1: there is no slot to clone onto."""
    j, t = both(star_run, speculate=True, slots=1, first=10.0)
    assert_same_run(j, t)
    assert t["rep"].n_speculative == 0 and t["rep"].n_jobs == len(t["jobs"])
    assert_oracle(t["env"], t["db_np"], t["qs"])


def test_losing_clone_is_ignored():
    """The clone (100x) is slower than the straggling original (4x)."""
    j, t = both(star_run, speculate=True, first=4.0, clone=100.0)
    assert_same_run(j, t)
    rep = t["rep"]
    assert rep.n_speculative == 1  # 4 s crosses the 2.5 s deadline under this clock
    dup = [r for r in rep.records if r.job is t["jobs"][-1]]
    loser = next(r for r in dup if r.cancelled)
    assert loser.speculative
    assert_oracle(t["env"], t["db_np"], t["qs"])


def failing_clone_run(pkg, clock):
    calls = {"n": 0}
    target = repr(fused_star(pkg)[3][-1])

    def inject(job, attempt):
        # the target's original attempt passes; its clone faults (the jobs
        # are rebuilt inside star_run, so the target is known by its repr)
        if repr(job) == target:
            calls["n"] += 1
            if calls["n"] > 1:
                raise pkg.ex.TransientFault("clone dies")

    out = star_run(pkg, clock, speculate=True, inject=inject)
    return {**out, "calls": calls["n"]}


def test_failing_clone_falls_back_to_original(straggler_runs):
    j, t = both(failing_clone_run)
    assert_same_run(j, t)
    assert t["calls"] == j["calls"] == 2  # the clone was dispatched and died
    assert t["rep"].n_speculative == 0 and t["rep"].n_jobs == len(t["jobs"])
    assert not any(r.cancelled for r in t["rep"].records)
    assert_same_env(t["env"], straggler_runs[True][1]["env"])


def relaxation_run(pkg, clock):
    """``FlakyExecutor``: the target's first attempt reports an overflow."""
    seen, target = [], repr(fused_star(pkg)[3][-1])

    class FlakyExecutor(pkg.ex.Executor):
        def run_job(self, job, *, cap_override=None, cap_slack=None):
            outs, stats = super().run_job(job, cap_override=cap_override, cap_slack=cap_slack)
            if repr(job) == target:
                seen.append((cap_override, cap_slack))
                if len(seen) == 1:
                    stats = dict(stats, overflow=3, forward_cap=512)
            return outs, stats

    out = star_run(pkg, clock, speculate=True, executor=FlakyExecutor, cap_slack=0.5)
    return {**out, "seen": seen}


def test_clone_shares_retry_state_single_relaxation():
    """The target overflows once (cap_slack 0.5), succeeds after one
    relaxation, then straggles into a clone, which inherits (None, 1.0)."""
    j, t = both(relaxation_run)
    assert_same_run(j, t)
    assert j["seen"] == t["seen"] == [(None, None), (None, 1.0), (None, 1.0)]
    assert t["rep"].n_speculative == 1 and t["ft"]["overflow_retries"] >= 1
    config = t["ex"].config
    assert config.cap_slack == 0.5 and config.speculate is True
    assert config == cfg(PORT, cap_slack=0.5, speculate=True)  # never mutated
    assert_oracle(t["env"], t["db_np"], t["qs"])


def rerouting_run(pkg, clock):
    qs = pkg.Q.make_queries("A3")
    db_np = JQ.gen_db(JQ.make_queries("A3"), n_guard=N, n_cond=N)
    plan = pkg.plan.plan_par(qs)
    failed = set()

    def inject(job, attempt):
        if id(job) not in failed:
            failed.add(id(job))
            raise pkg.ex.TransientFault(f"injected on {job}")

    def always(job, attempt):
        raise pkg.ex.TransientFault("x")

    ex = pkg.ex.Executor(dict(pkg.db(db_np, P)), pkg.Comm(P), cfg(pkg))
    env, rep = ex.execute(plan, on_job=clock.hook(inject), max_restarts=2)
    with pytest.raises(pkg.ex.TransientFault):  # with no restart budget the fault propagates
        pkg.ex.Executor(dict(pkg.db(db_np, P)), pkg.Comm(P), cfg(pkg)).execute(
            plan, on_job=clock.hook(always))
    return {**run_of(env, rep, ex), "qs": qs, "db_np": db_np}


def test_injected_failure_rerouting():
    j, t = both(rerouting_run, step=by_job)
    assert_same_run(j, t)
    assert all(r.attempts == 2 for r in t["rep"].records)
    assert t["ft"]["fault_retries"] == t["rep"].n_jobs
    assert_oracle(t["env"], t["db_np"], t["qs"], ["Z"])


def supervisor_run(pkg, clock, *, kind):
    if kind == "timeline":
        qs = pkg.Q.make_queries("A1")
        db_np = JQ.gen_db(JQ.make_queries("A1"), n_guard=N, n_cond=N)
        plan, ws = pkg.plan.plan_par(qs), None
        ft = pkg.sup.FTConfig(fault_rate=0.3, seed=2)
    else:
        qs, db_np, plan, jobs = fused_star(pkg)
        ws = straggler(jobs[-1], 30.0)
        ft = pkg.sup.FTConfig(speculative=kind == "speculate", straggler_factor=2.5)
    db = pkg.db(db_np, P)
    config = cfg(pkg)
    # with catalog statistics only where the supervisor must price deadlines
    ex = pkg.ex.Executor(dict(db), pkg.Comm(P), config,
                         stats=None if kind == "timeline" else pkg.cost.stats_of_db(db))
    sup = pkg.sup.Supervisor(ex, ft)
    inject = sup._inject
    sup._inject = clock.hook(inject)  # the supervisor's own hook, ticking the clock
    env, rep = sup.execute(plan, wall_scale=ws)
    assert ex.config is config and config.speculate is False  # restored
    return {**run_of(env, rep, ex), "qs": qs, "db_np": db_np, "stats": sup.stats.as_dict()}


@pytest.fixture(scope="module")
def supervisor_runs():
    return {k: both(supervisor_run, kind=k) for k in ("timeline", "speculate", "plain")}


@pytest.mark.parametrize("kind", ["timeline", "speculate", "plain"])
def test_supervisor_matches_reference(supervisor_runs, kind):
    j, t = supervisor_runs[kind]
    assert_same_run(j, t)
    assert j["stats"] == t["stats"]
    names = ["Z"] if kind == "timeline" else None
    assert_oracle(t["env"], t["db_np"], t["qs"], names)


def test_supervisor_drives_ready_queue_with_event_timeline(supervisor_runs):
    _, t = supervisor_runs["timeline"]
    assert t["stats"]["faults_injected"] > 0
    assert t["stats"]["retries"] >= t["stats"]["faults_injected"]
    assert t["rep"].event_makespan() is not None
    assert all(r.slot >= 0 and r.end >= r.start >= 0.0 for r in t["rep"].records)


def test_supervisor_speculates_with_statistics(supervisor_runs):
    (_, on), (_, off) = supervisor_runs["speculate"], supervisor_runs["plain"]
    assert on["stats"]["speculative_redispatches"] >= 1 and on["rep"].n_speculative >= 1
    assert off["rep"].n_speculative == 0
    assert_same_env(on["env"], off["env"])


# --------------------------------------------------------------------------
# failure domains (tests/test_failure_domains.py)
# --------------------------------------------------------------------------


def test_taint_closure_matches_reference():
    for pkg_plan, Q in ((jplan, JQ), (planner, queries)):
        nodes = pkg_plan.job_dag(pkg_plan.plan_sgf(Q.example5_sgf(), "sequnit"),
                                 edges="relations")
        fail = next(n for n in nodes if "Q2" in n.writes)
        rest = [n for n in nodes if n.idx > fail.idx]
        got = pkg_plan.taint_closure(rest, fail.writes)
        empty = pkg_plan.taint_closure(nodes, frozenset())
        if pkg_plan is jplan:
            want, want_empty = got, empty
    assert got == want and empty == want_empty == (frozenset(), frozenset())
    idx, rels = got
    writes = set().union(*(n.writes for n in rest if n.idx in idx), frozenset())
    assert {"Q3", "Q5"} <= writes | set(rels) and "Q2" in rels
    for n in rest:
        if "Q4" in n.writes and not n.reads & {"Q2", "Q3", "Q5"}:
            assert n.idx not in idx


@pytest.mark.parametrize("kw,match", [
    (dict(fail_policy="bogus"), "abort, isolate"),
    (dict(fail_policy="isolate", execution_mode="waves"), "isolate"),
    (dict(execution_mode="bogus"), "async, waves"),
    (dict(dag_edges="bogus"), "relations, strata"),
    (dict(speculate=True, execution_mode="waves"), "speculate"),
    (dict(shrink_on_shard_loss=True, execution_mode="waves"), "shrink_on_shard_loss"),
])
def test_config_validated_like_reference(kw, match):
    for pkg in (REF, PORT):
        with pytest.raises(ValueError, match=match):
            pkg.ex.ExecutorConfig(**kw)
    for mode in ("async", "waves"):
        assert tex.ExecutorConfig(execution_mode=mode).execution_mode == mode


def test_slots_validated_like_reference():
    db_np = JQ.gen_db(JQ.make_queries("A3"), n_guard=N, n_cond=N)
    for pkg in (REF, PORT):
        ex = pkg.ex.Executor(dict(pkg.db(db_np, P)), pkg.Comm(P), cfg(pkg))
        with pytest.raises(ValueError, match="slots"):
            ex.execute(pkg.plan.plan_par(pkg.Q.make_queries("A3")), slots=0)


def a4(pkg):
    qs = pkg.Q.make_queries("A4")
    db_np = JQ.gen_db(JQ.make_queries("A4"), n_guard=N, n_cond=N)
    return qs, db_np, pkg.plan.plan_par(qs)


@pytest.fixture(scope="module")
def a4_clean():
    """The fault-free A4 run of each package, the isolate and shrink runs'
    witness."""
    out = {}
    for pkg in (REF, PORT):
        _, db_np, plan = a4(pkg)
        out[pkg.name], _ = pkg.ex.Executor(pkg.db(db_np, P), pkg.Comm(P), cfg(pkg)).execute(plan)
    assert_same_env(out["repro"], out["repro_torch"])
    return out


def c3(pkg):
    """C3 planned ``sequnit``: the isolate and edge-mode scenarios' plan."""
    sgf = pkg.Q.make_sgf("C3")
    db_np = JQ.gen_db(JQ.make_sgf("C3"), n_guard=N, n_cond=N)
    return list(sgf), db_np, pkg.plan.plan_sgf(sgf, "sequnit")


def isolate_run(pkg, clock, *, qid):
    """``fail_policy="isolate"``: A4 with Z1's pipeline poisoned (a fault on
    every job reading R), C3 with Z1's producer poisoned, A3 with every
    attempt failing transiently past ``max_restarts``."""
    if qid == "A4":
        qs, db_np, plan = a4(pkg)
    elif qid == "C3":
        qs, db_np, plan = c3(pkg)
    else:
        qs = pkg.Q.make_queries("A3")
        db_np = JQ.gen_db(JQ.make_queries("A3"), n_guard=N, n_cond=N)
        plan = pkg.plan.plan_par(qs)

    def poison(job, attempt):
        if qid == "A4" and "R" in pkg.plan.job_reads(job):  # Z1's guard; Z2 guards on G
            raise pkg.ex.PermanentFault("poisoned pipeline")
        if qid == "C3" and "Z1" in pkg.plan.job_writes(job):
            raise pkg.ex.PermanentFault("poisoned Z1")
        if qid == "A3":
            raise pkg.ex.TransientFault("flaky forever")

    ex = pkg.ex.Executor(pkg.db(db_np, P), pkg.Comm(P), cfg(pkg, fail_policy="isolate"))
    env, rep = ex.execute(plan, on_job=clock.hook(poison), max_restarts=2)
    return {**run_of(env, rep, ex), "qs": qs, "db_np": db_np}


@pytest.fixture(scope="module")
def isolate_runs():
    return {qid: both(isolate_run, step=by_job, qid=qid) for qid in ("A4", "C3", "A3")}


@pytest.mark.parametrize("qid", ["A4", "C3", "A3"])
def test_isolate_matches_reference(isolate_runs, qid):
    j, t = isolate_runs[qid]
    assert_same_run(j, t)
    assert t["rep"].failed_jobs


def test_isolate_permanent_fault_spares_independent_query(isolate_runs, a4_clean):
    _, t = isolate_runs["A4"]
    rep = t["rep"]
    assert all(r.outcome == "failed" for r in rep.failed_jobs)
    assert "Z1" in rep.tainted_relations() and "Z2" not in rep.tainted_relations()
    assert "Z1" not in t["env"]
    assert_oracle(t["env"], t["db_np"], t["qs"], ["Z2"])
    assert torch.equal(t["env"]["Z2"].data, a4_clean["repro_torch"]["Z2"].data)
    assert torch.equal(t["env"]["Z2"].valid, a4_clean["repro_torch"]["Z2"].valid)


def test_isolate_taints_downstream_not_siblings(isolate_runs):
    _, t = isolate_runs["C3"]
    tainted = t["rep"].tainted_relations()
    assert {"Z1", "Z2", "Z3", "Z5"} <= tainted and "Z4" not in tainted
    assert_oracle(t["env"], t["db_np"], t["qs"], ["Z4"])
    assert t["rep"].tainted_jobs
    for rec in t["rep"].tainted_jobs:
        assert rec.wall == 0.0 and rec.start == rec.end and rec.slot == -1


def test_isolate_transient_exhaustion_records_failure(isolate_runs):
    _, t = isolate_runs["A3"]
    assert all(r.attempts >= 3 for r in t["rep"].failed_jobs)
    assert not any(r.outcome == "ok" for r in t["rep"].records)


def test_abort_policy_still_raises():
    db_np = JQ.gen_db(JQ.make_queries("A3"), n_guard=N, n_cond=N)
    for pkg in (REF, PORT):
        def poison(job, attempt, pkg=pkg):
            raise pkg.ex.PermanentFault("poison")

        with pytest.raises(pkg.ex.PermanentFault):
            pkg.ex.Executor(dict(pkg.db(db_np, P)), pkg.Comm(P), cfg(pkg)).execute(
                pkg.plan.plan_par(pkg.Q.make_queries("A3")), on_job=poison)


def shrink_run(pkg, clock):
    """A shard of the first job's first lineage relation lost; the rest of
    the execute runs on W - 1 slots."""
    qs, db_np, plan = a4(pkg)
    db = pkg.db(db_np, P)
    ex = pkg.ex.Executor(dict(db), pkg.Comm(P), cfg(pkg, shrink_on_shard_loss=True))
    fired = []

    def inject(job, attempt):
        if not fired:
            rel = sorted(pkg.plan.job_reads(job) & ex.lineage.keys())[0]
            fired.append(rel)
            ex.env[rel] = pkg.elastic.lose_shard(ex.env[rel], 0)
            raise pkg.ex.ShardLoss(rel, 0)

    env, rep = ex.execute(plan, slots=2, on_job=clock.hook(inject), max_restarts=2)
    return {**run_of(env, rep, ex), "qs": qs, "db_np": db_np, "lost": fired[0], "ex": ex,
            "db": db}


def test_shrink_on_shard_loss_drops_a_slot(a4_clean):
    j, t = both(shrink_run, step=by_job)
    assert_same_run(j, t)
    assert j["lost"] == t["lost"]
    assert t["ft"]["shard_recoveries"] == 1
    first_end = min(s.end for s in t["schedule"])
    later = [s for s in t["schedule"] if s.start >= first_end]
    assert later and {s.slot for s in later} == {0}
    assert_same_env(a4_clean["repro_torch"], t["env"])
    assert_oracle(t["env"], t["db_np"], t["qs"], ["Z1", "Z2"])
    # the recovered copy is the lineage source's, in new tensors
    lost = t["lost"]
    rec, src = t["ex"].env[lost], t["db"][lost]
    assert torch.equal(rec.data, src.data) and torch.equal(rec.valid, src.valid)
    assert rec.data.data_ptr() != src.data.data_ptr()


# --------------------------------------------------------------------------
# async against waves (tests/test_async_executor.py)
# --------------------------------------------------------------------------


def check_timeline(pkg, plan, rep, log, slots, edges="relations"):
    """The scheduler invariants every recorded event timeline must hold."""
    nodes = pkg.plan.job_dag(plan, edges)
    by_idx = {s.idx: s for s in log}
    assert len(by_idx) == len(nodes) == len(rep.records)
    for n in nodes:
        for d in n.deps:
            assert by_idx[d].end <= by_idx[n.idx].start, (d, n.idx)
    for rec, s in zip(rep.records, log):
        assert (rec.start, rec.end, rec.slot) == (s.start, s.end, s.slot)
        assert rec.end == rec.start + rec.wall
    if slots is not None:
        assert len({s.slot for s in log}) <= slots
    for a, b in itertools.combinations(log, 2):
        if a.slot == b.slot:
            assert a.end <= b.start or b.end <= a.start, (a, b)
    if slots is not None:
        running = peak = 0
        for _, d in sorted([(s.start, 1) for s in log] + [(s.end, -1) for s in log]):
            running += d
            peak = max(peak, running)
        assert peak <= slots


def c4_run(pkg, clock, *, mode, slots, scheduler, edges="relations"):
    sgf = pkg.Q.make_sgf("C4")
    db_np = JQ.gen_db(JQ.make_sgf("C4"), n_guard=N, n_cond=N)
    plan = pkg.plan.plan_sgf(sgf, "parunit")
    db = pkg.db(db_np, P)
    ex = pkg.ex.Executor(dict(db), pkg.Comm(P),
                         cfg(pkg, execution_mode=mode, dag_edges=edges))
    if scheduler:
        sched = pkg.sched.SlotScheduler(ex, slots=slots, stats=pkg.cost.stats_of_db(db))
        env, rep = sched.execute(plan, on_job=clock.hook())
        log = sched.schedule
    else:
        env, rep = ex.execute(plan, slots=slots, on_job=clock.hook())
        log = ex.schedule
    check_timeline(pkg, plan, rep, log, slots, edges)
    return {**run_of(env, rep, ex, log), "qs": list(sgf), "db_np": db_np, "plan": plan}


C4_RUNS = {
    "async_w2": dict(mode="async", slots=2, scheduler=True),
    "async_unbounded": dict(mode="async", slots=None, scheduler=False),
    "waves_w2": dict(mode="waves", slots=2, scheduler=True),
    "strata_w2": dict(mode="async", slots=2, scheduler=True, edges="strata"),
}


@pytest.fixture(scope="module")
def c4_runs():
    return {k: both(c4_run, step=by_job, **kw) for k, kw in C4_RUNS.items()}


@pytest.mark.parametrize("run", list(C4_RUNS))
def test_c4_matches_reference(c4_runs, run):
    j, t = c4_runs[run]
    assert_same_run(j, t)
    assert_oracle(t["env"], t["db_np"], t["qs"])


def test_async_respects_dag_and_slot_bound(c4_runs):
    _, t = c4_runs["async_w2"]
    assert t["rep"].event_makespan() == t["rep"].net_time_by_events(2)


def test_async_unbounded_starts_rounds_at_barriers(c4_runs):
    _, t = c4_runs["async_unbounded"]
    starts = {}
    for rec in t["rep"].records:
        starts.setdefault(rec.round_idx, set()).add(rec.start)
    assert all(len(s) == 1 for s in starts.values())
    slots_r0 = [rec.slot for rec in t["rep"].records if rec.round_idx == 0]
    assert len(set(slots_r0)) == len(slots_r0)
    assert t["rep"].event_makespan() == t["rep"].net_time


@pytest.mark.parametrize("a,b", [("async_w2", "waves_w2"), ("async_w2", "strata_w2")])
def test_modes_bit_identical(c4_runs, a, b):
    assert_same_env(c4_runs[a][1]["env"], c4_runs[b][1]["env"])


def a1_waves_run(pkg, clock):
    qs = pkg.Q.make_queries("A1")
    db_np = JQ.gen_db(JQ.make_queries("A1"), n_guard=N, n_cond=N)
    ex = pkg.ex.Executor(dict(pkg.db(db_np, P)), pkg.Comm(P), cfg(pkg, execution_mode="waves"))
    env, rep = ex.execute(pkg.plan.plan_par(qs), on_job=clock.hook())
    return {**run_of(env, rep, ex), "qs": qs, "db_np": db_np}


def test_waves_unbounded_reproduces_seed_rounds():
    j, t = both(a1_waves_run, step=by_job)
    assert_same_run(j, t)
    starts = {}
    for rec in t["rep"].records:
        starts.setdefault(rec.round_idx, set()).add(rec.start)
    assert all(len(s) == 1 for s in starts.values())
    assert t["rep"].event_makespan() == t["rep"].net_time
    assert_oracle(t["env"], t["db_np"], t["qs"], ["Z"])


def sync_run(pkg, clock, *, sync):
    qs = pkg.Q.make_queries("A3")
    db_np = JQ.gen_db(JQ.make_queries("A3"), n_guard=N, n_cond=N)
    ex = pkg.ex.Executor(dict(pkg.db(db_np, P)), pkg.Comm(P), cfg(pkg, sync_per_job=sync))
    env, rep = ex.execute(pkg.plan.plan_par(qs), on_job=clock.hook())
    return run_of(env, rep, ex)


def test_sync_per_job_outputs_identical():
    runs = [both(sync_run, step=by_job, sync=s) for s in (True, False)]
    for j, t in runs:
        assert_same_run(j, t)
    assert_same_run(runs[0][1], runs[1][1])  # only the walls could differ, and do not here


# --------------------------------------------------------------------------
# the service under both execution modes and both edge modes
# (tests/test_async_executor.py:141, tests/test_job_dag.py:283)
# --------------------------------------------------------------------------


def service_run(pkg, clock, **config):
    tenants = [[pkg.Q.make_queries("A1")[0]], [pkg.Q.make_queries("A3")[0]]]
    jt = [[JQ.make_queries("A1")[0]], [JQ.make_queries("A3")[0]]]
    db_np = JQ.gen_db([q for qs in jt for q in qs], n_guard=N, n_cond=N)
    svc = pkg.svc.SGFService(pkg.catalog(db_np, P), comm=pkg.Comm(P), slots=2,
                             config=cfg(pkg, **config))
    svc.on_job = clock.hook()
    reqs = [svc.submit(qs) for qs in tenants]
    svc.tick()
    outs = [{name: rel for name, rel in req.outputs.items()} for req in reqs]
    return {"outs": outs, "rep": svc.last_report, "tenants": tenants, "db_np": db_np}


SERVICE_RUNS = {"async": {}, "waves": dict(execution_mode="waves"),
                "strata": dict(dag_edges="strata")}


@pytest.fixture(scope="module")
def service_runs():
    return {k: both(service_run, step=by_job, **kw) for k, kw in SERVICE_RUNS.items()}


@pytest.mark.parametrize("run", list(SERVICE_RUNS))
def test_service_matches_reference(service_runs, run):
    j, t = service_runs[run]
    assert len(j["outs"]) == len(t["outs"])
    for jo, to in zip(j["outs"], t["outs"]):
        assert_same_env(jo, to)
    assert_same_report(j["rep"], t["rep"])
    setdb = {k: {tuple(map(int, r)) for r in v} for k, v in t["db_np"].items()}
    for out, qs in zip(t["outs"], t["tenants"]):
        for q in qs:
            assert out[q.name].to_set() == ref_engine.eval_bsgf(setdb, q)


@pytest.mark.parametrize("run", ["waves", "strata"])
def test_service_modes_bit_identical(service_runs, run):
    for a, b in zip(service_runs["async"][1]["outs"], service_runs[run][1]["outs"]):
        assert_same_env(a, b)


# --------------------------------------------------------------------------
# edge modes on C3 (tests/test_job_dag.py:252-281; C4 is above)
# --------------------------------------------------------------------------


def c3_edges_run(pkg, clock, *, edges):
    qs, db_np, plan = c3(pkg)
    ex = pkg.ex.Executor(dict(pkg.db(db_np, P)), pkg.Comm(P), cfg(pkg, dag_edges=edges))
    env, rep = ex.execute(plan, slots=2, on_job=clock.hook())
    check_timeline(pkg, plan, rep, ex.schedule, 2, edges)
    return {**run_of(env, rep, ex), "qs": qs, "db_np": db_np}


@pytest.fixture(scope="module")
def c3_runs():
    return {e: both(c3_edges_run, step=by_job, edges=e) for e in ("relations", "strata")}


@pytest.mark.parametrize("edges", ["relations", "strata"])
def test_c3_edge_modes_match_reference(c3_runs, edges):
    j, t = c3_runs[edges]
    assert_same_run(j, t)
    assert_oracle(t["env"], t["db_np"], t["qs"])


def test_c3_edge_modes_bit_identical(c3_runs):
    assert_same_env(c3_runs["relations"][1]["env"], c3_runs["strata"][1]["env"])
