"""Port differential: plans through the executor, end to end.

``repro_torch``'s planner + ``execute_plan`` against ``repro``'s on the
same sharded state: every output relation's ``data``/``valid`` and every
job's counters must be equal, and the outputs set-equal to the port's
``ref_engine``.  The port runs its ``"kernel"`` backend (the plain band
compare, since the tensors lie on the CPU); the reference runs its
``"sorted"`` backend — ``repro``'s own conformance suite holds all its
backends bit-identical, and its Pallas backend in interpret mode costs
tens of seconds per plan on the CPU — except for the one-job 1-ROUND
plan, which runs its ``"pallas"`` backend.  Exact equality: every value
is an int32 or a bool.

The reference's CPU cost is compile time per operation shape, so the
reference plans share one data shape (A3 at N rows, P shards) where they
can: the PAR plan runs with static (worst-case) forward caps, so its four
same-shaped MSJ jobs and the ``overlap=True``, ``skew_defense=True`` and
``bloom_bits`` runs of it reuse one set of compiled operations (run in a fresh process,
the skew run alone costs twice as long); 1-ROUND and GREEDY run the
count-sized caps.  One SGF family (C1, ``plan_sgf``) is compared with
the reference as well; all four C families are held against the
set-semantics oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import costmodel as jcost  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.core import planner as jplan  # noqa: E402
from repro.core import queries as JQ  # noqa: E402
from repro.core.relation import db_from_dict as jdb_from_dict  # noqa: E402
from repro.engine.comm import SimComm as JSimComm  # noqa: E402
from repro_torch.core import costmodel, planner, queries, ref_engine  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    Executor,
    ExecutorConfig,
    JobRecord,
    Report,
    execute_plan,
    resolve_probe_backend,
)
from repro_torch.core.relation import Relation, db_from_reference  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402
from repro_torch.kernels.msj_probe import ops  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

P = 2
N = 64


def _dbs(db_np):
    jdb = jdb_from_dict(db_np, P=P)
    tdb = db_from_reference(
        {k: (np.asarray(r.data), np.asarray(r.valid)) for k, r in jdb.items()},
        device="cpu",
    )
    return jdb, tdb


def _oracle(db_np, queries_):
    setdb = {k: {tuple(map(int, r)) for r in v} for k, v in db_np.items()}
    out = {}
    for q in queries_:
        out[q.name] = ref_engine.eval_bsgf({**setdb, **out}, q)
    return out


def _assert_same_run(jenv, jrep, tenv, trep):
    names = {k for k, v in jenv.items() if hasattr(v, "valid")}
    assert names == {k for k, v in tenv.items() if isinstance(v, Relation)}
    for k in names:
        np.testing.assert_array_equal(np.asarray(jenv[k].data), tenv[k].data.numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(jenv[k].valid), tenv[k].valid.numpy(), err_msg=k)
    # the async walk orders sub-nodes by measured walls, so records are
    # matched by job, not by position
    def by_job(records):
        return sorted(records, key=lambda r: (repr(r.job), r.attempt))

    assert len(jrep.records) == len(trep.records)
    for jr, tr in zip(by_job(jrep.records), by_job(trep.records)):
        assert type(jr.job).__name__ == type(tr.job).__name__
        assert repr(jr.job) == repr(tr.job)
        assert (jr.round_idx, jr.attempts, jr.outcome) == (tr.round_idx, tr.attempts, tr.outcome)
        assert jr.stats == tr.stats
        if tr.backend:
            assert tr.backend == "kernel"
    assert jrep.bytes_shuffled() == trep.bytes_shuffled()
    assert jrep.input_rows() == trep.input_rows()


def _a3():
    db_np = JQ.gen_db(JQ.make_queries("A3"), n_guard=N, n_cond=N, seed=3)
    np.testing.assert_array_equal(
        queries.gen_db(queries.make_queries("A3"), n_guard=N, n_cond=N, seed=3)["R"],
        db_np["R"],
    )
    return db_np


@pytest.mark.parametrize("strategy", ["greedy", "one_round", "par"])
def test_a3_plans_match_reference(strategy):
    db_np = _a3()
    jdb, tdb = _dbs(db_np)
    jq, tq = JQ.make_queries("A3"), queries.make_queries("A3")
    count_sized = strategy != "par"
    if strategy == "par":
        jp, tp = jplan.plan_par(jq), planner.plan_par(tq)
    elif strategy == "greedy":
        jp = jplan.plan_greedy(jq, jcost.stats_of_db(jdb), jcost.HADOOP)
        tp = planner.plan_greedy(tq, costmodel.stats_of_db(tdb), costmodel.HADOOP)
    else:
        jp, tp = jplan.plan_one_round(jq), planner.plan_one_round(tq)
    assert repr(jp.rounds) == repr(tp.rounds)
    ref_backend = "pallas" if strategy == "one_round" else "sorted"
    jenv, jrep = jex.execute_plan(
        jdb, jp, JSimComm(P),
        jex.ExecutorConfig(probe_backend=ref_backend, count_sized=count_sized))
    tenv, trep = execute_plan(
        tdb, tp, SimComm(P), ExecutorConfig(probe_backend="kernel", count_sized=count_sized))
    _assert_same_run(jenv, jrep, tenv, trep)
    assert tenv["Z"].to_set() == _oracle(db_np, tq)["Z"]


def _a3_par_both(**cfg):
    """The A3 PAR plan with static caps through both executors under the
    extra config ``cfg``; after the PAR case above, the reference's
    operations for these shapes are compiled."""
    db_np = _a3()
    jdb, tdb = _dbs(db_np)
    jp, tp = jplan.plan_par(JQ.make_queries("A3")), planner.plan_par(queries.make_queries("A3"))
    if cfg.get("skew_defense"):
        jp = jplan.annotate_skew(jp, None, P, packing=False, force_R=2, threshold=4)
        tp = planner.annotate_skew(tp, None, P, packing=False, force_R=2, threshold=4)
        assert repr(jp.rounds) == repr(tp.rounds)
    jenv, jrep = jex.execute_plan(jdb, jp, JSimComm(P), jex.ExecutorConfig(
        probe_backend="sorted", count_sized=False, **cfg))
    tenv, trep = execute_plan(tdb, tp, SimComm(P), ExecutorConfig(
        probe_backend="kernel", count_sized=False, **cfg))
    _assert_same_run(jenv, jrep, tenv, trep)
    assert tenv["Z"].to_set() == _oracle(db_np, queries.make_queries("A3"))["Z"]
    return trep


def test_overlap_matches_reference():
    rep = _a3_par_both(overlap=True)
    assert {"TransferJob", "ComputeJob"} <= {type(r.job).__name__ for r in rep.records}


def test_skew_defense_matches_reference():
    rep = _a3_par_both(packing=False, skew_defense=True)
    assert {"SkewProfileJob", "TransferJob", "ComputeJob"} <= {
        type(r.job).__name__ for r in rep.records
    }
    assert sum(r.stats.get("replicated", 0) for r in rep.records) > 0


@pytest.mark.parametrize("overlap", [False, True])
def test_bloom_matches_reference(overlap):
    """``ExecutorConfig(bloom_bits=...)`` through both executors, inline and
    split into transfer and compute sub-nodes: held against ``repro`` (every
    output array and job counter) and the set-semantics oracle."""
    rep = _a3_par_both(bloom_bits=256, overlap=overlap)
    split = {"TransferJob", "ComputeJob"} <= {type(r.job).__name__ for r in rep.records}
    assert split == overlap


def test_sgf_plan_matches_reference():
    """One SGF family through ``plan_sgf`` in both packages: C1, four
    queries over four guards sharing their conditionals, as one 1-ROUND
    job."""
    jsgf, sgf = JQ.make_sgf("C1"), queries.make_sgf("C1")
    db_np = queries.gen_db(sgf, n_guard=N, n_cond=N, seed=5)
    jdb, tdb = _dbs(db_np)
    jp = jplan.plan_sgf(jsgf, "one_round", jcost.stats_of_db(jdb))
    tp = planner.plan_sgf(sgf, "one_round", costmodel.stats_of_db(tdb))
    assert repr(jp.rounds) == repr(tp.rounds)
    jenv, jrep = jex.execute_plan(jdb, jp, JSimComm(P), jex.ExecutorConfig(probe_backend="sorted"))
    tenv, trep = execute_plan(tdb, tp, SimComm(P), ExecutorConfig(probe_backend="kernel"))
    _assert_same_run(jenv, jrep, tenv, trep)
    want = _oracle(db_np, list(sgf))
    for q in sgf:
        assert tenv[q.name].to_set() == want[q.name], q.name


@pytest.mark.parametrize("qid,strategy", [
    ("C1", "greedy"), ("C2", "parunit"), ("C3", "sequnit"), ("C4", "greedy"),
    ("C4", "one_round"),
])
def test_sgf_families_match_oracle(qid, strategy):
    sgf = queries.make_sgf(qid)
    db_np = queries.gen_db(sgf, n_guard=N, n_cond=N, seed=5)
    tdb = _dbs(db_np)[1]
    plan = planner.plan_sgf(sgf, strategy, costmodel.stats_of_db(tdb))
    env, report = execute_plan(tdb, plan, SimComm(P), ExecutorConfig(probe_backend="kernel"))
    want = _oracle(db_np, list(sgf))
    for q in sgf:
        assert env[q.name].to_set() == want[q.name], q.name
    assert report.n_jobs == len(planner.job_dag(plan))
    # the port's Report replays its own walls exactly (left folds)
    assert report.net_time_by_events(None) == report.net_time
    assert report.net_time_by_events(1) == report.total_time


def _same_env(a, b, names):
    for k in names:
        assert torch.equal(a[k].data, b[k].data), k
        assert torch.equal(a[k].valid, b[k].valid), k


def test_overlap_split_is_bit_identical():
    db_np = _a3()
    tdb = _dbs(db_np)[1]
    plan = planner.plan_par(queries.make_queries("A3"))
    base_env, base = execute_plan(dict(tdb), plan, SimComm(P), ExecutorConfig(probe_backend="kernel"))
    env, rep = execute_plan(dict(tdb), plan, SimComm(P),
                            ExecutorConfig(probe_backend="kernel", overlap=True))
    _same_env(base_env, env, ["Z"])
    kinds = {type(r.job).__name__ for r in rep.records}
    assert {"TransferJob", "ComputeJob"} <= kinds
    assert rep.bytes_shuffled() == base.bytes_shuffled()
    assert not [k for k in env if k.startswith("%")]


def test_skew_defense_is_bit_identical():
    rng = np.random.default_rng(0)
    ranks = np.arange(1, 17, dtype=np.float64) ** -1.5
    db_np = {
        "R": np.stack([rng.choice(16, size=160, p=ranks / ranks.sum()),
                       rng.integers(0, 1 << 16, 160)], axis=1).astype(np.int32),
        "S": np.stack([rng.integers(0, 16, 80), rng.integers(0, 1 << 16, 80)],
                      axis=1).astype(np.int32),
    }
    from repro_torch.core.algebra import Atom, BSGF

    q = BSGF("Z", ("x", "y"), Atom("R", "x", "y"), Atom("S", "x", "w"))
    tdb = _dbs(db_np)[1]
    plain = planner.plan_par([q])
    cfg = dict(packing=False, probe_backend="kernel")
    base_env, _ = execute_plan(dict(tdb), plain, SimComm(P), ExecutorConfig(**cfg))
    plan = planner.annotate_skew(plain, None, P, packing=False, force_R=2, threshold=4)
    env, rep = execute_plan(dict(tdb), plan, SimComm(P),
                            ExecutorConfig(skew_defense=True, **cfg))
    _same_env(base_env, env, ["Z"])
    assert env["Z"].to_set() == _oracle(db_np, [q])["Z"]
    assert {"SkewProfileJob", "TransferJob", "ComputeJob"} <= {
        type(r.job).__name__ for r in rep.records
    }
    assert sum(r.stats.get("replicated", 0) for r in rep.records) > 0


def test_report_replay_identities_fold_left_to_right():
    """W=∞ == net_time and W=1 == total_time hold bit-exactly on the walls
    that break a compensated sum()."""
    rep = Report()
    for ri, w in [(0, 1.7), (2, 0.3123), (1, 2.00001), (1, 0.9), (0, 4.1)]:
        rep.records.append(JobRecord(None, ri, float(w), {}))
    assert rep.net_time_by_events(None) == rep.net_time
    assert rep.net_time_by_events(1) == rep.total_time
    assert rep.net_time == 4.1 + 2.00001 + 0.3123
    assert rep.total_time == 1.7 + 4.1 + 2.00001 + 0.9 + 0.3123


def test_backend_names_and_device_aware_auto():
    with pytest.raises(ValueError):
        ExecutorConfig(probe_backend="pallas")
    assert resolve_probe_backend("kernel") is ops.probe_bucketed
    assert costmodel.choose_backend(1e6, 1e6, on_cuda=True) == "kernel"
    assert costmodel.choose_backend(1e6, 1e6, on_cuda=False) == "sorted"
    assert costmodel.choose_backend(1e6, 1e6) == "sorted"
    # "auto" prices the kernel from where the job's relations live: CPU
    # data never picks it, whatever the machine has
    tdb = _dbs(_a3())[1]
    plan = planner.plan_par(queries.make_queries("A3"))
    ex = Executor(tdb, SimComm(P))
    assert all(ex._probe_backend_for(j) != "kernel"
               for r in plan.rounds for j in r.jobs if isinstance(j, planner.MSJJob))


def test_unported_layers_raise():
    """The layers this test once found missing are ported: ``sanitize=True``
    runs the happens-before sanitizer instead of raising, clean and
    bit-identical to the unsanitized walk."""
    tdb = _dbs(_a3())[1]
    plan = planner.plan_par(queries.make_queries("A3"))
    env0, _ = execute_plan(tdb, plan, SimComm(P))
    ex = Executor(tdb, SimComm(P), ExecutorConfig(sanitize=True))
    env1, _ = ex.execute(plan)
    assert ex.last_sanitize == []
    assert torch.equal(env1["Z"].data, env0["Z"].data)
    assert torch.equal(env1["Z"].valid, env0["Z"].valid)
