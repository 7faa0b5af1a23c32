"""Port differential: shard loss, lineage recovery and repartitioning
(``ft/elastic``), and the fault supervisor (``ft/supervisor``).

* ``lose_shard``, ``recover_shard`` and ``repartition_relation`` give the
  reference's arrays, at the same P and cap and across a change of P or
  cap, and never write into the relations they are given: a relation's
  tensors are shared by the catalog, the executor's environment and its
  lineage, so an in-place write would damage the durable source.
* An ``Executor`` whose injector loses a shard of ``R`` recovers it and
  finishes bit-identically to a clean run, with the reference's
  ``ft_counters`` and outputs; a ``Supervisor`` injecting shard losses
  and faults from a seed counts what the reference counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import queries as JQ  # noqa: E402
from repro.core.executor import Executor as JExecutor, ShardLoss as JShardLoss  # noqa: E402
from repro.core.planner import job_reads as jjob_reads, plan_par as jplan_par  # noqa: E402
from repro.core.relation import Relation as JRelation, db_from_dict as jdb_from_dict  # noqa: E402
from repro.engine.comm import SimComm as JSimComm  # noqa: E402
from repro.ft import elastic as jelastic, supervisor as jsupervisor  # noqa: E402
from repro_torch.core import queries  # noqa: E402
from repro_torch.core.executor import Executor, PermanentFault, ShardLoss  # noqa: E402
from repro_torch.core.planner import job_reads, plan_par  # noqa: E402
from repro_torch.core.relation import Relation, db_from_reference  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402
from repro_torch.ft import elastic, supervisor  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401


def _pair(rows, **kw):
    """The same rows as a reference and a port relation (same placement)."""
    j = JRelation.from_numpy("R", rows, **kw)
    t = Relation.from_numpy("R", rows, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(j.data), t.data.numpy())
    return j, t


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j.data), t.data.numpy())
    np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())


def _rows(seed, n, arity):
    return np.random.default_rng(seed).integers(-50, 50, (n, arity)).astype(np.int32)


@pytest.mark.parametrize("P,cap,shard", [(4, None, 2), (4, 16, 0), (3, None, 2), (1, None, 0)])
def test_lose_and_recover_match_reference_and_leave_inputs_intact(P, cap, shard):
    j, t = _pair(_rows(P, 37, 3), P=P, cap=cap)
    before = (t.data.clone(), t.valid.clone())
    jd, td = jelastic.lose_shard(j, shard), elastic.lose_shard(t, shard)
    _same(jd, td)
    assert td.count() < t.count()
    assert torch.equal(t.data, before[0]) and torch.equal(t.valid, before[1])
    assert td.data.data_ptr() != t.data.data_ptr()
    damaged = (td.data.clone(), td.valid.clone())
    jr, tr = jelastic.recover_shard(jd, j, shard), elastic.recover_shard(td, t, shard)
    _same(jr, tr)
    assert torch.equal(tr.data, t.data) and torch.equal(tr.valid, t.valid)
    assert torch.equal(td.data, damaged[0]) and torch.equal(td.valid, damaged[1])
    assert torch.equal(t.data, before[0]) and torch.equal(t.valid, before[1])


@pytest.mark.parametrize("src_P,src_cap,dst_P,dst_cap", [
    (2, None, 4, 32),  # lineage kept at an older P
    (4, None, 4, 16),  # same P, another cap: rows front-packed
    (8, None, 4, None),
])
def test_recover_from_other_shape_matches_reference(src_P, src_cap, dst_P, dst_cap):
    rows = _rows(11, 40, 2)
    jsrc, tsrc = _pair(rows, P=src_P, cap=src_cap)
    jdst, tdst = _pair(rows, P=dst_P, cap=dst_cap)
    for shard in range(dst_P):
        jr = jelastic.recover_shard(jelastic.lose_shard(jdst, shard), jsrc, shard)
        tr = elastic.recover_shard(elastic.lose_shard(tdst, shard), tsrc, shard)
        _same(jr, tr)
        assert tr.to_set() == tdst.to_set()


@pytest.mark.parametrize("P,new_P,partition", [(4, 4, "block"), (4, 2, "block"),
                                                (2, 5, "block"), (4, 3, "hash")])
def test_repartition_matches_reference(P, new_P, partition):
    j, t = _pair(_rows(5, 53, 3), P=P)
    # gaps in the validity mask: repartition emits only valid rows
    j = JRelation(j.name, j.data, j.valid.at[0, 1].set(False))
    t = Relation(t.name, t.data, t.valid.clone())
    t.valid[0, 1] = False
    _same(jelastic.repartition_relation(j, new_P, partition=partition),
          elastic.repartition_relation(t, new_P, partition=partition))
    jdb = jelastic.repartition_db({"R": j, "S": j.rename("S")}, new_P)
    tdb = elastic.repartition_db({"R": t, "S": t.rename("S")}, new_P)
    for k in jdb:
        _same(jdb[k], tdb[k])


def test_elastic_validates_like_reference():
    t = Relation.from_numpy("R", np.arange(8).reshape(4, 2), P=2, device="cpu")
    bad = Relation.from_numpy("R", np.arange(9).reshape(3, 3), P=2, device="cpu")
    with pytest.raises(ValueError, match="arity"):
        elastic.recover_shard(t, bad, 0)
    with pytest.raises(ValueError, match="out of range"):
        elastic.lose_shard(t, 5)
    with pytest.raises(ValueError, match="out of range"):
        elastic.recover_shard(t, t, 2)


# --------------------------------------------------------------------------
# executor recovery and the supervisor
# --------------------------------------------------------------------------

P = 4


def _dbs():
    db_np = JQ.gen_db(JQ.make_queries("A1"), n_guard=128, n_cond=128)
    jdb = jdb_from_dict(db_np, P=P)
    tdb = db_from_reference(
        {k: (np.asarray(r.data), np.asarray(r.valid)) for k, r in jdb.items()},
        device="cpu",
    )
    return jdb, tdb


def _injected_run(ExecutorCls, Comm, elastic_mod, ShardLossCls, reads, db, plan):
    ex = ExecutorCls(db, Comm(P))
    fired = []

    def injector(job, attempt):
        if not fired and "R" in reads(job):
            fired.append(True)
            ex.env["R"] = elastic_mod.lose_shard(ex.env["R"], 1)
            raise ShardLossCls("R", 1)

    env, report = ex.execute(plan, on_job=injector, max_restarts=2)
    assert fired
    return env, report, ex


@pytest.fixture(scope="module")
def recovery_runs():
    jdb, tdb = _dbs()
    jp, tp = jplan_par(JQ.make_queries("A1")), plan_par(queries.make_queries("A1"))
    tclean, _ = Executor(dict(tdb), SimComm(P)).execute(tp)
    ref = _injected_run(JExecutor, JSimComm, jelastic, JShardLoss, jjob_reads, jdb, jp)
    tdb_before = {k: (r.data.clone(), r.valid.clone()) for k, r in tdb.items()}
    port = _injected_run(Executor, SimComm, elastic, ShardLoss, job_reads, tdb, tp)
    return ref, port, tclean, tdb, tdb_before


def test_executor_recovers_shard_loss_like_reference(recovery_runs):
    (jenv, jrep, jex), (tenv, trep, tex), tclean, _, _ = recovery_runs
    assert tex.ft_counters == jex.ft_counters
    assert tex.ft_counters["shard_recoveries"] == 1
    for k in ("Z",):
        _same(jenv[k], tenv[k])
        assert torch.equal(tenv[k].data, tclean[k].data)
        assert torch.equal(tenv[k].valid, tclean[k].valid)
    assert [(r.outcome, r.attempts) for r in trep.records] == \
        [(r.outcome, r.attempts) for r in jrep.records]
    assert trep.net_time_by_events(None) == trep.net_time
    assert trep.net_time_by_events(1) == trep.total_time


def test_shard_loss_leaves_lineage_intact(recovery_runs):
    _, (_, _, tex), _, tdb, before = recovery_runs
    for k, (data, valid) in before.items():
        assert torch.equal(tdb[k].data, data) and torch.equal(tdb[k].valid, valid), k
        assert torch.equal(tex.lineage[k].data, data), k
    assert torch.equal(tex.env["R"].data, before["R"][0])


def test_shard_loss_without_lineage_escalates():
    _, tdb = _dbs()
    ex = Executor(dict(tdb), SimComm(P), lineage={})

    def injector(job, attempt):
        if "R" in job_reads(job):
            ex.env["R"] = elastic.lose_shard(ex.env["R"], 0)
            raise ShardLoss("R", 0)

    with pytest.raises(PermanentFault, match="no lineage"):
        ex.execute(plan_par(queries.make_queries("A1")), on_job=injector, max_restarts=3)


def test_supervisor_counts_match_reference():
    jdb, tdb = _dbs()
    cfg = dict(shard_loss_rate=0.5, fault_rate=0.2, max_restarts=8, seed=3, speculative=False)
    jsup = jsupervisor.Supervisor(JExecutor(dict(jdb), JSimComm(P)),
                                  jsupervisor.FTConfig(**cfg))
    tsup = supervisor.Supervisor(Executor(dict(tdb), SimComm(P)), supervisor.FTConfig(**cfg))
    jenv, _ = jsup.execute(jplan_par(JQ.make_queries("A1")))
    tenv, _ = tsup.execute(plan_par(queries.make_queries("A1")))
    assert tsup.stats.as_dict() == jsup.stats.as_dict()
    assert tsup.stats.shard_losses > 0
    assert tsup.stats.shard_recoveries == tsup.stats.shard_losses
    _same(jenv["Z"], tenv["Z"])
    assert issubclass(supervisor.SimulatedFault, supervisor.TransientFault)
