"""Port differential: the SGF query service.

``repro_torch.service.SGFService`` against ``repro.service.SGFService`` on
the same catalog (the four-tenant mixed A-family workload of the
reference's service bench, 256 rows per relation, P=4) and the same
submissions, tick by tick:

* a cold tick, a warm tick (0 jobs, 0 bytes), a tick after registering an
  unrelated relation (still warm) and one after re-registering ``S`` with
  the same rows (every query reads ``S`` and runs again, its semi-joins
  on ``T``, ``U`` and ``V`` served from the cache);
* under ``fail_policy="isolate"``, a scripted fault that poisons the
  tenant guarding on ``H``: its request is retried with backoff, fails
  again and its tenant is quarantined, while the co-admitted tenants are
  served.

After every tick each request's ``data``/``valid`` arrays, its failure
fields, the service ``counters()`` (all but the wall-clock ones), the
catalog's ``rel_epochs`` and ``last_tick`` must be equal.  Exact
equality: every value is an int32, a bool or a count.

The reference compiles every operation shape on the CPU, so both runs are
module-scoped and every test reads them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import queries as JQ  # noqa: E402
from repro.core.algebra import Atom as JAtom, BSGF as JBSGF, all_of as jall_of  # noqa: E402
from repro.core.executor import ExecutorConfig as JConfig, PermanentFault as JFault  # noqa: E402
from repro.core.planner import job_reads as jjob_reads  # noqa: E402
from repro.engine.comm import SimComm as JSimComm  # noqa: E402
from repro import service as jsvc  # noqa: E402
from repro_torch.core import queries, ref_engine  # noqa: E402
from repro_torch.core.algebra import Atom, BSGF  # noqa: E402
from repro_torch.core.executor import ExecutorConfig, PermanentFault  # noqa: E402
from repro_torch.core.planner import job_reads  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402
from repro_torch import service as tsvc  # noqa: E402

P = 4
N = 256
XYZW = ("x", "y", "z", "w")
#: wall-clock counters: measured, so never equal across two runs
WALL_KEYS = ("net_time", "total_time", "tick_latency_p50", "tick_latency_p95",
             "tick_latency_p99")


def ref_tenant_queries(t):
    """Tenant ``t``'s query of the reference's service bench
    (``benchmarks/service_throughput.py:tenant_queries(t, 1)``), built with
    the reference's algebra; the port's is ``queries.tenant_queries``."""
    guard = ("R", "G", "H")[t % 3]
    if t % 2 == 0:
        conds = [JAtom(r, v) for r, v in zip("STUV", XYZW)]
    else:
        conds = [JAtom(r, "x") for r in "STUV"]
    return [JBSGF("Z0", XYZW, JAtom(guard, *XYZW), jall_of(*conds))]


J_TENANTS = [ref_tenant_queries(t) for t in range(4)]
T_TENANTS = [queries.tenant_queries(t) for t in range(4)]


def test_tenant_queries_are_the_reference_bench_mix():
    assert [repr(qs) for qs in T_TENANTS] == [repr(qs) for qs in J_TENANTS]


def _db_np():
    db = JQ.gen_db([q for qs in J_TENANTS for q in qs], n_guard=N, n_cond=N, seed=0)
    tdb = queries.gen_db([q for qs in T_TENANTS for q in qs], n_guard=N, n_cond=N, seed=0)
    assert db.keys() == tdb.keys()
    for k in db:
        np.testing.assert_array_equal(db[k], tdb[k])
    return db


def _poison(fault, reads):
    """Scripted fault: every job reading ``H`` (tenant 2's guard) fails
    those units, blamed on ``H``."""

    def hook(job, attempt):
        if "H" in reads(job):
            raise fault("poisoned guard H", rels={"H"})

    return hook


def _snapshot(svc, reqs, arr):
    c = svc.counters()
    return {
        "outputs": [
            {k: (arr(r.outputs[k].data), arr(r.outputs[k].valid)) for k in sorted(r.outputs)}
            for r in reqs
        ],
        "request_state": [
            (r.done, r.failures, r.retry_after, r.failed, r.tenant) for r in reqs
        ],
        "counters": {k: v for k, v in c.items() if k not in WALL_KEYS},
        "rel_epochs": dict(svc.catalog.rel_epochs),
        "last_tick": dict(svc.last_tick),
        "jobs_bytes": (
            (svc.last_report.n_jobs, svc.last_report.bytes_shuffled())
            if svc.last_report is not None else None
        ),
    }


def _drive(pkg, tenants, cat_kw, comm, config, fault, reads, arr):
    """One scripted session per package; a snapshot after every tick."""
    db = _db_np()
    snaps = {}
    svc = pkg.SGFService(pkg.catalog_from_numpy(db, P=P, **cat_kw), comm=comm(P))
    reqs = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    svc.tick()
    snaps["cold"] = _snapshot(svc, reqs, arr)
    reqs = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    svc.tick()
    snaps["warm"] = _snapshot(svc, reqs, arr)
    svc.catalog.register("BYSTANDER", np.arange(8, dtype=np.int32).reshape(4, 2))
    reqs = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    svc.tick()
    snaps["unrelated_register"] = _snapshot(svc, reqs, arr)
    svc.catalog.register("S", db["S"])
    reqs = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    svc.tick()
    snaps["dependent_register"] = _snapshot(svc, reqs, arr)

    svc = pkg.SGFService(
        pkg.catalog_from_numpy(db, P=P, **cat_kw), comm=comm(P),
        config=config(fail_policy="isolate"),
        retry_policy=pkg.RetryPolicy(max_failures=2, backoff_base=1, quarantine_ticks=3),
    )
    svc.on_job = _poison(fault, reads)
    reqs = [svc.submit(qs, tenant=t) for t, qs in enumerate(tenants)]
    svc.tick()
    snaps["retry"] = _snapshot(svc, reqs, arr)
    svc.tick()  # tenant 2's request is re-admitted and fails again
    snaps["quarantine"] = _snapshot(svc, reqs, arr)
    with pytest.raises(pkg.QuarantinedError):
        svc.submit(tenants[2], tenant=2)
    return snaps


@pytest.fixture(scope="module")
def runs():
    ref = _drive(jsvc, J_TENANTS, {}, JSimComm, JConfig, JFault, jjob_reads, np.asarray)
    port = _drive(tsvc, T_TENANTS, {"device": "cpu"}, SimComm, ExecutorConfig,
                  PermanentFault, job_reads, lambda t: t.numpy())
    return ref, port


STEPS = ("cold", "warm", "unrelated_register", "dependent_register", "retry", "quarantine")


@pytest.mark.parametrize("step", STEPS)
def test_outputs_match_reference(runs, step):
    ref, port = runs
    assert len(ref[step]["outputs"]) == len(port[step]["outputs"])
    for jout, tout in zip(ref[step]["outputs"], port[step]["outputs"]):
        assert jout.keys() == tout.keys()
        for k in jout:
            np.testing.assert_array_equal(jout[k][0], tout[k][0], err_msg=f"{step} {k} data")
            np.testing.assert_array_equal(jout[k][1], tout[k][1], err_msg=f"{step} {k} valid")


@pytest.mark.parametrize("step", STEPS)
def test_counters_and_epochs_match_reference(runs, step):
    ref, port = runs
    for key in ("counters", "rel_epochs", "last_tick", "jobs_bytes", "request_state"):
        assert ref[step][key] == port[step][key], key


def test_session_behaves_as_the_service_promises(runs):
    """The port's own session, read against the service's contracts (the
    reference's ``BENCH_serve.json`` acceptance block)."""
    _, port = runs
    cold = port["cold"]
    assert cold["jobs_bytes"][0] > 0 and cold["jobs_bytes"][1] > 0
    assert all(s[0] for s in cold["request_state"])
    for step in ("warm", "unrelated_register"):
        snap = port[step]
        assert snap["last_tick"]["cold_queries"] == 0
        assert snap["jobs_bytes"] is not None
        for out, cold_out in zip(snap["outputs"], cold["outputs"]):
            for k in out:
                assert np.array_equal(out[k][0], cold_out[k][0])
                assert np.array_equal(out[k][1], cold_out[k][1])
    dep = port["dependent_register"]
    assert dep["last_tick"]["warm_queries"] == 0 and dep["last_tick"]["cold_queries"] == 4
    assert dep["last_tick"]["x_injected"] > 0
    assert port["retry"]["request_state"][2][:2] == (False, 1)
    assert port["retry"]["counters"]["retries_scheduled"] == 1
    assert port["quarantine"]["request_state"][2][3] is True
    assert port["quarantine"]["counters"]["quarantines"] == 1
    # the three clean tenants were served in the poisoned tick
    assert [s[0] for s in port["retry"]["request_state"]] == [True, True, False, True]


def test_cold_tick_matches_oracle(runs):
    _, port = runs
    db = _db_np()
    setdb = {k: {tuple(map(int, r)) for r in v} for k, v in db.items()}
    for t, out in enumerate(port["cold"]["outputs"]):
        data, valid = out["Z0"]
        got = {tuple(int(v) for v in row) for row in data.reshape(-1, 4)[valid.reshape(-1)]}
        assert got == ref_engine.eval_bsgf(setdb, T_TENANTS[t][0])


def _batches():
    """Query batches for the fingerprint and canonical-form comparison."""
    fams = ["A1", "A3", "A5", "B1", "C2"]
    out = []
    for fam in fams:
        if fam.startswith("C"):
            out.append((fam, list(JQ.make_sgf(fam).queries), list(queries.make_sgf(fam).queries)))
        else:
            out.append((fam, JQ.make_queries(fam), queries.make_queries(fam)))
    out.append(("tenants", [q for qs in J_TENANTS for q in qs],
                [q for qs in T_TENANTS for q in qs]))
    out.append(("constants",
                [JBSGF("Out", ("a",), JAtom("R", "a", 3), JAtom("S", "a"))],
                [BSGF("Out", ("a",), Atom("R", "a", 3), Atom("S", "a"))]))
    return out


@pytest.mark.parametrize("label,jqs,tqs", _batches(), ids=lambda v: v if isinstance(v, str) else "")
def test_fingerprint_and_canonical_form_match_reference(label, jqs, tqs):
    assert jsvc.fingerprint_queries(jqs) == tsvc.fingerprint_queries(tqs)
    jc, jmap = jsvc.canonicalize(jqs)
    tc, tmap = tsvc.canonicalize(tqs)
    assert [repr(q) for q in jc] == [repr(q) for q in tc]
    assert jmap == tmap


def test_catalog_places_relations_on_its_device():
    from repro_torch.core.relation import Relation

    cat = tsvc.Catalog(P=2, device="cpu")
    assert cat.register("R", np.arange(8, dtype=np.int32).reshape(4, 2)).data.device.type == "cpu"
    assert cat.register("S", [(1,), (2,)]).valid.device.type == "cpu"
    rel = Relation.from_numpy("T", np.arange(6, dtype=np.int32).reshape(3, 2), P=2, device="cpu")
    assert cat.register("T2", rel).data is rel.data
    assert cat.device == torch.device("cpu")
    with pytest.raises(ValueError, match="'M' lies on meta, catalog on cpu$"):
        cat.register("M", Relation.empty("M", 1, P=2, device="meta"))
    with pytest.raises(ValueError, match="sharded P=1"):
        cat.register("T3", Relation.from_numpy("T3", np.zeros((2, 1)), device="cpu"))
