"""Port differential: the metric registry and the Perfetto exporter.

* The same sequence of metric operations, applied to a
  ``repro.obs.MetricRegistry`` and a ``repro_torch.obs.MetricRegistry``,
  gives equal snapshots and equal JSONL text; ``FTStats`` over both
  registries agrees.
* The reference's golden straggler report (``tests/test_perfetto.py``),
  built from the port's ``JobRecord``/``Span``/job classes, exports exactly
  the events of ``tests/data/golden_straggler.trace.json``; the golden file
  validates, audits clean and replays bit-exactly through the port.
* A traced, metered port execute publishes the reference's counters and
  exports a trace that validates, audits clean and replays bit-exactly.
"""
from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import obs as jobs  # noqa: E402
from repro.core import queries as JQ  # noqa: E402
from repro.core.algebra import Atom as JAtom, BSGF as JBSGF, all_of as jall_of  # noqa: E402
from repro.core.costmodel import stats_of_db as jstats_of_db  # noqa: E402
from repro.core.executor import Executor as JExecutor  # noqa: E402
from repro.core.planner import plan_greedy as jplan_greedy  # noqa: E402
from repro.core.relation import db_from_dict as jdb_from_dict  # noqa: E402
from repro.engine.comm import SimComm as JSimComm  # noqa: E402
from repro.ft.supervisor import FTStats as JFTStats  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.algebra import Atom, BSGF, SemiJoin, all_of  # noqa: E402
from repro_torch.core.costmodel import stats_of_db  # noqa: E402
from repro_torch.core.executor import COMM_SLOT, Executor, JobRecord, Report  # noqa: E402
from repro_torch.core.planner import (  # noqa: E402
    ComputeJob,
    MSJJob,
    SkewProfileJob,
    TransferJob,
    plan_greedy,
)
from repro_torch.core.relation import db_from_reference  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402
from repro_torch.ft.supervisor import FTStats  # noqa: E402
from repro_torch.obs.tracer import Span  # noqa: E402
from test_torch_models import one_thread  # noqa: E402, F401

GOLDEN = Path(__file__).parent / "data" / "golden_straggler.trace.json"


# --------------------------------------------------------------------------
# metric registry
# --------------------------------------------------------------------------


def _metric_ops(seed: int):
    """A seeded mixed sequence of registry operations."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(400):
        kind = int(rng.integers(5))
        name = f"m.{int(rng.integers(4))}"
        if kind == 0:
            ops.append(("counter", "c." + name, "inc", 1))
        elif kind == 1:
            ops.append(("counter", "c." + name, "add", int(rng.integers(0, 1 << 20))))
        elif kind == 2:
            ops.append(("gauge", "g." + name, "set", float(rng.normal())))
        else:
            v = 0.0 if kind == 3 and rng.random() < 0.2 else float(rng.lognormal(-3, 2))
            ops.append(("histogram", "h." + name, "observe", v))
    return ops


def _apply(registry, ops):
    for kind, name, method, v in ops:
        getattr(getattr(registry, kind)(name), method)(v)
    return registry


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_jsonl_text_match_reference(seed):
    ops = _metric_ops(seed)
    jm, tm = _apply(jobs.MetricRegistry(), ops), _apply(obs.MetricRegistry(), ops)
    assert jm.snapshot() == tm.snapshot()
    assert jm.names() == tm.names()
    for name in jm.names():
        if name.startswith("h."):
            for p in (0.0, 0.5, 0.95, 0.99, 1.0):
                assert jm.histogram(name).percentile(p) == tm.histogram(name).percentile(p)
    texts = []
    for pkg, m in ((jobs, jm), (obs, tm)):
        buf = io.StringIO()
        with pkg.JsonlSink(buf) as sink:
            sink.write({"tick": 1}, extra="x")
            sink.write_registry(m, tick=2)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]


def test_ftstats_match_reference():
    stats = []
    for cls in (JFTStats, FTStats):
        st = cls()
        st.retries += 2
        st.capacity_retries += 1
        st.shard_losses += 3
        st.shard_recoveries = 3
        stats.append(st)
    assert stats[0].as_dict() == stats[1].as_dict()
    assert repr(stats[0]) == repr(stats[1])
    assert stats[0].metrics.snapshot() == stats[1].metrics.snapshot()


# --------------------------------------------------------------------------
# golden straggler trace
# --------------------------------------------------------------------------


def _mk_job(out: str, guard_rel: str, cond_rel: str) -> MSJJob:
    return MSJJob(
        (SemiJoin(out, ("x",), Atom(guard_rel, "x"), Atom(cond_rel, "x")),)
    )


def straggler_report() -> Report:
    """The golden report of ``tests/test_perfetto.py:straggler_report``,
    field for field, from the port's classes."""
    big = _mk_job("XB", "RBIG", "S")
    shorts = [_mk_job(f"X{i}", f"G{i}", "S") for i in range(1, 4)]
    dep = _mk_job("XD", "X1", "T")
    spec = _mk_job("XS", "XB", "T")
    hot = _mk_job("XK", "RHOT", "S")
    recs = [
        JobRecord(big, 0, 4.0, {"bytes_fwd": 4096, "bytes_bwd": 512},
                  backend="sorted", start=0.0, end=4.0, slot=0,
                  spans=[Span("msj.shuffle.fwd", t0=0.0, dur=1.5,
                              args={"bytes": 4096}),
                         Span("msj.probe", t0=1.5, dur=2.0,
                              args={"hits": 77}),
                         Span("msj.scatter", t0=3.5, dur=0.5,
                              args={"bytes": 512})]),
        JobRecord(shorts[0], 0, 1.0, {}, start=0.0, end=1.0, slot=1),
        JobRecord(shorts[1], 0, 1.0, {}, start=1.0, end=2.0, slot=1),
        JobRecord(shorts[2], 0, 1.0, {}, start=2.0, end=3.0, slot=1),
        JobRecord(SkewProfileJob(hot, "%salt0"), 0, 0.5, {},
                  start=0.0, end=0.5, slot=2),
        JobRecord(TransferJob(hot, "%xfer0", "%salt0"), 0, 1.0,
                  {"bytes_fwd": 1024}, start=0.5, end=1.5, slot=COMM_SLOT),
        JobRecord(ComputeJob(hot, "%xfer0"), 0, 1.0, {"bytes_bwd": 128},
                  backend="sorted", start=1.5, end=2.5, slot=2),
        JobRecord(dep, 1, 2.0, {}, start=3.0, end=5.0, slot=1),
        JobRecord(spec, 1, 1.5, {}, start=4.0, end=5.5, slot=0,
                  attempt=0, cancelled=True, outcome="cancelled"),
        JobRecord(spec, 1, 0.5, {}, start=5.0, end=5.5, slot=1,
                  attempt=1, speculative=True),
    ]
    return Report(recs)


def test_golden_straggler_events_exact():
    events = obs.trace_events(straggler_report(), title="straggler")
    golden = json.loads(GOLDEN.read_text())
    assert events == golden["traceEvents"]


def test_golden_validates_audits_and_replays():
    golden = json.loads(GOLDEN.read_text())
    assert obs.validate_trace(golden) == []
    assert obs.audit_trace(golden) == []
    rep, rep2 = straggler_report(), obs.report_from_trace(golden)
    assert rep2.total_time == rep.total_time
    assert rep2.net_time == rep.net_time
    for W in (None, 1, 2, 3):
        assert rep2.net_time_by_events(W) == rep.net_time_by_events(W)


def test_write_trace_and_phase_breakdown_match_reference(tmp_path):
    from repro.core.executor import JobRecord as JJobRecord, Report as JReport
    from repro.obs.tracer import Span as JSpan

    def jrep():
        recs = [
            JJobRecord(None, 0, 4.0, {}, backend="sorted", start=0.0, end=4.0, slot=0,
                       spans=[JSpan("msj.probe", t0=0.0, dur=2.0, args={"bytes": 10}),
                              JSpan("msj.scatter", t0=2.0, dur=1.0, args={"bytes": 5})]),
            JJobRecord(None, 0, 1.0, {}, start=0.0, end=1.0, slot=1),
        ]
        return JReport(recs)

    def trep():
        recs = [
            JobRecord(None, 0, 4.0, {}, backend="sorted", start=0.0, end=4.0, slot=0,
                      spans=[Span("msj.probe", t0=0.0, dur=2.0, args={"bytes": 10}),
                             Span("msj.scatter", t0=2.0, dur=1.0, args={"bytes": 5})]),
            JobRecord(None, 0, 1.0, {}, start=0.0, end=1.0, slot=1),
        ]
        return Report(recs)

    docs = []
    for pkg, rep, tag in ((jobs, jrep(), "ref"), (obs, trep(), "port")):
        m = pkg.MetricRegistry()
        m.counter("msj.jobs").add(2)
        path = pkg.write_trace(str(tmp_path / f"{tag}.trace.json"), rep, metrics=m)
        docs.append(json.loads(Path(path).read_text()))
        assert pkg.phase_breakdown(rep) == jobs.phase_breakdown(jrep())
    assert docs[0] == docs[1]


# --------------------------------------------------------------------------
# a traced, metered port execute
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced_runs():
    jq = JBSGF("Z", ("x", "y"), JAtom("R", "x", "y"),
               jall_of(JAtom("S", "x"), JAtom("T", "y")))
    tq = BSGF("Z", ("x", "y"), Atom("R", "x", "y"),
              all_of(Atom("S", "x"), Atom("T", "y")))
    db_np = JQ.gen_db([jq], n_guard=96, n_cond=64)
    jdb = jdb_from_dict(db_np, P=2)
    tdb = db_from_reference(
        {k: (np.asarray(r.data), np.asarray(r.valid)) for k, r in jdb.items()},
        device="cpu",
    )
    jm, tm = jobs.MetricRegistry(), obs.MetricRegistry()
    jenv, jrep = JExecutor(dict(jdb), JSimComm(2), tracer=jobs.Tracer(),
                           metrics=jm).execute(jplan_greedy([jq], jstats_of_db(jdb)))
    tenv, trep = Executor(dict(tdb), SimComm(2), tracer=obs.Tracer(),
                          metrics=tm).execute(plan_greedy([tq], stats_of_db(tdb)))
    return (jenv, jrep, jm), (tenv, trep, tm)


def test_traced_execute_publishes_reference_counters(traced_runs):
    (jenv, jrep, jm), (tenv, trep, tm) = traced_runs
    np.testing.assert_array_equal(np.asarray(jenv["Z"].data), tenv["Z"].data.numpy())
    np.testing.assert_array_equal(np.asarray(jenv["Z"].valid), tenv["Z"].valid.numpy())
    js, ts = jm.snapshot(), tm.snapshot()
    assert js.keys() == ts.keys()
    for k in js:
        if k == "msj.job.wall":  # measured walls: only the count carries over
            assert js[k]["count"] == ts[k]["count"]
        else:
            assert js[k] == ts[k], k
    for r in trep.records:
        assert r.spans and r.spans[0].name == "ft.attempt"


def test_traced_execute_trace_validates_and_replays(traced_runs):
    _, (_, trep, tm) = traced_runs
    doc = json.loads(json.dumps({"traceEvents": obs.trace_events(trep),
                                 "otherData": {"metrics": tm.snapshot()}}))
    assert obs.validate_trace(doc) == []
    assert obs.audit_trace(doc) == []
    rep2 = obs.report_from_trace(doc)
    assert rep2.total_time == trep.total_time
    assert rep2.net_time == trep.net_time
    for W in (None, 1, 2):
        assert rep2.net_time_by_events(W) == trep.net_time_by_events(W)
    assert set(obs.phase_breakdown(trep)) >= {"ft.attempt", "msj.probe"}
