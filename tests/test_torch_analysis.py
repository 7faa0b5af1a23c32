"""Port differential: the plan verifier, the schedule sanitizer and the
``python -m repro_torch.analysis`` gate.

* Every plan of the ``--corpus`` (BSGF families under PAR / GREEDY / SEQ /
  1-ROUND, SGF families under the four SGF strategies, fused service
  batches), each with its overlap, skew and skew+overlap DAGs, gets the
  reference's plan and the reference's findings.
* ``--mutate N`` prints the reference's kill counts for the same seed.
* The online sanitizer is clean on a port async walk (plain, and a chaos
  walk with speculation and a poisoned branch) with outputs bit-identical
  to the unsanitized walk, and on a corrupted schedule (a deleted
  load-bearing DAG edge raced by LPT estimates) raises with the
  reference's findings; the offline audits of a corrupted report and a
  corrupted trace give the reference's findings too.
"""
import copy
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import analysis as janalysis  # noqa: E402
from repro.analysis import __main__ as jcli  # noqa: E402
from repro.core.algebra import Atom as JAtom, BSGF as JBSGF, all_of as jall_of  # noqa: E402
from repro.core.executor import (  # noqa: E402
    Executor as JExecutor,
    ExecutorConfig as JConfig,
    PermanentFault as JFault,
    JobRecord as JJobRecord,
    Report as JReport,
)
from repro.core import planner as jplanner  # noqa: E402
from repro.core.relation import db_from_dict as jdb_from_dict  # noqa: E402
from repro.engine.comm import SimComm as JSimComm  # noqa: E402
from repro.obs.perfetto import audit_trace as jaudit_trace  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.algebra import Atom, BSGF, all_of  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    Executor,
    ExecutorConfig,
    JobRecord,
    PermanentFault,
    Report,
)
from repro_torch.core.relation import db_from_dict  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402
from repro_torch.obs.perfetto import audit_trace  # noqa: E402

P = 2
XY = ("x", "y")
DATA = pathlib.Path(__file__).parent / "data"


def _key(findings):
    return [(f.severity, f.rule, f.job, f.rels, f.message) for f in findings]


# --------------------------------------------------------------------------
# the corpus
# --------------------------------------------------------------------------


def _dag_findings(mod, plan, schema, canonical):
    """Findings of one plan under the four DAG shapes ``--corpus`` checks."""
    a = janalysis if mod is jplanner else analysis
    out = [_key(a.verify_plan(plan, schema=schema, canonical=canonical))]
    out.append(_key(a.verify_plan(
        plan, schema=schema, canonical=canonical,
        nodes=mod.job_dag(plan, edges="relations", overlap=True))))
    skewed = mod.annotate_skew(plan, None, 4, packing=False, force_R=2)
    for ov in (False, True):
        out.append(_key(a.verify_plan(
            skewed, schema=schema, canonical=canonical,
            nodes=mod.job_dag(skewed, edges="relations", overlap=ov, skew=True))))
    return out


@pytest.fixture(scope="module")
def corpora():
    ref = [(label, repr(plan.rounds), _dag_findings(jplanner, plan, schema, canonical))
           for label, plan, schema, canonical in jcli.corpus()]
    port = [(label, repr(plan.rounds), _dag_findings(planner, plan, schema, canonical))
            for label, plan, schema, canonical in cli.corpus()]
    return ref, port


GROUPS = cli._BSGF_IDS + cli._SGF_IDS + tuple("svc:" + "+".join(q) for q in cli._FUSED)


@pytest.mark.parametrize("group", GROUPS)
def test_corpus_plans_and_findings_match_reference(corpora, group):
    ref, port = corpora
    assert [r[0] for r in ref] == [p[0] for p in port]
    mine = [i for i, r in enumerate(ref) if r[0].split("/")[0] == group]
    assert mine, group
    for i in mine:
        assert ref[i][1] == port[i][1], ref[i][0]
        assert ref[i][2] == port[i][2], ref[i][0]
        assert all(f == [] or all(x[0] != "error" for x in f) for f in port[i][2])


def test_corpus_cli_clean(capsys):
    assert cli.main(["--corpus"]) == 0
    assert "192 plans verified, 0 error findings" in capsys.readouterr().out


def test_mutate_kill_counts_match_reference(capsys):
    rc_ref = jcli.run_mutate(60, 7)
    out_ref = capsys.readouterr().out
    rc = cli.main(["--mutate", "60", "--seed", "7"])
    out = capsys.readouterr().out
    assert rc == rc_ref == 0
    assert out == out_ref
    assert "corruptions: 60/60 killed" in out


# --------------------------------------------------------------------------
# the online sanitizer on port async walks
# --------------------------------------------------------------------------


def _fused(mod, q):
    sjs, _ = mod.pooled_semijoins([q])
    return mod.MSJJob(tuple(sjs), fused=(q,))


def _chain_plan(mod, atom, bsgf, all_of_):
    """``tests/test_analysis.py:chain_plan``: Z written twice (WAW), then
    read (RAW); every edge is load-bearing."""
    za = bsgf("Z", XY, atom("G", *XY), all_of_(atom("S", "x")))
    zb = bsgf("Z", XY, atom("G", *XY), all_of_(atom("T", "x")))
    c = bsgf("C", XY, atom("Z", *XY), all_of_(atom("S", "x")))
    return mod.Plan((
        mod.Round((_fused(mod, za),)), mod.Round((_fused(mod, zb),)),
        mod.Round((_fused(mod, c),)),
    ))


def _chain_db():
    rng = np.random.default_rng(0)
    return {
        "G": rng.integers(0, 32, (64, 2)).astype(np.int32),
        "S": np.arange(0, 16, dtype=np.int32).reshape(-1, 1),
        "T": np.arange(8, 24, dtype=np.int32).reshape(-1, 1),
    }


def _delete_dep(nodes, idx, dep):
    return tuple(
        dataclasses.replace(n, deps=tuple(d for d in n.deps if d != dep))
        if n.idx == idx else n
        for n in nodes
    )


#: LPT costs that race the mutated chain (``tests/test_analysis.py``)
_RACY_EST = {0: 1.0, 1: 5.0, 2: 0.5}


def _port_executor(sanitize=False, db_np=None, **kw):
    cfg = ExecutorConfig(execution_mode="async", dag_edges="relations",
                         sanitize=sanitize, **kw)
    return Executor(dict(db_from_dict(db_np or _chain_db(), P=P, device="cpu")),
                    SimComm(P), cfg)


def test_sanitizer_clean_on_port_walk_bit_identical():
    plan = _chain_plan(planner, Atom, BSGF, all_of)
    env0, rep0 = _port_executor().execute(plan, slots=2)
    ex = _port_executor(sanitize=True)
    env1, rep1 = ex.execute(plan, slots=2)
    assert ex.last_sanitize == []
    for name in ("Z", "C"):
        assert torch.equal(env1[name].data, env0[name].data)
        assert torch.equal(env1[name].valid, env0[name].valid)
    assert [r.outcome for r in rep1.records] == [r.outcome for r in rep0.records]
    assert analysis.sanitize_report(rep1) == []


def test_sanitizer_clean_on_port_chaos_walk():
    rng = np.random.default_rng(1)
    db_np = _chain_db()
    db_np["PG"] = rng.integers(0, 32, (64, 2)).astype(np.int32)
    z0 = BSGF("Z0", XY, Atom("G", *XY), all_of(Atom("S", "x")))
    pz = BSGF("PZ", XY, Atom("PG", *XY), all_of(Atom("S", "x")))
    d0 = BSGF("D0", XY, Atom("Z0", *XY), all_of(Atom("T", "x")))
    dp = BSGF("DP", XY, Atom("PZ", *XY), all_of(Atom("T", "x")))
    plan = planner.Plan((
        planner.Round((_fused(planner, z0), _fused(planner, pz))),
        planner.Round((_fused(planner, d0), _fused(planner, dp))),
    ))

    def poison(job, attempt):
        if "PG" in planner.job_reads(job):
            raise PermanentFault("poisoned guard", rels={"PG"})

    runs = []
    for sanitize in (False, True):
        ex = _port_executor(sanitize, db_np, speculate=True, spec_factor=1.5,
                            fail_policy="isolate")
        env, rep = ex.execute(plan, slots=2, on_job=poison)
        runs.append((env, rep, ex))
    (env0, _, _), (env1, rep1, ex) = runs
    assert any(r.outcome == "tainted" for r in rep1.records)
    assert ex.last_sanitize == []
    for name in ("Z0", "D0"):
        assert torch.equal(env1[name].data, env0[name].data)
        assert torch.equal(env1[name].valid, env0[name].valid)
    assert analysis.sanitize_report(rep1) == []


def test_sanitizer_race_gives_reference_findings():
    jplan = _chain_plan(jplanner, JAtom, JBSGF, jall_of)
    jex = JExecutor(dict(jdb_from_dict(_chain_db(), P=P)), JSimComm(P),
                    JConfig(execution_mode="async", dag_edges="relations", sanitize=True))
    with pytest.raises(janalysis.SanitizerError) as jerr:
        jex.execute(jplan, slots=1, est=dict(_RACY_EST),
                    nodes=_delete_dep(jplanner.job_dag(jplan, edges="relations"), 1, 0))
    plan = _chain_plan(planner, Atom, BSGF, all_of)
    ex = _port_executor(sanitize=True)
    with pytest.raises(analysis.SanitizerError) as err:
        ex.execute(plan, slots=1, est=dict(_RACY_EST),
                   nodes=_delete_dep(planner.job_dag(plan, edges="relations"), 1, 0))
    assert "unordered-conflict" in {f.rule for f in err.value.findings}
    assert err.value.findings == ex.last_sanitize
    assert _key(err.value.findings) == _key(jerr.value.findings)


def _overlapping(record_cls, report_cls, job_a, job_b):
    """Two conflicting records on one slot whose intervals overlap, and a
    record whose end is not start + wall."""
    return report_cls([
        record_cls(job_a, 0, 2.0, {}, start=0.0, end=2.0, slot=0),
        record_cls(job_b, 0, 2.0, {}, start=1.0, end=3.0, slot=0),
        record_cls(job_b, 1, 1.0, {}, start=3.0, end=5.0, slot=1),
    ])


def test_offline_audits_of_corrupted_schedules_match_reference():
    jplan = _chain_plan(jplanner, JAtom, JBSGF, jall_of)
    plan = _chain_plan(planner, Atom, BSGF, all_of)
    jrep = _overlapping(JJobRecord, JReport, jplan.rounds[0].jobs[0], jplan.rounds[1].jobs[0])
    trep = _overlapping(JobRecord, Report, plan.rounds[0].jobs[0], plan.rounds[1].jobs[0])
    found = analysis.sanitize_report(trep)
    assert analysis.errors(found)
    assert _key(found) == _key(janalysis.sanitize_report(jrep))

    doc = json.loads((DATA / "golden_straggler.trace.json").read_text())
    assert audit_trace(doc) == jaudit_trace(doc) == []
    bad = copy.deepcopy(doc)
    jobs = [e for e in bad["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "job"]
    jobs[1]["tid"], jobs[1]["ts"] = jobs[0]["tid"], jobs[0]["ts"]
    found = audit_trace(bad)
    assert analysis.errors(found)
    assert _key(found) == _key(jaudit_trace(bad))
