"""Port differential: the MSJ operator and the EVAL operator.

``repro_torch.core.msj.run_msj`` (with the port's bucketed probe, which
takes its plain band compare on CPU tensors) against ``repro``'s
``run_msj`` on the same sharded state (``db_from_reference``): the A1–A5
and B2 families and a two-column-key query (hashed fingerprints), packing
× fingerprint on and off, an undersized
``forward_cap`` (exact overflow), a forced skew route, the bloom
prefilter, the unbucketed all-pairs probe as ``probe_fn``, the
transfer + compute split, the count phase, the salt-table sketch and
``run_eval``.  Outputs (``data``, ``valid``) and every stat must be equal;
exact equality, since every value is an int32 or a bool.

The reference runs under ``jax.jit`` with an explicit ``forward_cap``
(its count phase reads a device value on the host, so it cannot be
traced); the port gets the same cap, and the count phase is compared on
its own.  On the CPU the reference's cost is compile time, and one traced
program compiles several times faster than its operations one by one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import msj as jmsj  # noqa: E402
from repro.core import queries as Q  # noqa: E402
from repro.core import algebra as jalg  # noqa: E402
from repro.core.algebra import semijoins_of  # noqa: E402
from repro.core.eval_op import EvalUnit as JEvalUnit, run_eval as jrun_eval  # noqa: E402
from repro.core.relation import db_from_dict as jdb_from_dict  # noqa: E402
from repro.engine.comm import SimComm as JSimComm  # noqa: E402
from repro_torch.core import algebra as talg  # noqa: E402
from repro_torch.core import msj  # noqa: E402
from repro_torch.core.eval_op import EvalUnit, run_eval  # noqa: E402
from repro_torch.core.relation import db_from_reference  # noqa: E402
from repro_torch.engine.comm import SimComm  # noqa: E402
from repro_torch.kernels.msj_probe import ops  # noqa: E402

P = 2
N = 96
CAP = 400  # forward bucket capacity: no overflow at N rows per relation


def _dbs(db_np):
    jdb = jdb_from_dict(db_np, P=P)
    tdb = db_from_reference(
        {k: (np.asarray(r.data), np.asarray(r.valid)) for k, r in jdb.items()},
        device="cpu",
    )
    return jdb, tdb


def _family(qid, seed=0):
    if qid == "wide":  # two-column keys: hashed (not exact) fingerprints
        xyzw = ("x", "y", "z", "w")
        qs = [jalg.BSGF("Z", xyzw, jalg.Atom("R", *xyzw),
                        jalg.all_of(jalg.Atom("S", "x", "y"), jalg.Atom("T", "y", "z")))]
        rng = np.random.default_rng(seed)
        db_np = {"R": rng.integers(0, 8, (N, 4)).astype(np.int32),
                 "S": rng.integers(0, 8, (N, 2)).astype(np.int32),
                 "T": rng.integers(0, 8, (N, 2)).astype(np.int32)}
        return [sj for q in qs for sj in semijoins_of(q)], _dbs(db_np)
    qs = Q.make_queries(qid)
    sjs = [sj for q in qs for sj in semijoins_of(q)]
    return sjs, _dbs(Q.gen_db(qs, n_guard=N, n_cond=N, seed=seed))


def assert_rels_equal(want: dict, got: dict):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k].data), got[k].data.numpy(), err_msg=k)
        np.testing.assert_array_equal(np.asarray(want[k].valid), got[k].valid.numpy(), err_msg=k)


def assert_stats_equal(want: dict, got: dict):
    assert set(want) == set(got)
    assert {k: int(v) for k, v in want.items()} == {k: int(v) for k, v in got.items()}


def _both(sjs, dbs, **kw):
    jdb, tdb = dbs
    kw.setdefault("forward_cap", CAP)
    want = jax.jit(lambda d: jmsj.run_msj(d, sjs, JSimComm(P), **kw))(jdb)
    got = msj.run_msj(tdb, sjs, SimComm(P), probe_fn=ops.probe_bucketed, **kw)
    assert_rels_equal(want[0], got[0])
    assert_stats_equal(want[1], got[1])
    return got


@pytest.mark.parametrize("qid", ["A1", "A2", "A3", "A4", "A5", "B2", "wide"])
def test_run_msj_families(qid):
    sjs, dbs = _family(qid)
    _, stats = _both(sjs, dbs)
    assert int(stats["hits"]) > 0 and int(stats["overflow"]) == 0


@pytest.mark.parametrize("qid,packing,fingerprint", [
    ("A3", False, True),    # exact fingerprints, one message per request
    ("wide", True, False),  # the seed layout, deduplicated by key
    ("wide", False, False),
])
def test_run_msj_packing_fingerprint(qid, packing, fingerprint):
    sjs, dbs = _family(qid)
    _both(sjs, dbs, packing=packing, fingerprint=fingerprint)


def test_run_msj_forward_cap_overflow():
    sjs, dbs = _family("A3")
    _, stats = _both(sjs, dbs, forward_cap=7)
    assert int(stats["overflow"]) > 0


def test_run_msj_count_phase_and_default_cap():
    sjs, (jdb, tdb) = _family("A3")
    for packing in (True, False):
        jspec, tspec = jmsj.make_spec(sjs), msj.make_spec(sjs)
        want = jmsj.count_forward_cap(jspec, jdb, JSimComm(P), packing=packing)
        assert msj.count_forward_cap(tspec, tdb, SimComm(P), packing=packing) == want
        assert msj.default_forward_cap(tspec, tdb, P) == jmsj.default_forward_cap(
            jspec, jdb, P
        )


def _skewed():
    rng = np.random.default_rng(4)
    ranks = np.arange(1, 17, dtype=np.float64) ** -1.5
    R = np.stack([rng.choice(16, size=N, p=ranks / ranks.sum()),
                  rng.integers(0, 1 << 16, N)], axis=1).astype(np.int32)
    S = np.stack([rng.integers(0, 16, N // 2), rng.integers(0, 1 << 16, N // 2)],
                 axis=1).astype(np.int32)
    q = jalg.BSGF("Z", ("x", "y"), jalg.Atom("R", "x", "y"), jalg.Atom("S", "x", "w"))
    return semijoins_of(q), _dbs({"R": R, "S": S})


def test_run_msj_forced_skew_route():
    sjs, (jdb, tdb) = _skewed()
    table_j = jmsj.collect_salt_table(jdb, sjs, R=2, threshold=4)
    table_t = msj.collect_salt_table(tdb, sjs, R=2, threshold=4)
    assert table_t == msj.SaltTable(table_j.R, table_j.threshold, table_j.counts)
    jroute = jmsj.skew_route_of(table_j, jmsj.make_spec(sjs))
    troute = msj.skew_route_of(table_t, msj.make_spec(sjs))
    assert any(troute.hot) and troute.hot == jroute.hot
    want = jax.jit(lambda d: jmsj.run_msj(d, sjs, JSimComm(P), packing=False,
                                          skew=jroute, forward_cap=CAP))(jdb)
    got = msj.run_msj(tdb, sjs, SimComm(P), packing=False, skew=troute,
                      probe_fn=ops.probe_bucketed, forward_cap=CAP)
    assert_rels_equal(want[0], got[0])
    assert_stats_equal(want[1], got[1])
    assert int(got[1]["replicated"]) > 0


def test_transfer_compute_split_equals_inline():
    sjs, (jdb, tdb) = _family("A3")
    inline_out, inline_stats = msj.run_msj(tdb, sjs, SimComm(P), probe_fn=ops.probe_bucketed)
    buf, xs = msj.run_msj_transfer("%xfer0", tdb, sjs, SimComm(P))
    out, cs = msj.run_msj_compute(tdb, buf, SimComm(P), probe_fn=ops.probe_bucketed)
    assert set(out) == set(inline_out)
    for k, rel in out.items():
        assert torch.equal(rel.data, inline_out[k].data)
        assert torch.equal(rel.valid, inline_out[k].valid)

    def ref_split(d):
        jbuf, jxs = jmsj.run_msj_transfer("%xfer0", d, sjs, JSimComm(P),
                                          forward_cap=buf.cap)
        return jxs, jmsj.run_msj_compute(d, jbuf, JSimComm(P))

    jxs, (jout, jcs) = jax.jit(ref_split)(jdb)
    jxs["bytes_fwd"] = jxs["bytes_fwd"] + P * P * 4  # the port counted
    assert_rels_equal(jout, out)
    assert_stats_equal(jxs, xs)
    assert_stats_equal(jcs, cs)
    for k in ("sent_fwd", "bytes_fwd", "overflow", "forward_cap"):
        assert int(xs[k]) == int(inline_stats[k])
    for k in ("hits", "recv_fwd", "bytes_bwd"):
        assert int(cs[k]) == int(inline_stats[k])


@pytest.mark.parametrize("bloom_bits", [256, 4096])
@pytest.mark.parametrize("packing,fingerprint", [
    (True, True), (False, True), (True, False), (False, False),
])
def test_run_msj_bloom_matches_reference(bloom_bits, packing, fingerprint):
    """The bloom prefilter drops Req rows before the packing dedup: the
    elected leaders, and so every array and counter, match the
    reference's."""
    sjs, dbs = _family("A3")
    _both(sjs, dbs, bloom_bits=bloom_bits, packing=packing, fingerprint=fingerprint)


def test_bloom_transfer_compute_split_equals_inline():
    sjs, (_, tdb) = _family("A3")
    inline_out, inline_stats = msj.run_msj(tdb, sjs, SimComm(P), bloom_bits=256,
                                           probe_fn=ops.probe_bucketed)
    buf, xs = msj.run_msj_transfer("%xfer0", tdb, sjs, SimComm(P), bloom_bits=256)
    assert buf.bloom_bits == 256
    out, cs = msj.run_msj_compute(tdb, buf, SimComm(P), probe_fn=ops.probe_bucketed)
    assert set(out) == set(inline_out)
    for k, rel in out.items():
        assert torch.equal(rel.data, inline_out[k].data)
        assert torch.equal(rel.valid, inline_out[k].valid)
    for k in ("sent_fwd", "bytes_fwd", "overflow", "forward_cap"):
        assert int(xs[k]) == int(inline_stats[k])
    for k in ("hits", "recv_fwd", "bytes_bwd"):
        assert int(cs[k]) == int(inline_stats[k])


@pytest.mark.parametrize("qid", ["A3", "wide"])
def test_bloom_prefilter_equivalent(qid):
    """The port's counterpart of the reference's bloom equivalence test:
    the same outputs with and without the prefilter, no more forward
    bytes, and the same count-sized forward capacity (the count phase
    ignores the filter)."""
    sjs, (_, tdb) = _family(qid)
    out0, s0 = msj.run_msj(tdb, sjs, SimComm(P), probe_fn=ops.probe_bucketed)
    out1, s1 = msj.run_msj(tdb, sjs, SimComm(P), bloom_bits=4096,
                           probe_fn=ops.probe_bucketed)
    for k in out0:
        assert torch.equal(out0[k].data, out1[k].data)
        assert torch.equal(out0[k].valid, out1[k].valid)
    assert int(s1["bytes_fwd"]) <= int(s0["bytes_fwd"])
    assert int(s1["forward_cap"]) == int(s0["forward_cap"])
    assert int(s1["hits"]) == int(s0["hits"])


@pytest.mark.parametrize("qid", ["A3", "wide"])
def test_run_msj_blocked_probe_matches_reference(qid):
    """The unbucketed all-pairs probe as a drop-in ``probe_fn``: equal to
    the reference's default run (its sort-merge probe)."""
    sjs, (jdb, tdb) = _family(qid)
    want = jax.jit(lambda d: jmsj.run_msj(d, sjs, JSimComm(P), forward_cap=CAP))(jdb)
    got = msj.run_msj(tdb, sjs, SimComm(P), probe_fn=ops.probe, forward_cap=CAP)
    assert_rels_equal(want[0], got[0])
    assert_stats_equal(want[1], got[1])


def test_run_eval_matches_reference():
    rng = np.random.default_rng(9)
    db_np = {
        "X0": rng.integers(0, 6, (N, 2)).astype(np.int32),
        "X1": rng.integers(0, 6, (N // 2, 2)).astype(np.int32),
        "X2": rng.integers(0, 6, (N // 3, 2)).astype(np.int32),
    }
    jdb, tdb = _dbs(db_np)

    def units(alg, cls):
        a1, a2 = alg.Atom("S", "x", "y"), alg.Atom("T", "x", "y")
        return [cls("Z", "X0", ("X1", "X2"), (a1, a2), alg.And(a1, alg.Not(a2)), (1,), 11),
                cls("Y", "X1", ("X2",), (a2,), a2, None, None)]

    want = jax.jit(lambda d: jrun_eval(d, units(jalg, JEvalUnit), JSimComm(P)))(jdb)
    got = run_eval(tdb, units(talg, EvalUnit), SimComm(P))
    assert_rels_equal(want[0], got[0])
    assert_stats_equal(want[1], got[1])
