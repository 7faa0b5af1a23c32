"""The benchmark's reference: the plain evaluator on hand-worked cases of
the paper's Table 2 queries, the device data generator and the control's
approximate semi-join.

    python -m pytest bench/tests -q
"""
import itertools
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

torch = pytest.importorskip("torch")

from bench.reference import approx, datagen, semijoin  # noqa: E402

XYZW = ["x", "y", "z", "w"]


def star(guard, conds, head=XYZW, name="Z"):
    return {"name": name, "head": list(head), "guard": [guard] + XYZW,
            "where": {"and": [list(c) for c in conds]}}


A1 = star("R", [("S", "x"), ("T", "y"), ("U", "z"), ("V", "w")])
A2 = star("R", [("S", v) for v in XYZW])
A3 = star("R", [(r, "x") for r in "STUV"])
B1 = star("R", [(r, v) for v in XYZW for r in "STUV"])


def only(a, rest):
    return {"and": [[a, "x"]] + [{"not": [b, "x"]} for b in rest]}


B2 = {"name": "Z", "head": XYZW, "guard": ["R"] + XYZW,
      "where": {"or": [only(a, [b for b in "STUV" if b != a]) for a in "STUV"]}}


def rels_of(db):
    return {k: torch.tensor(v, dtype=torch.int32).reshape(len(v), -1) for k, v in db.items()}


def rows(t):
    return {tuple(int(v) for v in r) for r in t.tolist()}


# --------------------------------------------------------------------------
# hand-worked cases
# --------------------------------------------------------------------------

HAND = {
    "R": [(1, 2, 3, 4), (2, 2, 3, 4), (3, 1, 1, 1), (4, 4, 4, 4), (1, 9, 9, 9), (1, 2, 3, 4),
          (5, 0, 0, 0), (6, 0, 0, 0)],
    "S": [(1,), (2,), (4,)],
    "T": [(1,), (2,), (3,)],
    "U": [(1,), (3,), (4,)],
    "V": [(1,), (2,), (3,), (4,), (5,)],
}


@pytest.mark.parametrize("query,want", [
    # A3: x in S, T, U and V: only x = 1; the repeated guard tuple once
    (A3, {(1, 2, 3, 4), (1, 9, 9, 9)}),
    # A1: S(x), T(y), U(z), V(w) each on its own key
    (A1, {(1, 2, 3, 4), (2, 2, 3, 4)}),
    # A2: every column in S
    (A2, {(4, 4, 4, 4)}),
    # B2: exactly one of S, T, U, V holds on x: only x = 5 (V alone)
    (B2, {(5, 0, 0, 0)}),
    # B1: all sixteen atoms; (1, 2, 3, 4) fails T(z), (4, 4, 4, 4) fails T(x)
    (B1, set()),
])
def test_table2_hand_worked(query, want):
    assert rows(semijoin.evaluate(query, rels_of(HAND))) == want


def test_negation_projection_constants_and_repeats():
    db = dict(HAND, C=[(1, 7), (2, 8), (4, 7)], E=[(3, 3), (4, 5)])
    rels = rels_of(db)
    q = {"name": "Z", "head": ["x"], "guard": ["R"] + XYZW,
         "where": {"and": [["S", "x"], {"not": ["T", "y"]}]}}
    # S(x) and not T(y): (1, 9, 9, 9) and (4, 4, 4, 4)
    assert rows(semijoin.evaluate(q, rels)) == {(4,), (1,)}
    q = {"name": "Z", "head": ["x", "y"], "guard": ["R"] + XYZW, "where": ["C", "x", 7]}
    assert rows(semijoin.evaluate(q, rels)) == {(1, 2), (1, 9), (4, 4)}
    q = {"name": "Z", "head": ["x"], "guard": ["R"] + XYZW, "where": ["E", "x", "x"]}
    assert rows(semijoin.evaluate(q, rels)) == {(3,)}
    q = {"name": "Z", "head": ["z", "x"], "guard": ["R", "x", "y", "z", "z"], "where": None}
    assert rows(semijoin.evaluate(q, rels)) == {(1, 3), (4, 4), (9, 1), (0, 5), (0, 6)}


# --------------------------------------------------------------------------
# a few hundred rows against a loop over Python sets
# --------------------------------------------------------------------------


def holds(cond, env, sets):
    if isinstance(cond, list):
        return tuple(env[t] if isinstance(t, str) else t for t in cond[1:]) in sets[cond[0]]
    (op, arg), = cond.items()
    if op == "not":
        return not holds(arg, env, sets)
    parts = [holds(c, env, sets) for c in arg]
    return all(parts) if op == "and" else any(parts)


def loop_eval(query, db):
    sets = {k: set(map(tuple, v)) for k, v in db.items()}
    out = set()
    for t in db[query["guard"][0]]:
        env = dict(zip(query["guard"][1:], t))
        if query["where"] is None or holds(query["where"], env, sets):
            out.add(tuple(env[v] for v in query["head"]))
    return out


A4 = star("G", [("W", "x"), ("Xr", "y"), ("Yr", "z"), ("Zr", "w")])


# conditionals of n_cond draws over [0, 16): enough that each query's
# answer is neither empty nor every guard tuple
@pytest.mark.parametrize("query,n_cond", [(A1, 12), (A2, 12), (A3, 12), (A4, 12), (B1, 40), (B2, 8)],
                         ids=["A1", "A2", "A3", "A4", "B1", "B2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_table2_against_loop(query, n_cond, seed):
    rng = torch.Generator().manual_seed(seed)
    db = {g: torch.randint(0, 12, (300, 4), generator=rng).tolist() for g in "RG"}
    for c in ["S", "T", "U", "V", "W", "Xr", "Yr", "Zr"]:
        db[c] = torch.randint(0, 16, (n_cond, 1), generator=rng).tolist()
    got = rows(semijoin.evaluate(query, rels_of(db)))
    assert got == loop_eval(query, {k: [tuple(r) for r in v] for k, v in db.items()})
    assert 0 < len(got) < 300


def test_difference_counts_distinct_rows():
    want = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    got = torch.tensor([[3, 4], [3, 4], [7, 8]], dtype=torch.int32)
    assert semijoin.difference(want, got) == (2, 1)
    assert semijoin.difference(want, want[[2, 0, 1, 1]]) == (0, 0)
    assert semijoin.difference(want, torch.zeros((0, 2), dtype=torch.int32)) == (3, 0)


# --------------------------------------------------------------------------
# the data generator
# --------------------------------------------------------------------------


def test_datagen_distribution_and_determinism():
    n, sel = 4096, 0.5
    dom = datagen.key_domain(n)
    g = datagen.relation_rows("R", 4, "guard", n, sel, 2**40 + 3)
    assert g.shape == (n, 4) and g.dtype == torch.int32
    assert int(g.min()) >= 0 and int(g.max()) < dom
    c = datagen.relation_rows("S", 1, "conditional", n, sel, 2**40 + 3)
    lo = round(dom * sel)
    low = c[:, 0] < lo
    assert int(low.sum()) == round(n * sel)
    assert bool(((c[:, 0] >= dom) & (c[:, 0] < 2 * dom) | low).all())
    # the matches are spread through the relation, not in a block
    assert 0.4 < float(low[: n // 2].float().mean()) < 0.6
    assert torch.equal(c, datagen.relation_rows("S", 1, "conditional", n, sel, 2**40 + 3))
    other = datagen.relation_rows("S", 1, "conditional", n, sel, 2**40 + 4)
    assert not torch.equal(c, other)  # another seed: the same rows in another order
    assert torch.equal(c[:, 0].sort().values, other[:, 0].sort().values)
    assert not torch.equal(c, datagen.relation_rows("S", 1, "conditional", n, sel, 2**40 + 3, 1))
    assert not torch.equal(c, datagen.relation_rows("T", 1, "conditional", n, sel, 2**40 + 3))
    wide = datagen.relation_rows("C", 3, "conditional", n, sel, 5)
    assert wide.shape == (n, 3) and int(wide[:, 1:].max()) < dom
    with pytest.raises(ValueError):
        datagen.relation_rows("Q", 1, "other", n, sel, 5)


def test_every_seed_gives_every_shard_the_same_rows():
    n, shards = 4096, 16
    by_seed = [datagen.relation_rows("R", 4, "guard", n, 0.5, seed, shards=shards)
               for seed in (3, 2**33 + 1)]
    assert not torch.equal(*by_seed)
    for s in range(shards):
        a, b = (sorted(map(tuple, r[s::shards].tolist())) for r in by_seed)
        assert a == b
    with pytest.raises(ValueError):
        datagen.relation_rows("R", 4, "guard", 1000, 0.5, 3, shards=16)


def test_sub_seed_is_stable_and_63_bit():
    assert datagen.sub_seed(7, "R") == datagen.sub_seed(7, "R", 0)
    assert datagen.sub_seed(2**62, "S", 1) < 2**63
    assert len({datagen.sub_seed(s, n, v) for s, n, v in
                itertools.product(range(3), "RS", range(2))}) == 12


# --------------------------------------------------------------------------
# relation versions and the control
# --------------------------------------------------------------------------


def test_config_rows_draws_each_version_alone():
    config = {"rows": 512, "sel": 0.5, "P": 4,
              "relations": {"R": {"arity": 4, "role": "guard"}, "S": {"arity": 1, "role": "conditional"}}}
    v0 = datagen.config_rows(config, 5)
    v1 = datagen.config_rows(config, 5, {"S": 1})
    assert torch.equal(v0["R"], v1["R"]) and not torch.equal(v0["S"], v1["S"])
    assert torch.equal(v1["S"], datagen.relation_rows("S", 1, "conditional", 512, 0.5, 5, 1, shards=4))


def test_bloom_member_has_false_positives_and_no_false_negatives():
    gen = torch.Generator().manual_seed(3)
    facts = torch.randint(0, 2**20, (5000, 1), generator=gen, dtype=torch.int32)
    keys = torch.randint(2**21, 2**22, (20000, 1), generator=gen, dtype=torch.int32)
    assert bool(approx.bloom_member(facts, facts).all())
    fp = float(approx.bloom_member(keys, facts).float().mean())
    assert 0.02 < fp < 0.09  # (1 - e^-0.25)^2 = 0.049
    pairs = torch.randint(0, 2**20, (3000, 2), generator=gen, dtype=torch.int32)
    assert bool(approx.bloom_member(pairs, pairs).all())
