"""The paper's experimental query families (Tables 2 & Figure 6) plus
synthetic data generators with controllable selectivity.

* A1–A5 — BSGF sharing patterns (guard / conditional-name / key sharing).
* B1, B2 — large conjunctive query and the uniqueness query.
* C1–C4 — nested SGF families (Figure 6 gives only the dependency DAGs;
  the concrete atoms here instantiate the stated properties: C1/C2 one
  level with overlapping atoms, C3 a deep chain with many distinct atoms,
  C4 two levels with many overlapping atoms).
* the cost-model ablation query of §5.2 (non-proportional map output).
* the multi-tenant mix of the reference's service throughput bench.

Note: the paper's Table 2 prints B2's third disjunct as
``(S ∧ ¬T ∧ U ∧ ¬V)``, which contradicts the stated "precisely one"
semantics; we implement the uniqueness query as described in the text.

Data (scaled down from the paper's 4 GB/relation): guard relations hold
``n_guard`` arity-4 tuples; each unary conditional relation holds
``n_cond`` tuples of which a ``sel`` fraction match guard values —
the paper's selectivity-rate knob (§5.4).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.algebra import (
    And,
    Atom,
    BSGF,
    Not,
    Or,
    SGF,
    all_of,
    any_of,
)

XYZW = ("x", "y", "z", "w")


def _star(name: str, guard_rel: str, conds) -> BSGF:
    return BSGF(name, XYZW, Atom(guard_rel, *XYZW), all_of(*conds))


# --------------------------------------------------------------------------
# BSGF families (Table 2)
# --------------------------------------------------------------------------


def make_queries(qid: str) -> list[BSGF]:
    """A1–A5, B1, B2 (a list — A4/A5 are two-query workloads)."""
    S, T, U, V = (Atom(r, v) for r, v in zip("STUV", XYZW))
    if qid == "A1":  # guard sharing
        return [_star("Z", "R", [S, T, U, V])]
    if qid == "A2":  # guard & conditional name sharing
        return [_star("Z", "R", [Atom("S", v) for v in XYZW])]
    if qid == "A3":  # guard & conditional key sharing (1-ROUND applicable)
        return [_star("Z", "R", [Atom(r, "x") for r in "STUV"])]
    if qid == "A4":  # no sharing
        return [
            _star("Z1", "R", [S, T, U, V]),
            _star("Z2", "G", [Atom(r, v) for r, v in zip(["W", "Xr", "Yr", "Zr"], XYZW)]),
        ]
    if qid == "A5":  # conditional name sharing across queries
        return [
            _star("Z1", "R", [S, T, U, V]),
            _star("Z2", "G", [S, T, U, V]),
        ]
    if qid == "B1":  # large conjunctive query: 16 atoms
        return [
            _star("Z", "R", [Atom(r, v) for v in XYZW for r in "STUV"])
        ]
    if qid == "B2":  # uniqueness query (exactly one of S,T,U,V holds on x)
        s, t, u, v = (Atom(r, "x") for r in "STUV")
        only = lambda a, rest: all_of(a, *[Not(b) for b in rest])  # noqa: E731
        cond = any_of(
            only(s, [t, u, v]), only(t, [s, u, v]), only(u, [s, t, v]), only(v, [s, t, u])
        )
        return [BSGF("Z", XYZW, Atom("R", *XYZW), cond)]
    raise KeyError(qid)


def ablation_query(n_keys: int = 12, const: int = 10**6) -> BSGF:
    """§5.2 cost-model ablation: 48 atoms S_j(x_i, c) whose constant
    filters out every conditional tuple — non-proportional map output."""
    xs = tuple(f"x{i}" for i in range(1, n_keys + 1))
    atoms = [Atom(f"S{j}", x, const) for j in range(1, 5) for x in xs]
    return BSGF("Z", xs, Atom("R", *xs), all_of(*atoms))


# --------------------------------------------------------------------------
# SGF families (Figure 6)
# --------------------------------------------------------------------------


def make_sgf(qid: str) -> SGF:
    uv = [Atom("U", "z"), Atom("V", "w")]
    st = [Atom("S", "x"), Atom("T", "y")]
    if qid == "C1":  # one level, same conditionals everywhere
        return SGF(
            [_star(f"Z{i}", f"G{i}", st) for i in range(1, 5)]
        )
    if qid == "C2":  # one level, ring-wise partial overlap
        ring = ["S", "T", "U", "V", "S"]
        return SGF(
            [
                _star(
                    f"Z{i}",
                    f"G{i}",
                    [Atom(ring[i - 1], "x"), Atom(ring[i], "y")],
                )
                for i in range(1, 5)
            ]
        )
    if qid == "C3":  # deep chain + side branch (Example 5's shape)
        q1 = _star("Z1", "G", [Atom("A", "x"), Atom("B", "y")])
        q2 = BSGF("Z2", XYZW, Atom("Z1", *XYZW), all_of(Atom("C", "z"), Atom("D", "w")))
        q3 = BSGF("Z3", XYZW, Atom("Z2", *XYZW), all_of(Atom("E", "x"), Atom("F", "y")))
        q4 = _star("Z4", "H", [Atom("K", "z")])
        q5 = BSGF("Z5", XYZW, Atom("Z3", *XYZW), Atom("Z4", *XYZW))
        return SGF([q1, q2, q3, q4, q5])
    if qid == "C4":  # two levels, overlapping atoms on both
        q1 = _star("Z1", "G1", st)
        q2 = _star("Z2", "G2", st)
        q3 = BSGF("Z3", XYZW, Atom("Z1", *XYZW), all_of(*uv))
        q4 = BSGF("Z4", XYZW, Atom("Z2", *XYZW), all_of(*uv))
        return SGF([q1, q2, q3, q4])
    raise KeyError(qid)


BAD_RATING = 9  # the "bad" rating value of Example 2, as a constant


def example2_sgf() -> SGF:
    """The paper's Example 2 (book retailers); the bad rating is a data
    constant (distinct conditional atoms may only share guard variables)."""
    q1 = BSGF(
        "Z1",
        ("ttl", "auth"),
        Atom("Amaz", "ttl", "auth", BAD_RATING),
        all_of(Atom("BN", "ttl", "a2", BAD_RATING), Atom("BD", "ttl", "a3", BAD_RATING)),
    )
    q2 = BSGF(
        "Z2",
        ("newtitle", "auth"),
        Atom("Upcoming", "newtitle", "auth"),
        Not(Atom("Z1", "ttl", "auth")),
    )
    return SGF([q1, q2])


def example5_sgf() -> SGF:
    """The paper's Example 5 dependency shape (for planner tests)."""
    q1 = BSGF("Q1", ("x",), Atom("R1", "x", "y"), Atom("S", "x"))
    q2 = BSGF("Q2", ("x",), Atom("Q1", "x"), Atom("T", "x"))
    q3 = BSGF("Q3", ("x",), Atom("Q2", "x"), Atom("U", "x"))
    q4 = BSGF("Q4", ("x", "y"), Atom("R2", "x", "y"), Atom("T", "x"))
    q5 = BSGF("Q5", ("x",), Atom("Q3", "x"), Atom("Q4", "x", "y"))
    return SGF([q1, q2, q3, q4, q5])


def tenant_queries(t: int, per_tenant: int = 1) -> list[BSGF]:
    """Mixed A-family queries for tenant ``t`` over shared base relations:
    the tenants of the reference's service throughput bench
    (``benchmarks/service_throughput.py:tenant_queries``)."""
    out = []
    for j in range(per_tenant):
        guard = ("R", "G", "H")[(t + j) % 3]
        if (t + j) % 2 == 0:
            conds = [Atom(r, v) for r, v in zip("STUV", XYZW)]  # A1/A5 style
        else:
            conds = [Atom(r, "x") for r in "STUV"]  # A3 style (key sharing)
        out.append(BSGF(f"Z{j}", XYZW, Atom(guard, *XYZW), all_of(*conds)))
    return out


# --------------------------------------------------------------------------
# Data generation
# --------------------------------------------------------------------------


def base_relations(queries) -> dict[str, int]:
    """Referenced-but-not-defined relation names -> arity."""
    qs = list(queries.queries) if isinstance(queries, SGF) else list(queries)
    defined = {q.name for q in qs}
    rels: dict[str, int] = {}
    for q in qs:
        for a in [q.guard] + q.atoms:
            if a.rel not in defined:
                rels[a.rel] = a.arity
    return rels


def gen_db(
    queries,
    *,
    n_guard: int = 4096,
    n_cond: int = 4096,
    sel: float = 0.5,
    domain: int | None = None,
    seed: int = 0,
    guard_arity_default: int = 4,
) -> dict[str, np.ndarray]:
    """Synthetic database for a query family.

    Guard columns are uniform over ``[0, domain)``; a unary conditional
    relation draws a ``sel`` fraction of its tuples from ``[0, sel·domain)``
    (matching the guard's low range) and the rest from a disjoint high
    range — so ≈``sel`` of guard tuples match, the paper's selectivity
    rate.  Binary conditional atoms used by the ablation query get a
    second column that never equals the filtering constant.
    """
    rng = np.random.default_rng(seed)
    qs = list(queries.queries) if isinstance(queries, SGF) else list(queries)
    guards = {q.guard.rel for q in qs}
    rels = base_relations(qs)
    domain = domain or max(n_guard // 4, 16)

    db: dict[str, np.ndarray] = {}
    for name, arity in sorted(rels.items()):
        if name in guards:
            db[name] = rng.integers(0, domain, (n_guard, arity)).astype(np.int32)
        else:
            lo = max(1, int(round(domain * sel)))
            n_match = int(round(n_cond * sel))
            cols = []
            key_col = np.concatenate(
                [
                    rng.integers(0, lo, n_match),
                    rng.integers(domain, 2 * domain, n_cond - n_match),
                ]
            )
            rng.shuffle(key_col)
            cols.append(key_col)
            for _ in range(arity - 1):
                cols.append(rng.integers(0, domain, n_cond))
            db[name] = np.stack(cols, axis=1).astype(np.int32)
    return db
