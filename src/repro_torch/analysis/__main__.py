"""CI gate for the plan verifier (DESIGN.md §15).

Three modes:

* ``python -m repro_torch.analysis --corpus`` — verify every plan the bench
  ladders build (BSGF families A1–A5/B1/B2 under PAR / GREEDY / SEQ /
  1-ROUND, SGF families C1–C4 under SEQUNIT / PARUNIT / GREEDY-SGF /
  1-ROUND, plus canonicalized service-fused batches).  Exit 1 on any
  error-severity finding.
* ``python -m repro_torch.analysis --mutate N`` — seeded mutation harness:
  delete random DAG edges / corrupt random node read-write sets across
  the corpus and measure the verifier's kill rate against an
  independent BFS reference.  Exit 1 if either kill rate < 0.95 or the
  verifier flags a mutation the reference says is harmless.
* ``python -m repro_torch.analysis --trace PATH`` — offline-audit an exported
  Perfetto trace (schema + happens-before sanitizing).  Exit 1 on any
  error finding.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys

from repro_torch.analysis.verifier import (
    Finding,
    derive_accesses,
    errors,
    verify_nodes,
    verify_plan,
)
from repro_torch.core import queries as Q
from repro_torch.core.costmodel import HADOOP, RelStats, Stats
from repro_torch.core.planner import (
    Plan,
    annotate_skew,
    conflict_rels,
    job_dag,
    plan_greedy,
    plan_one_round,
    plan_par,
    plan_seq,
    plan_sgf,
)
from repro_torch.service.plan_cache import canonicalize

_BSGF_IDS = ("A1", "A2", "A3", "A4", "A5", "B1", "B2")
_SGF_IDS = ("C1", "C2", "C3", "C4")
_SGF_STRATS = ("sequnit", "parunit", "greedy", "one_round")
#: service-batch shapes: families fused into one canonical batch
_FUSED = (("A1", "A3"), ("A4",), ("C2",))


def _tiny_stats(queries):
    """Statistics over a tiny synthetic db — plan shape, not plan cost,
    is under test, so 64-row relations are plenty.  Row counts and arities
    are read off the numpy rows: ``stats_of_db`` of the same relations."""
    db_np = Q.gen_db(queries, n_guard=64, n_cond=64)
    return Stats({name: RelStats(rows=float(len(a)), arity=a.shape[1])
                  for name, a in db_np.items()})


def _family_queries(qid: str):
    if qid in _SGF_IDS:
        return list(Q.make_sgf(qid).queries)
    return Q.make_queries(qid)


def corpus():
    """Yield ``(label, plan, schema, canonical)`` for every corpus plan."""
    for qid in _BSGF_IDS:
        qs = Q.make_queries(qid)
        schema = Q.base_relations(qs)
        stats = _tiny_stats(qs)
        plans = {
            "par": plan_par(qs),
            "greedy": plan_greedy(qs, stats, HADOOP),
            "one_round": plan_one_round(qs),
        }
        if len(qs) == 1:
            try:
                plans["seq"] = plan_seq(qs[0])
            except ValueError:
                pass
        for strat, plan in plans.items():
            yield f"{qid}/{strat}", plan, schema, False
    for qid in _SGF_IDS:
        sgf = Q.make_sgf(qid)
        schema = Q.base_relations(sgf)
        stats = _tiny_stats(sgf)
        for strat in _SGF_STRATS:
            plan = plan_sgf(sgf, strat, stats, HADOOP)
            yield f"{qid}/{strat}", plan, schema, False
    for qids in _FUSED:
        batch = [q for qid in qids for q in _family_queries(qid)]
        canon, _ = canonicalize(batch)
        schema = Q.base_relations(canon)
        label = "+".join(qids)
        yield f"svc:{label}/par", plan_par(canon), schema, True
        yield f"svc:{label}/one_round", plan_one_round(canon), schema, True


def _skewed(plan: Plan) -> Plan:
    """The plan with every MSJ job annotated for heavy-hitter splitting.

    ``force_R`` skips the hitter-evidence gate: the corpus checks the
    *mechanism* (profile → salted-transfer → compute sub-DAG, DESIGN.md
    §17), not the cost-model's annotation decision, so every plan gets
    the triple regardless of its synthetic key distribution."""
    return annotate_skew(plan, None, 4, packing=False, force_R=2)


def _print(findings, label: str) -> int:
    for f in findings:
        print(f"  {label}: {f}")
    return len(errors(findings))


def run_corpus() -> int:
    n_err = n_plans = 0
    for label, plan, schema, canonical in corpus():
        findings = verify_plan(plan, schema=schema, canonical=canonical)
        n_err += _print(findings, label)
        # the same plan under shuffle/compute overlap (DESIGN.md §16):
        # every obligation must also hold on the transfer/compute
        # sub-node DAG the overlapped executor actually walks
        ov_nodes = job_dag(plan, edges="relations", overlap=True)
        findings = verify_plan(
            plan, schema=schema, canonical=canonical, nodes=ov_nodes
        )
        n_err += _print(findings, f"{label}+overlap")
        # and under the skew defense (DESIGN.md §17): the annotated plan's
        # profile/transfer/compute triple adds the %salt publication and a
        # second sanctioned same-round RAW (profile→transfer), both of
        # which the verifier must accept — with and without overlap, since
        # skew transfers ride the comm track even when overlap is off
        skewed = _skewed(plan)
        for ov, tag in ((False, "+skew"), (True, "+skew+overlap")):
            sk_nodes = job_dag(skewed, edges="relations", overlap=ov, skew=True)
            findings = verify_plan(
                skewed, schema=schema, canonical=canonical, nodes=sk_nodes
            )
            n_err += _print(findings, f"{label}{tag}")
        n_plans += 4
    print(f"corpus: {n_plans} plans verified, {n_err} error findings")
    return 1 if n_err else 0


# --------------------------------------------------------------------------
# mutation harness
# --------------------------------------------------------------------------


def _bfs_covered(by_idx, j: int, i: int) -> bool:
    """Independent coverage reference: is ``i`` an ancestor of ``j``?"""
    stack, seen = [j], set()
    while stack:
        for d in by_idx[stack.pop()].deps:
            if d == i:
                return True
            if d not in seen:
                seen.add(d)
                stack.append(d)
    return False


def _ref_uncovered(nodes) -> set[tuple[int, int]]:
    """Conflicting-but-uncovered pairs, derived with the verifier's own
    access derivation but an independent BFS for coverage."""
    by_idx = {n.idx: n for n in nodes}
    acc = {n.idx: derive_accesses(n.job) for n in nodes}
    bad = set()
    idxs = sorted(by_idx)
    for a_pos, i in enumerate(idxs):
        ra, wa = acc[i]
        for j in idxs[a_pos + 1:]:
            rb, wb = acc[j]
            if conflict_rels(ra, wa, rb, wb) and not _bfs_covered(by_idx, j, i):
                bad.add((i, j))
    return bad


def _edge_mutations(nodes):
    for n in nodes:
        for d in sorted(n.deps):
            yield n.idx, d


def _delete_edge(nodes, idx: int, dep: int):
    return tuple(
        dataclasses.replace(n, deps=frozenset(n.deps) - {dep})
        if n.idx == idx else n
        for n in nodes
    )


def _corrupt_node(nodes, rng: random.Random):
    """Drop or invent one relation in a random node's read/write sets."""
    n = rng.choice(nodes)
    reads, writes = set(n.reads), set(n.writes)
    moves = []
    if reads:
        moves.append(("drop-read", rng.choice(sorted(reads))))
    if writes:
        moves.append(("drop-write", rng.choice(sorted(writes))))
    moves.append(("phantom-read", f"__phantom{rng.randrange(1 << 16)}"))
    kind, rel = rng.choice(moves)
    if kind == "drop-read":
        reads.discard(rel)
    elif kind == "drop-write":
        writes.discard(rel)
    else:
        reads.add(rel)
    mutated = tuple(
        dataclasses.replace(m, reads=frozenset(reads), writes=frozenset(writes))
        if m.idx == n.idx else m
        for m in nodes
    )
    return mutated, kind, n.idx


def run_mutate(n: int, seed: int) -> int:
    rng = random.Random(seed)
    plans = [(label, plan, False) for label, plan, _, _ in corpus()]
    # skew-annotated variants double the corpus: their DAGs carry the
    # profile→transfer salt edge and the salted transfer→compute buffer
    # edge — the two couplings whose deletion the skew property suite
    # counts on the verifier to kill (DESIGN.md §17)
    plans += [(f"{label}+skew", _skewed(plan), True)
              for label, plan, _, _ in corpus()]

    # -- edge deletions ----------------------------------------------------
    # both DAG flavors: the overlap variant adds the transfer→compute
    # buffer edges, whose deletion MUST be killed (an uncovered same-round
    # RAW on the exchange buffer is exactly the race the overlapped ready
    # queue would expose)
    edge_pool = []
    for label, plan, sk in plans:
        for ov in (False, True):
            nodes = job_dag(plan, edges="relations", overlap=ov, skew=sk)
            tag = f"{label}+overlap" if ov else label
            for idx, dep in _edge_mutations(nodes):
                edge_pool.append((tag, nodes, idx, dep))
    rng.shuffle(edge_pool)
    killed = load_bearing = false_pos = 0
    for label, nodes, idx, dep in edge_pool[:n]:
        mutated = _delete_edge(nodes, idx, dep)
        flagged = bool(errors(verify_nodes(mutated)))
        bearing = _ref_uncovered(mutated) != _ref_uncovered(nodes)
        if bearing:
            load_bearing += 1
            killed += flagged
        elif flagged:
            false_pos += 1
            print(f"  FALSE POSITIVE {label}: edge {dep}->{idx}")
    edge_rate = killed / load_bearing if load_bearing else 1.0
    print(
        f"edge deletions: {killed}/{load_bearing} load-bearing killed "
        f"({edge_rate:.1%}), {false_pos} false positives "
        f"({len(edge_pool[:n])} sampled)"
    )

    # -- read/write-set corruptions ----------------------------------------
    c_killed = c_total = 0
    for _ in range(n):
        label, plan, sk = rng.choice(plans)
        nodes = job_dag(
            plan, edges="relations", overlap=rng.random() < 0.5, skew=sk
        )
        mutated, kind, idx = _corrupt_node(nodes, rng)
        c_total += 1
        if errors(verify_plan(plan, nodes=mutated)):
            c_killed += 1
        else:
            print(f"  SURVIVED {label}: {kind} at node {idx}")
    c_rate = c_killed / c_total if c_total else 1.0
    print(f"corruptions: {c_killed}/{c_total} killed ({c_rate:.1%})")

    ok = edge_rate >= 0.95 and c_rate >= 0.95 and false_pos == 0
    return 0 if ok else 1


def run_trace(path: str) -> int:
    from repro_torch.obs.perfetto import audit_trace

    with open(path) as fh:
        trace = json.load(fh)
    findings = audit_trace(trace)
    n_err = _print(findings, path)
    print(f"trace audit: {len(findings)} findings, {n_err} errors")
    return 1 if n_err else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--corpus", action="store_true",
                    help="verify every bench/service plan")
    ap.add_argument("--mutate", type=int, metavar="N",
                    help="seeded mutation harness, N mutations per kind")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="PATH",
                    help="offline-audit an exported Perfetto trace")
    args = ap.parse_args(argv)
    if not (args.corpus or args.mutate or args.trace):
        ap.error("pick one of --corpus / --mutate N / --trace PATH")
    rc = 0
    if args.corpus:
        rc |= run_corpus()
    if args.mutate:
        rc |= run_mutate(args.mutate, args.seed)
    if args.trace:
        rc |= run_trace(args.trace)
    return rc


if __name__ == "__main__":
    sys.exit(main())
