"""The EVAL operator — one job evaluating Boolean combinations
``Z_u := X0_u ∧ φ_u(X1_u ... Xn_u)`` (paper Section 4.3).

Every row of every input relation is routed by a hash of its *tuple*
(one all_to_all); on the receiving shard rows are grouped by
``(unit, tuple)`` with a single lexicographic sort, each group's membership
bitmask is formed with a segment-OR, and the Boolean formula is applied to
the bitmask — exactly the paper's reducer, vectorized.

Multiple EVAL units (one per BSGF query of a stratum) share the job, which
is how the planner amortizes job overhead across the queries of one level.
Output relations are distinct-tuple sets (the reducer groups by tuple).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.core.algebra import Atom, Cond, eval_cond
from repro_torch.core.msj import _lex_order
from repro_torch.core.relation import Relation
from repro_torch.engine import hashing, shuffle
from repro_torch.engine.comm import Comm, run_pipeline


@dataclass(frozen=True)
class EvalUnit:
    """``name := π_{out_pos}(x0 ∧ cond)`` where cond's atoms map to the xs.

    ``out_pos`` (optional) projects the output onto a subset of the x0
    tuple's columns *after* the Boolean combination — required for
    soundness under negation when the query's SELECT list drops guard
    variables (see planner.py module docstring).
    """

    name: str
    x0: str  # relation name of the guard-projection input
    xs: tuple[str, ...]  # relation names of X_1..X_n (atom order)
    atoms: tuple[Atom, ...]  # conditional atoms, aligned with xs
    cond: Cond | None
    out_pos: tuple[int, ...] | None = None
    #: shuffle-placement salt; ``None`` falls back to a hash of ``name``
    salt: int | None = None


def _unit_salt(name: str) -> int:
    """Shuffle salt for an EVAL unit, derived from its *name* rather than
    its position in the job: a unit's output placement must not change when
    failure isolation narrows the job around it (DESIGN.md §13)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def query_salt(q) -> int:
    """Placement salt from a BSGF query's *structure* — not its name, which
    in the service is canonical and batch-positional (``q0, q1, ...``).
    The same query must land its output rows on the same shards no matter
    which co-batched queries it is fused with (and no matter how failure
    isolation narrows the job), or survivor outputs would not be
    bit-identical across batch compositions (DESIGN.md §13)."""
    key = repr((q.out_vars, q.guard, q.atoms, q.cond))
    return zlib.crc32(key.encode()) & 0x7FFFFFFF


def run_eval(
    env: dict[str, Relation],
    units: Sequence[EvalUnit],
    comm: Comm,
    *,
    forward_cap: int | None = None,
    tracer=None,
):
    """Execute one EVAL job. Returns ``({name: Relation}, stats)``.

    ``tracer`` records the two pipeline phases (``eval.shuffle`` — tuple
    routing + exchange — and ``eval.reduce`` — sorted grouping + formula
    evaluation); ``None`` runs the exact untraced path (DESIGN.md §14).
    """
    P = comm.P
    units = tuple(units)
    max_members = max(1 + len(u.xs) for u in units)
    arities = []
    for u in units:
        a = env[u.x0].arity
        for x in u.xs:
            if env[x].arity != a:
                raise ValueError(f"arity mismatch in EVAL unit {u.name}")
        arities.append(a)
    A = max(arities)

    inputs: list[tuple[int, int, str]] = []  # (unit, member, relname)
    for ui, u in enumerate(units):
        inputs.append((ui, 0, u.x0))
        for mi, x in enumerate(u.xs):
            inputs.append((ui, mi + 1, x))
    rel_names = sorted({name for _, _, name in inputs})

    cap_s = forward_cap or max(1, sum(env[name].cap for _, _, name in inputs))
    W = A + 2  # [unit, member, tuple cols...]

    def stage_map(sid, local_db):
        msgs, valid, dest = [], [], []
        for ui, mi, name in inputs:
            rel = local_db[name]
            dev = rel.data.device
            tup = rel.data
            if rel.arity < A:
                tup = torch.cat(
                    [tup, torch.zeros((rel.cap, A - rel.arity), dtype=torch.int32,
                                      device=dev)],
                    dim=1,
                )
            u = units[ui]
            salt = u.salt if u.salt is not None else _unit_salt(u.name)
            h = hashing.hash_cols(tup[:, : arities[ui]], salt=salt)
            msgs.append(
                torch.cat(
                    [
                        torch.full((rel.cap, 1), ui, dtype=torch.int32, device=dev),
                        torch.full((rel.cap, 1), mi, dtype=torch.int32, device=dev),
                        tup,
                    ],
                    dim=1,
                )
            )
            valid.append(rel.valid)
            dest.append(hashing.bucket_of(h, P))
        msgs = torch.cat(msgs, 0)
        valid = torch.cat(valid, 0)
        dest = torch.cat(dest, 0)
        sent = valid.sum().to(torch.int32)
        buf, bufvalid, ovf, _ = shuffle.partition(msgs, valid, dest, P, cap_s)
        return (buf, bufvalid), (ovf, sent)

    def stage_reduce(sid, args):
        (recv, recv_valid), (ovf, sent) = args
        flat, ok = shuffle.flatten_recv(recv, recv_valid)
        n = flat.shape[0]
        dev = flat.device
        unit = torch.where(ok, flat[:, 0], 2**30)
        member = flat[:, 1]
        tup = flat[:, 2:]
        order = _lex_order([unit] + [tup[:, k] for k in range(A)])
        unit_s, mem_s, tup_s, ok_s = unit[order], member[order], tup[order], ok[order]
        new_grp = torch.ones((n,), dtype=torch.bool, device=dev)
        if n > 1:
            new_grp[1:] = (unit_s[1:] != unit_s[:-1]) | (tup_s[1:] != tup_s[:-1]).any(dim=1)
        gid = torch.cumsum(new_grp.to(torch.int64), 0) - 1
        onehot = (
            (mem_s[:, None] == torch.arange(max_members, dtype=torch.int32, device=dev)[None, :])
            & ok_s[:, None]
        ).to(torch.int32)
        # segment-OR per group: the reference's segment_max
        group_mask = torch.zeros((n, max_members), dtype=torch.int32, device=dev)
        group_mask.scatter_reduce_(
            0, gid[:, None].expand(n, max_members), onehot, reduce="amax"
        )
        row_mask = group_mask[gid].bool()

        # distinct-output leader: the first member-0 row of each group.
        flag = ok_s & (mem_s == 0)
        csum = torch.cumsum(flag.to(torch.int64), 0)
        excl = csum - flag.to(torch.int64)
        pos = torch.arange(n, dtype=torch.int64, device=dev)
        # first position of each group: the reference's segment_min
        g_start = torch.full((n,), n, dtype=torch.int64, device=dev)
        g_start.scatter_reduce_(0, gid, pos, reduce="amin")
        base = excl[torch.clamp(g_start, max=n - 1)]  # member-0 rows seen before this group
        is_leader = flag & ((csum - 1 - base[gid]) == 0)

        outs = {}
        for ui, u in enumerate(units):
            leaf = {a: row_mask[:, mi + 1] for mi, a in enumerate(u.atoms)}
            formula_ok = (
                eval_cond(u.cond, leaf) if u.cond is not None
                else torch.ones((n,), dtype=torch.bool, device=dev)
            )
            zok = is_leader & (unit_s == ui) & row_mask[:, 0] & formula_ok
            cols = (
                list(u.out_pos)
                if u.out_pos is not None
                else list(range(arities[ui]))
            )
            outs[u.name] = Relation(u.name, tup_s[:, cols], zok)
        stats = {
            "overflow": ovf,
            "sent_fwd": sent,
            "recv_fwd": ok.sum().to(torch.int32),
            "hits": torch.zeros((), dtype=torch.int32, device=dev),
        }
        return None, (outs, stats)

    stacked = {name: env[name] for name in rel_names}
    traced = tracer is not None
    phase_spans = tracer.current() if traced else []
    base = len(phase_spans)
    outputs, stats = run_pipeline(
        comm, [stage_map, stage_reduce], stacked,
        tracer=tracer, names=["eval.shuffle", "eval.reduce"],
    )
    stats = {k: v.sum(dtype=torch.int64) for k, v in stats.items()}
    stats["bytes_fwd"] = stats["sent_fwd"] * W * 4
    stats["bytes_bwd"] = torch.zeros((), dtype=torch.int64)
    if traced:
        for sp in phase_spans[base:]:
            if sp.name == "eval.shuffle":
                sp.args["bytes"] = stats["bytes_fwd"]
    return outputs, stats
