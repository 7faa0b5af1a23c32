"""What the benchmark hands the program and takes back from it.

The only module of the harness, with the entries, that imports the port
(``repro_torch``): queries from the configuration's description, relations
laid out in shards on the device, the answer rows of an output relation,
and a tracer that stamps the program's stages on the profiler's clock.
"""
from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch

from repro_torch.core.algebra import And, Atom, BSGF, Not, Or
from repro_torch.core.relation import Relation
from repro_torch.obs.tracer import Tracer


def cond_of(cond):
    """The configuration's condition as the port's algebra."""
    if isinstance(cond, list):
        return Atom(cond[0], *cond[1:])
    (op, arg), = cond.items()
    if op == "not":
        return Not(cond_of(arg))
    parts = [cond_of(c) for c in arg]
    out = parts[0]
    for p in parts[1:]:
        out = And(out, p) if op == "and" else Or(out, p)
    return out


def bsgf_of(query: dict) -> BSGF:
    where = query.get("where")
    return BSGF(query["name"], tuple(query["head"]), Atom(query["guard"][0], *query["guard"][1:]),
                cond_of(where) if where is not None else None)


def shard(name: str, rows: torch.Tensor, P: int) -> Relation:
    """``rows`` laid out over ``P`` shards on their device: row ``i`` in
    shard ``i % P`` at position ``i // P`` (``Relation.from_numpy``'s
    block placement, without the host)."""
    n, arity = rows.shape
    if n % P:
        raise ValueError(f"{name}: {n} rows do not split into {P} equal shards")
    data = rows.reshape(n // P, P, arity).transpose(0, 1).contiguous()
    valid = torch.ones((P, n // P), dtype=torch.bool, device=rows.device)
    return Relation(name, data, valid)


def answer_rows(rel: Relation) -> torch.Tensor:
    """The valid rows of an output relation, on its device."""
    return rel.data.reshape(-1, rel.arity)[rel.valid.reshape(-1)]


def span(spans, name: str):
    """The harness's span ``name`` around a call into the program, or
    nothing during set-up (``spans`` None)."""
    return nullcontext() if spans is None else spans(name)


def sync(device) -> None:
    """Wait for the device: the program returns before its work ends."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageStamps(Tracer):
    """The program's tracer with no barrier between stages, so the device
    runs the stages as it does untraced (the traced path adds a few scalar
    reads of each job's counters).  Each phase span is also kept in
    ``stamps`` as ``(start_ns, end_ns, name)`` on ``time.time_ns``, the
    clock the profiler stamps its events with, so that the device
    operations launched inside it can be told apart."""

    def __init__(self):
        super().__init__(trace_sync=False)
        self.stamps: list = []

    @contextmanager
    def span(self, name: str, cat: str = "phase", **args):
        ns0 = time.time_ns()
        with super().span(name, cat, **args) as sp:
            yield sp
        if cat == "phase":
            self.stamps.append((ns0, time.time_ns(), name))
