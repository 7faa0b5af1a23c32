"""The plain evaluator of a BSGF query: the benchmark's reference.

A query is the configuration file's description of the paper's
``Z := SELECT head FROM guard WHERE condition`` (Daenen et al., PVLDB
2016, §3.1)::

    {"name": "Z", "head": ["x", "y", "z", "w"], "guard": ["R", "x", "y", "z", "w"],
     "where": {"and": [["S", "x"], ["T", "x"], ["U", "x"], ["V", "x"]]}}

An atom is a list ``[relation, term, ...]`` whose terms are variables
(strings) or constants (integers); a condition is an atom or
``{"and": [...]}``, ``{"or": [...]}``, ``{"not": ...}``.  The answer is a
set: the distinct head tuples of the guard tuples whose condition holds,
where a conditional atom holds when some fact of its relation agrees with
the guard tuple on the atom's variables and has the atom's constants.

Plain PyTorch on whatever device the rows are on; nothing else is
imported.
"""
from __future__ import annotations

import torch


def _positions(terms: list) -> tuple[list, dict[str, int]]:
    """``(checks, first)``: what a fact must satisfy (repeated variables
    equal, constants matched), and each variable's first position."""
    first: dict[str, int] = {}
    checks = []
    for i, t in enumerate(terms):
        if isinstance(t, str):
            if t in first:
                checks.append(("eq", first[t], i))
            else:
                first[t] = i
        else:
            checks.append(("const", i, int(t)))
    return checks, first


def _conform(rows: torch.Tensor, checks) -> torch.Tensor:
    ok = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    for kind, a, b in checks:
        ok &= (rows[:, a] == rows[:, b]) if kind == "eq" else (rows[:, a] == b)
    return ok


def member(keys: torch.Tensor, facts: torch.Tensor) -> torch.Tensor:
    """For each row of ``keys`` (n, k), whether it is a row of ``facts`` (m, k)."""
    if keys.shape[1] == 0:
        return torch.full((keys.shape[0],), facts.shape[0] > 0, dtype=torch.bool,
                          device=keys.device)
    if keys.shape[1] == 1:
        return torch.isin(keys[:, 0], facts[:, 0])
    _, inv = torch.unique(torch.cat([keys, facts]), dim=0, return_inverse=True)
    return torch.isin(inv[: keys.shape[0]], inv[keys.shape[0]:])


def atom_mask(atom: list, guard_rows: torch.Tensor, guard_first: dict[str, int],
              rels: dict[str, torch.Tensor], member_fn=member) -> torch.Tensor:
    """Whether the atom holds for each guard row."""
    name, terms = atom[0], list(atom[1:])
    facts = rels[name]
    if facts.shape[1] != len(terms):
        raise ValueError(f"atom {atom}: relation {name} has arity {facts.shape[1]}")
    checks, first = _positions(terms)
    facts = facts[_conform(facts, checks)]
    names = list(first)
    missing = [v for v in names if v not in guard_first]
    if missing:
        raise ValueError(f"atom {atom}: variables {missing} are not the guard's")
    keys = guard_rows[:, [guard_first[v] for v in names]]
    return member_fn(keys, facts[:, [first[v] for v in names]])


def cond_mask(cond, guard_rows, guard_first, rels, member_fn=member) -> torch.Tensor:
    if isinstance(cond, list):
        return atom_mask(cond, guard_rows, guard_first, rels, member_fn)
    (op, arg), = cond.items()
    if op == "not":
        return ~cond_mask(arg, guard_rows, guard_first, rels, member_fn)
    if op not in ("and", "or"):
        raise ValueError(f"unknown connective {op!r}")
    masks = [cond_mask(c, guard_rows, guard_first, rels, member_fn) for c in arg]
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if op == "and" else (out | m)
    return out


def evaluate(query: dict, rels: dict[str, torch.Tensor], member_fn=member) -> torch.Tensor:
    """The query's answer: its distinct head tuples, sorted, as an
    ``(n, len(head))`` int32 tensor.  ``member_fn(keys, facts)`` decides
    each atom; the control passes an approximate one."""
    guard = query["guard"]
    rows = rels[guard[0]]
    checks, first = _positions(list(guard[1:]))
    rows = rows[_conform(rows, checks)]
    ok = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    if query.get("where") is not None:
        ok = cond_mask(query["where"], rows, first, rels, member_fn)
    head = rows[ok][:, [first[v] for v in query["head"]]]
    return distinct(head)


def distinct(rows: torch.Tensor) -> torch.Tensor:
    """The distinct rows, in lexicographic order."""
    if rows.shape[0] == 0:
        return rows
    return torch.unique(rows, dim=0)


def difference(expected: torch.Tensor, got: torch.Tensor) -> tuple[int, int]:
    """``(missing, extra)``: distinct rows of ``expected`` absent from
    ``got``, and distinct rows of ``got`` absent from ``expected``."""
    want, have = distinct(expected), distinct(got.to(expected.device))
    if want.shape[1] != have.shape[1]:
        return want.shape[0], have.shape[0]
    union = distinct(torch.cat([want, have])).shape[0]
    both = want.shape[0] + have.shape[0] - union
    return want.shape[0] - both, have.shape[0] - both
