"""Pure-Python set-semantics oracle for SGF evaluation.

This is the ground truth the distributed engine (and the CUDA kernels) are
validated against, mirroring the paper's declarative semantics in
Section 3.1 exactly.
"""
from __future__ import annotations

from typing import Mapping

from repro_torch.core.algebra import BSGF, SGF, Atom, Cond, cond_atoms, eval_cond

SetDB = Mapping[str, set]


def fact_conforms(fact: tuple, atom: Atom) -> bool:
    """fact ⊨ atom: repeated variables equal, constants match (Section 4)."""
    if len(fact) != atom.arity:
        return False
    binding: dict[str, int] = {}
    for v, t in zip(fact, atom.terms):
        if isinstance(t, int):
            if v != t:
                return False
        else:
            if t in binding and binding[t] != v:
                return False
            binding[t] = v
    return True


def _binding(fact: tuple, atom: Atom) -> dict[str, int]:
    return {t: v for v, t in zip(fact, atom.terms) if isinstance(t, str)}


def atom_holds(db: SetDB, atom: Atom, binding: dict[str, int]) -> bool:
    """∃ fact in db[atom.rel] conforming to atom and agreeing with
    ``binding`` on the atom's bound (guard) variables."""
    for fact in db.get(atom.rel, set()):
        if not fact_conforms(fact, atom):
            continue
        ok = True
        for v, t in zip(fact, atom.terms):
            if isinstance(t, str) and t in binding and binding[t] != v:
                ok = False
                break
        if ok:
            return True
    return False


def eval_bsgf(db: SetDB, q: BSGF) -> set[tuple]:
    out: set[tuple] = set()
    for fact in db.get(q.guard.rel, set()):
        if not fact_conforms(fact, q.guard):
            continue
        binding = _binding(fact, q.guard)
        if q.cond is not None:
            leaf = {a: atom_holds(db, a, binding) for a in cond_atoms(q.cond)}
            if not eval_cond(q.cond, leaf):
                continue
        out.add(tuple(binding[v] for v in q.out_vars))
    return out


def eval_sgf(db: SetDB, sgf: SGF) -> dict[str, set[tuple]]:
    """Evaluate all BSGFs in order; returns every intermediate output."""
    env = {k: set(v) for k, v in db.items()}
    results: dict[str, set[tuple]] = {}
    for q in sgf:
        res = eval_bsgf(env, q)
        env[q.name] = res
        results[q.name] = res
    return results


def eval_semijoin(db: SetDB, guard: Atom, cond_atom: Atom, out_vars) -> set[tuple]:
    q = BSGF(name="_sj", out_vars=tuple(out_vars), guard=guard, cond=cond_atom)
    return eval_bsgf(db, q)
