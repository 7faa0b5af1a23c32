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


def indexed_bsgf(db: SetDB, q: BSGF) -> set[tuple]:
    """:func:`eval_bsgf` with each condition atom's conforming facts
    indexed by the values of its variables that the guard binds: one set
    lookup per guard fact and atom where :func:`eval_bsgf` scans the atom's
    relation.  A fact agrees with a guard binding exactly when its values
    of those variables equal the binding's (a conforming fact holds one
    value per variable), so the lookup answers :func:`atom_holds`."""
    bound = set(q.guard.vars)
    index = {}
    for a in cond_atoms(q.cond) if q.cond is not None else ():
        keys = [v for v in a.vars if v in bound]
        pos = [a.terms.index(v) for v in keys]
        index[a] = (keys, {tuple(f[i] for i in pos) for f in db.get(a.rel, ())
                           if fact_conforms(f, a)})
    out: set[tuple] = set()
    for fact in db.get(q.guard.rel, ()):
        if not fact_conforms(fact, q.guard):
            continue
        binding = _binding(fact, q.guard)
        if q.cond is not None and not eval_cond(q.cond, {
                a: tuple(binding[v] for v in keys) in facts
                for a, (keys, facts) in index.items()}):
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
