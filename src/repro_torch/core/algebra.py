"""SGF query algebra: atoms, Boolean conditions, BSGF and SGF queries.

Terms are either variables (``str``) or integer constants (``int``).
The AST mirrors the paper's Section 3.1:

* An :class:`Atom` is ``R(t1, ..., tn)``.
* A condition ``C`` is a Boolean combination (:class:`And`, :class:`Or`,
  :class:`Not`) of atoms.
* A :class:`BSGF` is ``Z := SELECT w̄ FROM guard [WHERE C]``.
* An :class:`SGF` is an ordered sequence of BSGFs where later queries may
  reference the output relations of earlier ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Mapping, Sequence, Union

Term = Union[str, int]


@dataclass(frozen=True)
class Atom:
    """A relational atom ``rel(terms...)``."""

    rel: str
    terms: tuple[Term, ...]

    def __init__(self, rel: str, *terms: Term):
        # Allow Atom("R", "x", "y") and Atom("R", ("x", "y")).
        if len(terms) == 1 and isinstance(terms[0], (tuple, list)):
            terms = tuple(terms[0])
        object.__setattr__(self, "rel", rel)
        object.__setattr__(self, "terms", tuple(terms))

    @property
    def arity(self) -> int:
        return len(self.terms)

    @property
    def vars(self) -> tuple[str, ...]:
        """Variables in order of first occurrence."""
        seen: list[str] = []
        for t in self.terms:
            if isinstance(t, str) and t not in seen:
                seen.append(t)
        return tuple(seen)

    def positions_of(self, var: str) -> tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.terms) if t == var)

    def conform_pattern(self) -> tuple:
        """Canonical conformance pattern: for each position either
        ``("const", v)`` or ``("var", first_position_of_same_var)``.

        Two atoms with the same relation and the same pattern accept exactly
        the same facts — the basis for Assert-message sharing (the paper's
        "conditional name sharing").
        """
        first: dict[str, int] = {}
        pat: list[tuple] = []
        for i, t in enumerate(self.terms):
            if isinstance(t, int):
                pat.append(("const", int(t)))
            else:
                if t not in first:
                    first[t] = i
                pat.append(("var", first[t]))
        return tuple(pat)

    def __repr__(self) -> str:  # compact: R(x,y,4)
        return f"{self.rel}({','.join(map(str, self.terms))})"


# --------------------------------------------------------------------------
# Boolean conditions
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class And:
    left: "Cond"
    right: "Cond"

    def __repr__(self):
        return f"({self.left} AND {self.right})"


@dataclass(frozen=True)
class Or:
    left: "Cond"
    right: "Cond"

    def __repr__(self):
        return f"({self.left} OR {self.right})"


@dataclass(frozen=True)
class Not:
    child: "Cond"

    def __repr__(self):
        return f"NOT {self.child}"


Cond = Union[Atom, And, Or, Not]


def all_of(*conds: Cond) -> Cond:
    out = conds[0]
    for c in conds[1:]:
        out = And(out, c)
    return out


def any_of(*conds: Cond) -> Cond:
    out = conds[0]
    for c in conds[1:]:
        out = Or(out, c)
    return out


def cond_atoms(cond: Cond | None) -> list[Atom]:
    """Conditional atoms in a fixed left-to-right order, deduplicated."""
    out: list[Atom] = []

    def walk(c: Cond):
        if isinstance(c, Atom):
            if c not in out:
                out.append(c)
        elif isinstance(c, Not):
            walk(c.child)
        else:
            walk(c.left)
            walk(c.right)

    if cond is not None:
        walk(cond)
    return out


def eval_cond(cond: Cond, leaf: Mapping[Atom, object]):
    """Evaluate the Boolean combination given per-atom truth values.

    ``leaf`` maps atoms to bools or boolean arrays; works elementwise for
    jnp/np arrays.
    """
    if isinstance(cond, Atom):
        return leaf[cond]
    if isinstance(cond, Not):
        v = eval_cond(cond.child, leaf)
        # ``~`` on a Python bool is integer complement (~True == -2, truthy);
        # only use it for array leaves.
        return ~v if hasattr(v, "dtype") else (not v)
    if isinstance(cond, And):
        return eval_cond(cond.left, leaf) & eval_cond(cond.right, leaf)
    if isinstance(cond, Or):
        return eval_cond(cond.left, leaf) | eval_cond(cond.right, leaf)
    raise TypeError(f"not a condition: {cond!r}")


def cond_relations(cond: Cond | None) -> set[str]:
    return {a.rel for a in cond_atoms(cond)}


# --------------------------------------------------------------------------
# BSGF / SGF queries
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class BSGF:
    """``name := SELECT out_vars FROM guard WHERE cond``."""

    name: str
    out_vars: tuple[str, ...]
    guard: Atom
    cond: Cond | None = None

    def __post_init__(self):
        object.__setattr__(self, "out_vars", tuple(self.out_vars))
        gvars = set(self.guard.vars)
        missing = [v for v in self.out_vars if v not in gvars]
        if missing:
            raise ValueError(f"output vars {missing} not in guard {self.guard}")
        # Guardedness: distinct conditional atoms may only share guard vars.
        atoms = cond_atoms(self.cond)
        for i, a in enumerate(atoms):
            for b in atoms[i + 1 :]:
                shared = set(a.vars) & set(b.vars)
                bad = shared - gvars
                if bad:
                    raise ValueError(
                        f"atoms {a} and {b} share non-guard vars {bad}"
                    )

    @property
    def atoms(self) -> list[Atom]:
        return cond_atoms(self.cond)

    def join_key(self, atom: Atom) -> tuple[str, ...]:
        """Join-key variables of a conditional atom: vars shared with the
        guard, in order of first occurrence in the conditional atom."""
        gvars = set(self.guard.vars)
        return tuple(v for v in atom.vars if v in gvars)

    @property
    def relations(self) -> set[str]:
        return {self.guard.rel} | cond_relations(self.cond)

    def __repr__(self):
        w = f" WHERE {self.cond}" if self.cond is not None else ""
        return (
            f"{self.name} := SELECT ({','.join(self.out_vars)}) "
            f"FROM {self.guard}{w}"
        )


@dataclass(frozen=True)
class SGF:
    """An ordered sequence of BSGF queries; the last one is the output."""

    queries: tuple[BSGF, ...]

    def __init__(self, queries: Sequence[BSGF]):
        names = [q.name for q in queries]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate output names: {names}")
        defined: set[str] = set()
        arity: dict[str, int] = {}
        for q in queries:
            for rel in q.relations:
                if rel in names and rel not in defined and rel != q.name:
                    raise ValueError(
                        f"query {q.name} references {rel} before definition"
                    )
            if q.name in q.relations:
                raise ValueError(f"query {q.name} references itself")
            for a in [q.guard] + q.atoms:
                if a.rel in arity and arity[a.rel] != a.arity:
                    raise ValueError(
                        f"query {q.name}: atom {a} has arity {a.arity} but "
                        f"{a.rel} is defined with arity {arity[a.rel]}"
                    )
            defined.add(q.name)
            arity[q.name] = len(q.out_vars)
        object.__setattr__(self, "queries", tuple(queries))

    def __iter__(self) -> Iterator[BSGF]:
        return iter(self.queries)

    def __len__(self) -> int:
        return len(self.queries)

    @property
    def output(self) -> str:
        return self.queries[-1].name

    def dependency_graph(self) -> dict[str, set[str]]:
        """Edges ``u -> v``: query v uses the output relation of query u.

        Returned as adjacency: ``deps[v] = {u, ...}`` (v depends on us).
        """
        names = {q.name for q in self.queries}
        deps: dict[str, set[str]] = {}
        for q in self.queries:
            deps[q.name] = {r for r in q.relations if r in names}
        return deps

    def by_name(self, name: str) -> BSGF:
        for q in self.queries:
            if q.name == name:
                return q
        raise KeyError(name)


# --------------------------------------------------------------------------
# Semi-join equations (right-hand sides handed to the MSJ operator)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SemiJoin:
    """``out := π_{out_vars}(guard ⋉ cond_atom)`` — one equation of an MSJ set."""

    out: str
    out_vars: tuple[str, ...]
    guard: Atom
    cond_atom: Atom

    def __post_init__(self):
        object.__setattr__(self, "out_vars", tuple(self.out_vars))

    @property
    def key_vars(self) -> tuple[str, ...]:
        gvars = set(self.guard.vars)
        return tuple(v for v in self.cond_atom.vars if v in gvars)

    def signature(self) -> tuple:
        """Assert-side signature: two semi-joins with equal signatures can
        share Assert messages (same relation, same conformance pattern, same
        key positions within the conditional atom)."""
        keypos = []
        for v in self.key_vars:
            keypos.append(self.cond_atom.positions_of(v)[0])
        return (
            self.cond_atom.rel,
            self.cond_atom.conform_pattern(),
            tuple(keypos),
        )

    def __repr__(self):
        return (
            f"{self.out} := pi_({','.join(self.out_vars)})"
            f"({self.guard} ltimes {self.cond_atom})"
        )


def semijoins_of(q: BSGF) -> list[SemiJoin]:
    """Decompose a BSGF query into its semi-join equations X_i (Section 4.4)."""
    out = []
    for i, a in enumerate(q.atoms):
        out.append(
            SemiJoin(
                out=f"{q.name}#X{i}",
                out_vars=q.out_vars,
                guard=q.guard,
                cond_atom=a,
            )
        )
    return out


def formula_of(q: BSGF) -> tuple[Cond, dict[Atom, str]]:
    """The Boolean formula φ_C with atoms renamed to their X_i outputs."""
    mapping = {a: f"{q.name}#X{i}" for i, a in enumerate(q.atoms)}
    return q.cond, mapping
