"""Relation catalog: resident sharded relations with schema and statistics.

The service layer's source of truth for data.  Queries submitted to the
service reference relations *by name*; the catalog owns the sharded
:class:`~repro_torch.core.relation.Relation` storage, the per-relation
:class:`~repro_torch.core.costmodel.RelStats`, and the selectivity estimates the
planner costs plans with — so requests no longer carry a database dict
around.

Invalidation is **per relation**: every registration bumps a global
``epoch`` (which versions the memoized :class:`Stats`) *and* the touched
relation's entry in ``rel_epochs``.  The plan and result caches key on
the epochs of the relations a query batch *actually reads*
(:func:`query_deps` + :meth:`Catalog.dep_epochs`), so registering an
unrelated relation leaves cached plans and materialized results valid —
DESIGN.md §10.
"""
from __future__ import annotations

import re
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.algebra import BSGF, SGF
from repro_torch.core.costmodel import RelStats, Stats, stats_of_db
from repro_torch.core.relation import Relation, resolve_device


class CatalogError(KeyError):
    """A query referenced a relation the catalog does not hold."""

    def __str__(self):  # KeyError quotes its arg; keep the message readable
        return self.args[0] if self.args else ""


#: names reserved for the admission batcher's canonical namespace
#: (queries ``q<i>``, variables ``v<i>`` — plan_cache.canonicalize); a
#: catalog relation with such a name would silently alias a fused query's
#: output in the shared execution environment.
_RESERVED = re.compile(r"^[qv]\d+$")


class Catalog:
    """Named resident relations, all sharded over the same ``P`` and
    resident on one device: ``device=None`` is the CUDA card (raises
    without one, as :func:`~repro_torch.core.relation.resolve_device`
    does); tests pass ``device="cpu"``."""

    def __init__(
        self, *, P: int = 8, default_sel: float = 0.5, heavy_hitters: int = 0,
        device=None,
    ):
        self.P = P
        # the device a tensor made there reports: "cuda" becomes "cuda:<current>"
        self.device = torch.empty(0, device=resolve_device(device)).device
        self.default_sel = default_sel
        #: per-column top-k heavy-hitter sketch depth carried on the
        #: memoized Stats (``RelStats.heavy_hitters``) — the plan-time
        #: evidence ``planner.annotate_skew`` decides from (DESIGN.md §17).
        #: 0 (default) skips the sketch pass entirely: hitter collection
        #: scans every resident column, which the hot path must only pay
        #: when the service actually runs the skew defense.
        self.heavy_hitters = int(heavy_hitters)
        self._rels: dict[str, Relation] = {}
        #: selectivity estimates, keyed (guard_rel, cond_rel) as in Stats
        self.sel: dict[tuple, float] = {}
        #: bumped on every registration; versions the memoized Stats
        self.epoch = 0
        #: per-relation version: epoch value at the relation's last change.
        #: Cache keys are built from these (dep_epochs), not from ``epoch``,
        #: so unrelated registrations do not invalidate cached plans/results.
        self.rel_epochs: dict[str, int] = {}
        self._stats_cache: tuple[int, Stats] | None = None

    # -- registration ------------------------------------------------------
    def register(self, name: str, rows, *, partition: str = "block") -> Relation:
        """Register (or replace) a relation under ``name``.

        ``rows`` may be a pre-sharded :class:`Relation` (its shard count
        must match the catalog's ``P`` and lie on the catalog's device),
        an ``(n, arity)`` numpy array, or an iterable of int tuples.
        """
        if _RESERVED.match(name):
            raise ValueError(
                f"relation name {name!r} is reserved for the service's "
                "canonical query namespace (q<i>/v<i>)"
            )
        if isinstance(rows, Relation):
            if rows.P != self.P:
                raise ValueError(
                    f"relation {name!r} is sharded P={rows.P}, catalog has P={self.P}"
                )
            if rows.data.device != self.device:
                raise ValueError(
                    f"relation {name!r} lies on {rows.data.device}, catalog on {self.device}"
                )
            rel = rows.rename(name)
        elif isinstance(rows, np.ndarray):
            rel = Relation.from_numpy(
                name, rows, P=self.P, partition=partition, device=self.device
            )
        else:
            rel = Relation.from_tuples(name, rows, P=self.P, device=self.device)
        self._rels[name] = rel
        self.epoch += 1
        self.rel_epochs[name] = self.epoch
        return rel

    def register_many(self, rels: Mapping[str, object]) -> None:
        for name, rows in rels.items():
            self.register(name, rows)

    def set_selectivity(self, guard_rel: str, cond_rel: str, sel: float) -> None:
        self.sel[(guard_rel, cond_rel)] = float(sel)
        self.epoch += 1
        # A selectivity hint changes how plans *reading these relations* are
        # costed (and, conservatively, re-derives their cached results); it
        # must not invalidate entries that never touch either relation.
        for rel in (guard_rel, cond_rel):
            if rel in self.rel_epochs:
                self.rel_epochs[rel] = self.epoch

    # -- lookup ------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._rels

    def __len__(self) -> int:
        return len(self._rels)

    def names(self) -> tuple[str, ...]:
        return tuple(self._rels)

    def get(self, name: str) -> Relation:
        try:
            return self._rels[name]
        except KeyError:
            raise CatalogError(
                f"relation {name!r} is not registered "
                f"(resident: {', '.join(sorted(self._rels)) or 'none'})"
            ) from None

    def db(self) -> dict[str, Relation]:
        """A database-dict view for the executor (relations are shared,
        not copied; executors publish their outputs into their own env)."""
        return dict(self._rels)

    # -- per-relation versioning -------------------------------------------
    def dep_epochs(self, rels: Iterable[str]) -> tuple[tuple[str, int], ...]:
        """The cache-key component for a dependency set: ``(name, epoch)``
        pairs sorted by name.  Two lookups with equal dep keys are
        guaranteed to read bit-identical relation contents (epochs only
        move forward, and every mutation of a relation bumps its epoch)."""
        return tuple(
            (name, self.rel_epochs.get(name, 0)) for name in sorted(set(rels))
        )

    # -- statistics --------------------------------------------------------
    def stats(self) -> Stats:
        """Exact row counts of the resident relations + selectivities.

        Memoized on ``epoch`` — counting syncs one device reduction per
        relation, which the service hot path must not pay every tick.
        Callers that mutate the Stats (``register_output``) must copy it
        first (the batcher and scheduler both do).
        """
        if self._stats_cache is not None and self._stats_cache[0] == self.epoch:
            return self._stats_cache[1]
        if self.heavy_hitters > 0:
            # same memoization discipline, plus the per-column top-k
            # sketch the skew annotation consumes (DESIGN.md §17)
            st = stats_of_db(
                self._rels, dict(self.sel), self.default_sel,
                heavy_hitters=self.heavy_hitters,
            )
        else:
            rels = {
                name: RelStats(rows=float(r.count()), arity=r.arity)
                for name, r in self._rels.items()
            }
            st = Stats(rels, dict(self.sel), self.default_sel)
        self._stats_cache = (self.epoch, st)
        return st

    def validate(self, queries: Sequence[BSGF] | SGF) -> None:
        """Check every base relation a query batch reads is resident *and*
        used at its registered arity (the catalog owns the schema; SGF's
        intra-batch arity check cannot see it)."""
        qs = list(queries.queries) if isinstance(queries, SGF) else list(queries)
        defined = {q.name for q in qs}
        missing: set[str] = set()
        bad_arity: list[str] = []
        for q in qs:
            for a in [q.guard] + q.atoms:
                if a.rel in defined:
                    continue
                rel = self._rels.get(a.rel)
                if rel is None:
                    missing.add(a.rel)
                elif rel.arity != a.arity:
                    bad_arity.append(
                        f"{a} (registered arity {rel.arity})"
                    )
        if missing:
            raise CatalogError(
                f"unregistered relations {sorted(missing)} "
                f"(resident: {', '.join(sorted(self._rels)) or 'none'})"
            )
        if bad_arity:
            raise CatalogError(f"arity mismatch vs catalog schema: {bad_arity}")


def query_deps(
    queries: Sequence[BSGF] | BSGF, defined: Iterable[str] = ()
) -> frozenset[str]:
    """Base relations a query batch reads: every relation referenced by a
    guard or conditional atom that is neither an output of the batch itself
    nor in ``defined`` (extra non-catalog names, e.g. warm intermediates).

    This is the dependency set the per-relation epoch keys are built from:
    a cached plan/result for ``queries`` stays valid exactly as long as
    none of these relations is re-registered.
    """
    qs = [queries] if isinstance(queries, BSGF) else list(queries)
    skip = {q.name for q in qs} | set(defined)
    deps: set[str] = set()
    for q in qs:
        deps |= q.relations - skip
    return frozenset(deps)


def catalog_from_numpy(
    db_np: Mapping[str, np.ndarray], *, P: int = 8, device=None
) -> Catalog:
    cat = Catalog(P=P, device=device)
    cat.register_many(db_np)
    return cat
