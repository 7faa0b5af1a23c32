"""Cross-tick materialization cache with per-relation epoch invalidation.

The service re-executed every admitted query from scratch each tick; for
repeat traffic that is pure wasted total time *and* wasted communication —
a warm result shuffles zero bytes (the lower bounds of Afrati et al. apply
to computing a result, not to remembering one).  This cache stores two
kinds of materialization across ticks:

* ``"query"`` — the output :class:`~repro_torch.core.relation.Relation` of one
  canonical query.  The content key is the *closure blob*: the query plus
  its transitive intra-batch dependencies, re-canonicalized as a
  self-contained batch, so the key is independent of where the query
  landed in any particular tick's fused batch.
* ``"xmat"`` — one EVAL-input semi-join materialization
  ``X = π_{guard vars}(guard ⋉ atom)``.  The content key is the canonical
  (guard atom, conditional atom, out_vars) triple.  When a batch is only
  partially invalidated (one dep relation re-registered), the untouched
  equations are served from here and only the stale ones re-execute.

Every entry carries the dep key ``Catalog.dep_epochs(deps)`` — the
per-relation epochs of the base relations the materialization was computed
from.  Lookups build the *current* dep key; a mutated dependency therefore
misses (and the stale entry ages out of the LRU), while registrations of
unrelated relations leave entries warm.  Warm hits are bit-identical to
cold execution by construction: an equal dep key proves the inputs are the
same objects, and the engine is deterministic on fixed inputs.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Mapping

from repro_torch.core.algebra import SemiJoin
from repro_torch.core.relation import Relation
from repro_torch.obs.metrics import MetricRegistry, counter_attr

#: entry kinds (kept explicit so counters can split hit rates per kind)
KINDS = ("query", "xmat")


def xmat_content_key(sj: SemiJoin) -> tuple:
    """Content key of one semi-join materialization.

    ``sj`` must come from a *canonical* batch (variables ``v0, v1, ...``),
    so the key is alpha-independent; the pool-assigned output name
    (``X3@R|S``) is deliberately excluded — the same equation re-pooled at
    a different index in a later tick must still hit.
    """
    return ("xmat", repr(sj.guard), repr(sj.cond_atom), sj.out_vars)


@dataclass
class ResultEntry:
    rel: Relation
    deps: frozenset[str]  # base relations read (introspection / tests)
    hits: int = 0


class ResultCache:
    """LRU: ``(content key, dep epochs) -> Relation``; capacity 0 disables.

    Counters live under ``svc.result_cache.*`` in a
    :class:`~repro_torch.obs.MetricRegistry` (DESIGN.md §14); the attribute API
    (including the service's ``partial_skipped += 1``) is preserved via
    registry-backed properties.
    """

    def __init__(self, capacity: int = 256, *, metrics=None):
        self.capacity = capacity
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._entries: "OrderedDict[tuple, ResultEntry]" = OrderedDict()

    query_hits = counter_attr("svc.result_cache.query.hit")
    query_misses = counter_attr("svc.result_cache.query.miss")
    x_hits = counter_attr("svc.result_cache.x.hit")
    x_misses = counter_attr("svc.result_cache.x.miss")
    stale_evicted = counter_attr("svc.result_cache.stale_evicted")
    #: insertions withheld by the service's partial commit: a
    #: materialization whose producing job failed or was tainted
    #: (DESIGN.md §13) must never enter the cache — a later warm hit
    #: would serve a poisoned result as if it were clean.
    partial_skipped = counter_attr("svc.result_cache.partial_skipped")

    def __len__(self) -> int:
        return len(self._entries)

    def _count(self, kind: str, hit: bool) -> None:
        if kind == "query":
            self.query_hits += hit
            self.query_misses += not hit
        else:
            self.x_hits += hit
            self.x_misses += not hit

    def get(self, kind: str, content_key: tuple, dep_key: tuple) -> Relation | None:
        """The cached materialization, or None.  ``dep_key`` must be the
        *current* ``Catalog.dep_epochs`` of the entry's dependency set —
        a stale entry (mutated dep) simply never matches again."""
        if self.capacity == 0:
            self._count(kind, False)
            return None
        entry = self._entries.get((kind, content_key, dep_key))
        self._count(kind, entry is not None)
        if entry is None:
            return None
        entry.hits += 1
        self._entries.move_to_end((kind, content_key, dep_key))
        return entry.rel

    def put(
        self,
        kind: str,
        content_key: tuple,
        dep_key: tuple,
        rel: Relation,
        deps: frozenset[str],
    ) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown result kind {kind!r}; valid: {KINDS}")
        if self.capacity == 0:
            return
        self._entries[(kind, content_key, dep_key)] = ResultEntry(rel, deps)
        self._entries.move_to_end((kind, content_key, dep_key))
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def entries_reading(self, rel: str) -> int:
        """How many resident entries have ``rel`` in their dep set (the
        population an epoch bump of ``rel`` invalidates)."""
        return sum(1 for e in self._entries.values() if rel in e.deps)

    def evict_stale(self, rel_epochs: Mapping[str, int]) -> int:
        """Drop every entry whose dep key no longer matches the current
        per-relation epochs.  Stale entries can never hit again (epochs
        only move forward), but below LRU pressure they would otherwise
        pin their Relation arrays indefinitely; the service sweeps once
        per tick (O(resident entries), bounded by ``capacity``)."""
        stale = [
            key
            for key in self._entries
            if any(rel_epochs.get(name, 0) != ep for name, ep in key[2])
        ]
        for key in stale:
            del self._entries[key]
        self.stale_evicted += len(stale)
        return len(stale)

    def counters(self) -> dict:
        return {
            "query_hits": self.query_hits,
            "query_misses": self.query_misses,
            "x_hits": self.x_hits,
            "x_misses": self.x_misses,
            "stale_evicted": self.stale_evicted,
            "partial_skipped": self.partial_skipped,
            "size": len(self._entries),
        }
