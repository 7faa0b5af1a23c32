"""Plan cache keyed by canonical query fingerprints.

Repeated queries should not pay planning (the greedy grouping is
quadratic in the semi-join count).  That follows from one property:
structurally identical workloads must map to the *same*
plan object.  The admission batcher therefore alpha-renames every
admitted batch into a canonical form (query names ``q0, q1, ...``,
variables ``v0, v1, ...`` by first occurrence; relation names and
constants are catalog references and stay), and this module fingerprints
the canonical batch with the engine's 32-bit column hash
(:func:`repro_torch.engine.hashing.hash_cols`) folding the serialized batch.

A cache hit returns the previously built :class:`~repro_torch.core.planner.Plan`
verbatim.  Hit/miss counters are exposed for tests and benchmarks.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.algebra import Atom, BSGF, Cond, Not, cond_atoms
from repro_torch.core.planner import Plan
from repro_torch.engine import hashing
from repro_torch.obs.metrics import MetricRegistry, counter_attr


# --------------------------------------------------------------------------
# Canonicalization (alpha-renaming)
# --------------------------------------------------------------------------


def canonical_cond(
    cond: Cond | None, varmap: dict[str, str], relmap: Mapping[str, str]
) -> Cond | None:
    """Rename variables per ``varmap`` and relation names per ``relmap``
    (used for references to earlier query outputs within a batch)."""
    if cond is None:
        return None
    if isinstance(cond, Atom):
        terms = tuple(
            varmap[t] if isinstance(t, str) else t for t in cond.terms
        )
        return Atom(relmap.get(cond.rel, cond.rel), *terms)
    if isinstance(cond, Not):
        return Not(canonical_cond(cond.child, varmap, relmap))
    return type(cond)(
        canonical_cond(cond.left, varmap, relmap),
        canonical_cond(cond.right, varmap, relmap),
    )


def canonical_query_key(q: BSGF, relmap: Mapping[str, str] | None = None) -> tuple:
    """The name-independent canonical form of one query.

    Variables are renamed ``v0, v1, ...`` in order of first occurrence
    (guard first, then conditional atoms left to right); ``relmap``
    substitutes references to earlier outputs of the same batch.  Two
    queries with equal keys compute the same relation over the catalog —
    the admission batcher dedups on this key across tenants.
    """
    relmap = relmap or {}
    varmap: dict[str, str] = {}
    for t in q.guard.terms:
        if isinstance(t, str) and t not in varmap:
            varmap[t] = f"v{len(varmap)}"
    for a in cond_atoms(q.cond):
        for t in a.terms:
            if isinstance(t, str) and t not in varmap:
                varmap[t] = f"v{len(varmap)}"
    guard = Atom(
        relmap.get(q.guard.rel, q.guard.rel),
        *[varmap[t] if isinstance(t, str) else t for t in q.guard.terms],
    )
    return (
        tuple(varmap[v] for v in q.out_vars),
        guard,
        canonical_cond(q.cond, varmap, relmap),
    )


def canonicalize(queries: Sequence[BSGF]) -> tuple[list[BSGF], dict[str, str]]:
    """Alpha-rename a query sequence to canonical names ``q0, q1, ...``.

    Returns the canonical queries plus the original-name -> canonical-name
    mapping.  Later queries' references to earlier outputs follow the
    rename, so an SGF stays a valid SGF.
    """
    relmap: dict[str, str] = {}
    out: list[BSGF] = []
    for q in queries:
        key = canonical_query_key(q, relmap)
        name = f"q{len(out)}"
        relmap[q.name] = name
        out.append(BSGF(name, key[0], key[1], key[2]))
    return out, relmap


def fingerprint_queries(queries: Sequence[BSGF], *, canonical: bool = False) -> int:
    """Canonical 32-bit fingerprint of a query batch.

    The canonical batch is serialized (reprs are deterministic) and folded
    into one uint32 with the engine's column hash.  Alpha-equivalent
    batches collide by construction; unrelated batches collide with hash
    probability only, which costs a spurious cache key, never correctness
    (the cache is consulted with the full key, see :class:`PlanCache`).
    """
    canon = list(queries) if canonical else canonicalize(queries)[0]
    blob = "\x1f".join(repr(q) for q in canon).encode()
    blob += b"\0" * (-len(blob) % 4)
    words = np.frombuffer(blob, dtype=np.int32)
    if words.size == 0:
        words = np.zeros(1, np.int32)
    # host-side hash of a few hundred words: the fingerprint is a cache key
    # on the host, so it never touches the card
    h = hashing.hash_cols(torch.from_numpy(words.copy())[None, :])
    return int(h[0])


# --------------------------------------------------------------------------
# The cache
# --------------------------------------------------------------------------


@dataclass
class CacheEntry:
    plan: Plan
    hits: int = 0


class PlanCache:
    """LRU cache: (canonical fingerprint, dep epochs, canonical blob) -> Plan.

    The fingerprint is a *shard*, never trusted for identity: the full
    canonical blob is part of the lookup key, so two batches whose 32-bit
    fingerprints collide coexist as separate entries (``collisions``
    counts distinct resident blobs beyond the first per fingerprint)
    instead of evicting each other every tick.

    ``epoch_key`` is whatever versioning the caller derives from the
    catalog — the service passes ``Catalog.dep_epochs(...)`` over the
    ``catalog.query_deps`` dependency set of the (cold) batch it is about
    to plan, i.e. the per-relation epochs of the relations the batch
    actually reads, so an unrelated registration leaves entries valid
    (DESIGN.md §10).  A plain int (the old global epoch) still works.

    Counters live in a :class:`~repro_torch.obs.MetricRegistry` under
    ``svc.plan_cache.*`` (DESIGN.md §14); the ``hits``/``misses``/
    ``collisions`` attributes and :meth:`counters` keys are compatibility
    properties over the registry, so existing call sites are unchanged.
    """

    def __init__(self, capacity: int = 128, *, metrics=None):
        self.capacity = capacity
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._entries: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._fp_blobs: dict[int, set[tuple]] = {}  # resident blobs per fp shard

    hits = counter_attr("svc.plan_cache.hit")
    misses = counter_attr("svc.plan_cache.miss")
    collisions = counter_attr("svc.plan_cache.collision")

    def get_or_plan(
        self,
        queries: Sequence[BSGF],
        epoch_key,
        planner: Callable[[], Plan],
        *,
        canonical: bool = False,
    ) -> tuple[Plan, bool]:
        """Return ``(plan, was_hit)``; ``planner`` runs only on a miss.

        ``queries`` are the batch to plan; pass ``canonical=True`` when the
        caller already alpha-renamed them (the admission batcher does).
        """
        canon = list(queries) if canonical else canonicalize(queries)[0]
        fp = fingerprint_queries(canon, canonical=True)
        blob = tuple(repr(q) for q in canon)
        key = (fp, epoch_key, blob)
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            entry.hits += 1
            self._entries.move_to_end(key)
            return entry.plan, True
        self.misses += 1
        plan = planner()
        resident = self._fp_blobs.setdefault(fp, set())
        if resident and blob not in resident:
            self.collisions += 1
        resident.add(blob)
        self._entries[key] = CacheEntry(plan)
        while len(self._entries) > self.capacity:
            (old_fp, _, old_blob), _ = self._entries.popitem(last=False)
            if not any(
                k[0] == old_fp and k[2] == old_blob for k in self._entries
            ):
                shard = self._fp_blobs.get(old_fp)
                if shard is not None:
                    shard.discard(old_blob)
                    if not shard:
                        del self._fp_blobs[old_fp]
        return plan, False

    def counters(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "collisions": self.collisions,
            "size": len(self._entries),
        }
