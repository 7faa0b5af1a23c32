"""The multi-semi-join operator MSJ(S) — the paper's core contribution,
adapted from Hadoop MapReduce to sharded tensors on a CUDA card.

One MSJ *job* evaluates a set of semi-join equations
``S = {X_i := π_x̄i(α_i ⋉ κ_i)}`` with:

* **map stage** (per shard, vectorized): guard facts conforming to α_i emit
  Req messages keyed by the join key; conditional facts conforming to κ_i
  emit Assert messages. Assert messages are tagged by *signature* so
  semi-joins whose conditional atoms accept the same facts with the same key
  projection share Asserts (the paper's "conditional name sharing").
* **shuffle**: radix partition by a per-row (signature, key) *fingerprint* +
  ``all_to_all``, replacing Hadoop's sort-based shuffle.  The forward
  buffer is **count-sized**: a cheap first phase exchanges per-destination
  counts and the data exchange is sized to the observed max bucket instead
  of the no-assumption worst case (DESIGN.md §6).
* **probe stage** (the reducer): Req keys probe the Assert build side.
  Backends: the bucketed CUDA ``msj_probe`` kernel (the executor's default
  on the card), sort-merge in torch, or the dense oracle.
* **route-back**: hit bits return to the origin shard via a second
  ``all_to_all`` and are scattered into a guard-aligned bitmap.

The route-back replaces the paper's materialize-then-EVAL dataflow with a
guard-aligned bitmap, which both supports the faithful plan (materialize
X_i then run EVAL) and a *generalized 1-ROUND* plan (apply the Boolean
formula locally — beyond-paper, see DESIGN.md §7).

**Message packing** (paper §5.1 optimization (1)): Req/Assert messages are
deduplicated per (signature, key); the group leader is shuffled and hit
bits are re-expanded through the leader index on the way back.
Optimization (2) (tuple ids instead of tuples) is inherent: Req messages
carry ``(origin_shard, row)`` only.

**Fingerprints** (DESIGN.md §5): each message's (signature, key) identity
is packed once at map time into a single int32 column — the key itself
when ``key_width == 1`` (exact, lex-preserving), a salted hash otherwise —
and every downstream sort/dedup/route/probe operates on that one column
instead of ``key_width + 2``.  Matching stays exact on the key columns, so
fingerprint collisions never affect correctness.

Every sort here is stable (``stable=True``): elected leaders, message
positions and origin rows must be the reference's, bit for bit.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from repro_torch.core.algebra import Cond, SemiJoin, eval_cond
from repro_torch.core.relation import Relation
from repro_torch.engine import hashing, shuffle
from repro_torch.engine.comm import Comm, run_pipeline
from repro_torch.kernels.bloom import ops as bloom_ops

KIND_ASSERT = 0
KIND_REQ = 1


# --------------------------------------------------------------------------
# Static spec derived from the semi-join set
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class _SjInfo:
    guard_rel: str
    guard_pattern: tuple
    guard_keypos: tuple[int, ...]  # positions of key vars in the guard atom
    out_pos: tuple[int, ...]  # positions of out vars in the guard atom
    sig_id: int


@dataclass(frozen=True)
class _SigInfo:
    rel: str
    pattern: tuple
    keypos: tuple[int, ...]  # positions of key vars in the conditional atom


@dataclass(frozen=True)
class MSJSpec:
    sjs: tuple[SemiJoin, ...]
    sj_info: tuple[_SjInfo, ...]
    sigs: tuple[_SigInfo, ...]
    key_width: int  # KW: max join-key arity over signatures
    fingerprint: bool = True

    @property
    def n_sj(self) -> int:
        return len(self.sjs)

    @property
    def fp_exact(self) -> bool:
        """Single key column: the fingerprint is the key (no collisions)."""
        return self.key_width == 1

    @property
    def msg_width(self) -> int:
        if not self.fingerprint:
            # legacy layout: [kind, tag, key*KW, src_shard, src_row]
            return self.key_width + 4
        # fingerprint layout (DESIGN.md §5): [kindtag, fp, keys (wide only),
        # srcrow].  The modeled width assumes the packed srcrow column; the
        # runtime falls back to a split (src, row) pair (+1) only when
        # P * guard_cap would overflow int32.
        return 3 + (0 if self.fp_exact else self.key_width)

    @property
    def guard_rels(self) -> tuple[str, ...]:
        seen: list[str] = []
        for info in self.sj_info:
            if info.guard_rel not in seen:
                seen.append(info.guard_rel)
        return tuple(seen)


def make_spec(sjs: Sequence[SemiJoin], *, fingerprint: bool = True) -> MSJSpec:
    sigs: list[tuple] = []
    sig_infos: list[_SigInfo] = []
    sj_infos: list[_SjInfo] = []
    for sj in sjs:
        sig = sj.signature()
        if sig in sigs:
            sid = sigs.index(sig)
        else:
            sid = len(sigs)
            sigs.append(sig)
            keypos = tuple(sj.cond_atom.positions_of(v)[0] for v in sj.key_vars)
            sig_infos.append(
                _SigInfo(
                    rel=sj.cond_atom.rel,
                    pattern=sj.cond_atom.conform_pattern(),
                    keypos=keypos,
                )
            )
        gkeypos = tuple(sj.guard.positions_of(v)[0] for v in sj.key_vars)
        outpos = tuple(sj.guard.positions_of(v)[0] for v in sj.out_vars)
        sj_infos.append(
            _SjInfo(
                guard_rel=sj.guard.rel,
                guard_pattern=sj.guard.conform_pattern(),
                guard_keypos=gkeypos,
                out_pos=outpos,
                sig_id=sid,
            )
        )
    kw = max([len(s.keypos) for s in sig_infos], default=0)
    return MSJSpec(
        sjs=tuple(sjs),
        sj_info=tuple(sj_infos),
        sigs=tuple(sig_infos),
        key_width=max(kw, 1),
        fingerprint=fingerprint,
    )


@dataclass(frozen=True)
class MsgLayout:
    """Concrete forward-message column layout for one job (DESIGN.md §5).

    fingerprint layout::

        [kindtag, fp, key_0 .. key_{KW-1} (wide keys only), srcrow]

    * ``kindtag = tag*2 + kind`` fuses the message kind bit into the tag.
    * ``fp`` is the (signature, key) fingerprint; when ``exact`` the key
      columns are omitted entirely (``fp`` *is* the key).
    * ``srcrow = src*row_mod + row`` packs the origin coordinate into one
      column whenever ``P*row_mod`` fits int32 (``row_mod == 0`` means the
      split legacy (src, row) pair is used).

    legacy layout (``fingerprint=False``): ``[kind, tag, key*KW, src, row]``.
    """

    key_width: int
    fingerprint: bool
    exact: bool
    row_mod: int

    @property
    def width(self) -> int:
        if not self.fingerprint:
            return self.key_width + 4
        kw = 0 if self.exact else self.key_width
        return 2 + kw + (1 if self.row_mod else 2)


def make_layout(spec: MSJSpec, db: dict, P: int) -> MsgLayout:
    if not spec.fingerprint:
        return MsgLayout(spec.key_width, False, False, 0)
    max_cap = max((db[i.guard_rel].cap for i in spec.sj_info), default=1)
    row_mod = max(max_cap, 1)
    if P * row_mod >= 2**31:
        row_mod = 0  # origin coordinate can't pack; fall back to two columns
    return MsgLayout(spec.key_width, True, spec.fp_exact, row_mod)


# --------------------------------------------------------------------------
# Shard-local primitives
# --------------------------------------------------------------------------


def conform_mask(data: torch.Tensor, valid: torch.Tensor, pattern: tuple) -> torch.Tensor:
    """Rows of ``data`` conforming to an atom's pattern (constants equal,
    repeated variables equal)."""
    m = valid
    for i, p in enumerate(pattern):
        if p[0] == "const":
            m = m & (data[:, i] == int(p[1]))
        else:
            j = p[1]
            if j != i:
                m = m & (data[:, i] == data[:, j])
    return m


def _pad_keys(keys: torch.Tensor, kw: int) -> torch.Tensor:
    n, k = keys.shape
    if k == kw:
        return keys
    pad = torch.zeros((n, kw - k), dtype=torch.int32, device=keys.device)
    return torch.cat([keys, pad], dim=1)


def _lex_order(cols: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort over multiple int32/bool key columns
    (most-significant first)."""
    n = cols[0].shape[0]
    order = torch.arange(n, dtype=torch.int64, device=cols[0].device)
    for c in reversed(cols):
        c = c.to(torch.int32)
        order = order[torch.argsort(c[order], stable=True)]
    return order


def _leaders_from_sorted(
    order: torch.Tensor, act_s: torch.Tensor, neq_prev: torch.Tensor, active: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared tail of the dedup paths: leader flags + leader-row map from a
    sorted view, scattered back to original row order."""
    n = order.shape[0]
    dev = order.device
    is_leader_s = act_s & neq_prev
    # leader row (original index) for each sorted position, propagated
    # through the run via a cumulative max over flagged positions.
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    leader_pos_s = torch.cummax(torch.where(is_leader_s, pos, -1), dim=0).values
    leader_pos_s = torch.clamp(leader_pos_s, min=0)
    rep_s = order[leader_pos_s]
    is_leader = torch.zeros((n,), dtype=torch.bool, device=dev)
    is_leader[order] = is_leader_s
    rep = torch.zeros((n,), dtype=torch.int64, device=dev)
    rep[order] = rep_s
    rep = torch.where(active, rep, pos)
    return is_leader, rep.to(torch.int32)


def _dedup_by_key(
    keys: torch.Tensor, active: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (sig-local) key dedup — the message-packing optimization
    (legacy multi-column path; see :func:`_dedup_fp` for the hot path).

    Returns ``(is_leader, rep_row)``: ``is_leader[i]`` marks the first active
    row of each distinct key; ``rep_row[i]`` is the row index of row i's
    group leader (identity for inactive rows).
    """
    n, kw = keys.shape
    inact = (~active).to(torch.int32)
    order = _lex_order([inact] + [keys[:, k] for k in range(kw)])
    keys_s = keys[order]
    act_s = active[order]
    neq_prev = torch.ones((n,), dtype=torch.bool, device=keys.device)
    if n > 1:
        neq_prev[1:] = (keys_s[1:] != keys_s[:-1]).any(dim=1)
    return _leaders_from_sorted(order, act_s, neq_prev, active)


def _map_source(
    spec: MSJSpec, P: int, rel: Relation, pattern: tuple,
    keypos: tuple[int, ...], salt: int,
):
    """Shared map-side source computation: (conform, padded keys,
    fingerprint, destination shard).

    Both the count phase (:func:`count_forward_cap`) and the data phase
    (``stage_map``) go through here — the count-sizing invariant (counts
    ≥ actual sends) depends on the two phases computing the identical
    send set, so there is exactly one implementation.
    """
    conf = conform_mask(rel.data, rel.valid, pattern)
    keys = _pad_keys(
        rel.data[:, list(keypos)]
        if keypos
        else torch.zeros((rel.cap, 0), dtype=torch.int32, device=rel.data.device),
        spec.key_width,
    )
    if spec.fingerprint:
        fp = hashing.fingerprint(keys, salt=salt, exact=spec.fp_exact)
        dest = hashing.route_of(fp, salt, P)
    else:
        fp = None
        dest = hashing.bucket_of(hashing.hash_cols(keys, salt=salt), P)
    return conf, keys, fp, dest


def _dedup(spec: MSJSpec, fp, keys, active):
    """Dispatch to the fingerprint or legacy dedup per the spec."""
    if spec.fingerprint:
        return _dedup_fp(fp, keys, active, spec.fp_exact)
    return _dedup_by_key(keys, active)


def _dedup_fp(
    fp: torch.Tensor, keys: torch.Tensor | None, active: torch.Tensor, exact: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fingerprint dedup: ONE argsort regardless of key width.

    Rows are sorted by the fingerprint (inactive rows pushed to a sentinel)
    and leader runs are refined by comparing the exact key columns of
    adjacent rows, so a fingerprint collision can only split a key group
    into extra leaders (lost packing), never merge distinct keys.  Chains
    are also broken across inactive rows, which makes the sentinel value
    colliding with a real fingerprint harmless.
    """
    n = fp.shape[0]
    # uint32 order of fp, with the uint32-max sentinel: int64 keys
    sortkey = torch.where(active, hashing.u32(fp), hashing.MASK32)
    order = torch.argsort(sortkey, stable=True)
    fp_s = fp[order]
    act_s = active[order]
    neq_prev = torch.ones((n,), dtype=torch.bool, device=fp.device)
    if n > 1:
        diff = fp_s[1:] != fp_s[:-1]
        if not exact:
            keys_s = keys[order]
            diff = diff | (keys_s[1:] != keys_s[:-1]).any(dim=1)
        diff = diff | ~act_s[:-1]
        neq_prev[1:] = diff
    return _leaders_from_sorted(order, act_s, neq_prev, active)


def probe_sorted(
    build_sig: torch.Tensor,
    build_keys: torch.Tensor,
    build_ok: torch.Tensor,
    probe_sig: torch.Tensor,
    probe_keys: torch.Tensor,
    probe_ok: torch.Tensor,
    *,
    build_fp: torch.Tensor | None = None,
    probe_fp: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sort-merge existence probe: for each probe row, does any build row
    share its (signature, key)?  O(n log n); the pure-torch counterpart of
    the CUDA ``msj_probe`` kernel.  Fingerprints are accepted (probe_fn
    interface) but unused — this backend sorts the exact columns."""
    del build_fp, probe_fp
    nb = build_sig.shape[0]
    np_ = probe_sig.shape[0]
    kw = build_keys.shape[1]
    dev = build_sig.device
    sig = torch.cat([build_sig, probe_sig]).to(torch.int32)
    keys = torch.cat([build_keys, probe_keys]).to(torch.int32)
    ok = torch.cat([build_ok, probe_ok])
    is_build = torch.cat([
        torch.ones((nb,), dtype=torch.bool, device=dev),
        torch.zeros((np_,), dtype=torch.bool, device=dev),
    ])
    sig = torch.where(ok, sig, 2**30)  # inactive rows to the end
    order = _lex_order([sig] + [keys[:, k] for k in range(kw)])
    sig_s, keys_s, build_s, ok_s = sig[order], keys[order], is_build[order], ok[order]
    n = nb + np_
    new_grp = torch.ones((n,), dtype=torch.bool, device=dev)
    if n > 1:
        new_grp[1:] = (sig_s[1:] != sig_s[:-1]) | (keys_s[1:] != keys_s[:-1]).any(dim=1)
    gid = torch.cumsum(new_grp.to(torch.int64), 0) - 1
    has_build = torch.zeros((n,), dtype=torch.int32, device=dev).scatter_reduce_(
        0, gid, (build_s & ok_s).to(torch.int32), reduce="amax"
    )
    hit_s = has_build[gid].bool() & ok_s & ~build_s
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    hit[order] = hit_s
    return hit[nb:]


def probe_dense(
    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
    *, build_fp=None, probe_fp=None,
) -> torch.Tensor:
    """Quadratic all-pairs probe (tiny-input oracle for tests)."""
    del build_fp, probe_fp
    eq_sig = probe_sig[:, None] == build_sig[None, :]
    eq_key = (probe_keys[:, None, :] == build_keys[None, :, :]).all(-1)
    m = eq_sig & eq_key & probe_ok[:, None] & build_ok[None, :]
    return m.any(dim=1)


def _probe_takes_fp(probe_fn: Callable) -> bool:
    """Does ``probe_fn`` accept the fingerprint keywords? (Custom callables
    with the legacy 6-argument signature remain drop-in compatible.)"""
    try:
        params = inspect.signature(probe_fn).parameters
    except (TypeError, ValueError):
        return False
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return True
    return "probe_fp" in params


# --------------------------------------------------------------------------
# Skew defense (DESIGN.md §17): heavy-hitter salting + build replication
# --------------------------------------------------------------------------

#: fixed salt for the *skew* fingerprint.  Hotness must be a pure function
#: of (signature triple, key) — the forward-message fingerprint is salted
#: by sig_id and therefore unstable under ``narrow_job``'s signature
#: renumbering, so the skew path derives its own fingerprint with this
#: constant salt (for single-column keys it is the key itself, exact).
SKEW_SALT = 0x5EED


def _skew_fp(spec: MSJSpec, keys: torch.Tensor) -> torch.Tensor:
    """Salt-independent key fingerprint used only for hot-key detection.
    Collisions can only over-replicate / over-salt (both exactness-
    preserving), never corrupt results."""
    return hashing.fingerprint(keys, salt=SKEW_SALT, exact=spec.fp_exact)


def sig_key_of(sig: _SigInfo) -> tuple:
    """Stable identity of an Assert signature: ``(rel, pattern, keypos)``.
    Unlike the positional sig_id, this survives ``narrow_job`` dropping
    semi-joins and renumbering the survivors — the SaltTable is keyed by
    it so a narrowed transfer can still look its signatures up."""
    return (sig.rel, sig.pattern, sig.keypos)


@dataclass(frozen=True)
class SaltTable:
    """What a :class:`~repro_torch.core.planner.SkewProfileJob` publishes
    under its ``%salt<i>`` name: merged per-signature heavy-hitter counts
    from the map-side sketch, plus the R/threshold the plan annotation
    chose.  ``counts`` is ``((sig_key, ((skew_fp, count), ...)), ...)``."""

    R: int
    threshold: int
    counts: tuple

    def __repr__(self):
        n_hot = sum(
            1 for _, fps in self.counts for _, n in fps if n >= self.threshold
        )
        return f"SaltTable(R={self.R}, thr={self.threshold}, hot={n_hot})"


@dataclass(frozen=True)
class SkewRoute:
    """Resolved hot-key routing for ONE msj run: ``hot[s_id]`` is the
    tuple of hot skew-fingerprints for the spec's signature ``s_id`` (spec
    order).  Hot Req rows are salted across R consecutive reducers
    ``(dest + row) mod R``-style; hot Assert rows are replicated to all R
    (DESIGN.md §17)."""

    R: int
    hot: tuple

    def live(self, *, packing: bool, P: int) -> "SkewRoute | None":
        """Normalize to the route the kit will actually apply, or ``None``
        when salting is a no-op or unsound:

        * ``P < 2`` or ``R < 2`` or an empty hot set — nothing to split;
        * ``packing`` — leader dedup already bounds any key's forward
          fan-in to ≤ 1 message per map shard, and row-salted destinations
          are incompatible with leader-based count sizing, so packed jobs
          are never salted
          (:func:`~repro_torch.core.costmodel.choose_skew` never defends
          them).
        """
        if packing or P < 2 or self.R < 2 or not any(self.hot):
            return None
        if self.R <= P:
            return self
        return SkewRoute(R=P, hot=self.hot)


def skew_route_of(table: SaltTable, spec: MSJSpec) -> SkewRoute:
    """Resolve a published :class:`SaltTable` against THIS run's spec.
    Signatures absent from the table (e.g. after the profile was narrowed
    around a fault) get an empty hot set — plain routing, still exact."""
    by_key = dict(table.counts)
    hot = []
    for sig in spec.sigs:
        fps = by_key.get(sig_key_of(sig), ())
        hot.append(tuple(int(v) for v, n in fps if n >= table.threshold))
    return SkewRoute(R=int(table.R), hot=tuple(hot))


def collect_salt_table(
    db: dict[str, Relation],
    sjs: Sequence[SemiJoin],
    *,
    R: int,
    threshold: int,
    top_k: int = 8,
    fingerprint: bool = True,
) -> SaltTable:
    """The skew-profile pass: run the bounded top-k sketch
    (``shuffle.topk_fp_counts``) over each guard relation's conforming key
    fingerprints — map-side only, once per shard of the P shard axis,
    merged on host.  No communication: this is the same scan ``stage_map``
    performs, minus message materialization."""
    spec = make_spec(list(sjs), fingerprint=fingerprint)
    entries = []
    for s_id, sig in enumerate(spec.sigs):
        vals_l, cnts_l = [], []
        for info in spec.sj_info:
            if info.sig_id != s_id:
                continue
            rel = db[info.guard_rel]
            for p in range(rel.P):
                data, valid = rel.data[p], rel.valid[p]
                conf = conform_mask(data, valid, info.guard_pattern)
                keys = _pad_keys(
                    data[:, list(info.guard_keypos)]
                    if info.guard_keypos
                    else torch.zeros((data.shape[0], 0), dtype=torch.int32,
                                     device=data.device),
                    spec.key_width,
                )
                vals, cnts = shuffle.topk_fp_counts(_skew_fp(spec, keys), conf, top_k)
                vals_l.append(vals)
                cnts_l.append(cnts)
        merged = (
            shuffle.merge_topk(torch.cat(vals_l), torch.cat(cnts_l), top_k)
            if vals_l
            else ()
        )
        entries.append((sig_key_of(sig), tuple(merged)))
    return SaltTable(R=int(R), threshold=int(threshold), counts=tuple(entries))


def _skew_hot_mask(spec: MSJSpec, skew: SkewRoute, sig_id: int, keys):
    """Per-row hot flag for one map source, or ``None`` when the source's
    signature has no hot keys.  Computed identically in the count phase
    and the data phase — the count-sizing invariant extends to salted
    destinations only because both phases share this mask."""
    fps = skew.hot[sig_id] if sig_id < len(skew.hot) else ()
    if not fps:
        return None
    fp = _skew_fp(spec, keys)
    table = torch.tensor(fps, dtype=torch.int32, device=keys.device)
    return (fp[:, None] == table[None, :]).any(dim=1)


def _skew_req_dest(dest, hot, R: int, P: int):
    """Salted destination for hot Req rows: row i of a hot key goes to
    ``(base_dest + i mod R) mod P``.  Every Req still reaches exactly ONE
    reducer (≤ 1 back message per (row, tag) — the rid-dedup invariant);
    the matching build rows are replicated to all R so the probe stays
    exact."""
    rows = torch.arange(dest.shape[0], dtype=torch.int32, device=dest.device)
    return torch.where(hot, (dest + rows % R) % P, dest)


# --------------------------------------------------------------------------
# The MSJ job
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class FusedQuery:
    """A BSGF whose semi-joins all live in this MSJ job; its Boolean formula
    is applied locally on the returned bitmap (generalized 1-ROUND)."""

    name: str
    cond: Cond
    atom_to_sj: dict  # Atom -> sj index within the spec
    guard_rel: str
    guard_pattern: tuple
    out_pos: tuple[int, ...]


def default_forward_cap(
    spec: MSJSpec, db: dict, P: int, slack: float = 1.0,
    skew: SkewRoute | None = None,
) -> int:
    """Worst-case per-destination bucket capacity for the forward shuffle.

    ``slack=1.0`` is the no-assumption bound (everything to one shard);
    smaller values trade memory for overflow risk, which the supervisor
    handles by retrying with a larger capacity.  The count-sized path
    (:func:`count_forward_cap`) replaces this bound with the observed max
    bucket occupancy.  A live skew route adds the worst-case
    replicated-build mass: ``(R−1)`` extra copies of every Assert source.
    """
    total = 0
    for info in spec.sj_info:
        total += db[info.guard_rel].cap
    rep = (min(skew.R, P) - 1) if skew is not None and skew.R > 1 else 0
    for sig in spec.sigs:
        total += db[sig.rel].cap * (1 + rep)
    if slack >= 1.0 or P == 1:
        return max(total, 1)
    # slack < 1 undersizes buckets proportionally (memory saving, overflow
    # risk); the supervisor retries at slack=1.0 on detection
    return max(1, int(total * slack) + 1)


def count_forward_cap(
    spec: MSJSpec,
    db: dict[str, Relation],
    comm: Comm,
    *,
    packing: bool = True,
    slack: float = 1.0,
    skew: SkewRoute | None = None,
) -> int:
    """Phase one of the two-phase count-sized shuffle (DESIGN.md §6).

    Runs the map-side send-set computation (conform + packing dedup +
    routing — no message materialization, no bloom filtering so the counts
    upper-bound the filtered sends) and reduces the exact per-(src, dest)
    message counts to the max bucket occupancy.

    A live ``skew`` route is mirrored exactly: hot Req rows are counted at
    their salted destinations and hot Assert rows are counted once per
    replica, so count-sizing stays an upper bound under the defense.
    """
    P = comm.P

    def stage_count(sid, local_db):
        dev = next(iter(local_db.values())).data.device
        total = torch.zeros((P,), dtype=torch.int64, device=dev)
        sources = [
            (info.guard_rel, info.guard_pattern, info.guard_keypos,
             info.sig_id, True)
            for info in spec.sj_info
        ] + [
            (s.rel, s.pattern, s.keypos, s_id, False)
            for s_id, s in enumerate(spec.sigs)
        ]
        for rel_name, pattern, keypos, sig_id, is_req in sources:
            conf, keys, fp, dest = _map_source(
                spec, P, local_db[rel_name], pattern, keypos, sig_id
            )
            send = conf
            if packing:
                is_leader, _ = _dedup(spec, fp, keys, conf)
                send = is_leader
            hot = (
                _skew_hot_mask(spec, skew, sig_id, keys)
                if skew is not None
                else None
            )
            if hot is not None and is_req:
                dest = _skew_req_dest(dest, hot, skew.R, P)
            d = torch.where(send, dest.to(torch.int64), P)
            total = total + torch.bincount(d, minlength=P + 1)[:P]
            if hot is not None and not is_req:
                for r in range(1, skew.R):
                    d_r = torch.where(send & hot, ((dest + r) % P).to(torch.int64), P)
                    total = total + torch.bincount(d_r, minlength=P + 1)[:P]
        return None, total.to(torch.int32)

    rel_names = sorted({i.guard_rel for i in spec.sj_info} | {s.rel for s in spec.sigs})
    stacked = {name: db[name] for name in rel_names}
    counts = run_pipeline(comm, [stage_count], stacked)
    cap = int(counts.max())
    if slack < 1.0:
        return max(1, int(cap * slack))
    return max(1, cap)


def _sized_cap(
    spec: MSJSpec,
    db: dict[str, Relation],
    comm: Comm,
    *,
    packing: bool,
    forward_cap: int | None,
    count_sized: bool,
    cap_slack: float,
    tracer=None,
    skew: SkewRoute | None = None,
) -> tuple[int, bool]:
    """Resolve the forward-shuffle bucket capacity: explicit override,
    count-sized (two-phase, DESIGN.md §6), or worst-case bound.  Returns
    ``(cap, counted)`` where ``counted`` marks a count phase (its ``P·P``
    int32 exchange is then charged to ``bytes_fwd``)."""
    traced = tracer is not None
    if forward_cap is not None:
        return forward_cap, False
    if not count_sized:
        return default_forward_cap(spec, db, comm.P, cap_slack, skew=skew), False
    if traced:
        with tracer.span("msj.count") as _sp:
            cap_s = count_forward_cap(
                spec, db, comm, packing=packing, slack=cap_slack, skew=skew
            )
            _sp.args["cap"] = cap_s
    else:
        cap_s = count_forward_cap(
            spec, db, comm, packing=packing, slack=cap_slack, skew=skew
        )
    return cap_s, True


@dataclass
class XferBuffer:
    """The value a transfer sub-node publishes under its ``%xfer<i>`` name
    (DESIGN.md §16): the forward-exchanged message buffers plus the
    map-side carry, with enough metadata for the paired compute node to
    rebuild the message spec/layout and finish the probe.  Not a
    :class:`Relation` — the executor neither compacts nor commits it, and
    it is dropped from the environment once its compute completes."""

    name: str
    sjs: tuple  # SemiJoins the spec was built with (probe decode key)
    data: object  # ((recv, recv_valid), map_carry) pipeline carry
    cap: int
    counted: bool
    packing: bool = True
    fingerprint: bool = True
    bloom_bits: int = 0

    def __repr__(self):
        return f"XferBuffer({self.name}, cap={self.cap}, n_sj={len(self.sjs)})"


class _MSJKit:
    """The MSJ operator's stage closures over one (spec, db, cap) triple.

    :func:`run_msj` composes all stages into one pipeline; the overlap
    path runs ``[bloom?, map]`` in :func:`run_msj_transfer` and
    ``[probe, out]`` in :func:`run_msj_compute` against the *same* kit
    parameters, so split and unsplit execution are stage-for-stage
    identical and therefore bit-identical.
    """

    def __init__(
        self,
        db: dict[str, Relation],
        spec: MSJSpec,
        comm: Comm,
        cap_s: int,
        *,
        packing: bool = True,
        fused: Sequence[FusedQuery] = (),
        probe_fn: Callable | None = None,
        bloom_bits: int = 0,
        fingerprint: bool = True,
        skew: SkewRoute | None = None,
    ):
        if probe_fn is None:
            probe_fn = probe_sorted
        self.spec = spec
        self.cap_s = cap_s
        # callers pass the already-normalized route (SkewRoute.live); the
        # probe/out stages never consult it — only stage_map routes
        self.skew = skew
        self.use_bloom = use_bloom = bloom_bits > 0
        P = comm.P
        KW = spec.key_width
        layout = make_layout(spec, db, P)
        self.layout = layout
        self.W = W = layout.width
        pass_fp = fingerprint and _probe_takes_fp(probe_fn)

        rel_names = sorted(
            {i.guard_rel for i in spec.sj_info} | {s.rel for s in spec.sigs}
        )
        self.rel_names = rel_names
        self.stacked = {name: db[name] for name in rel_names}
        dev = db[rel_names[0]].data.device
        sig_of_sj = torch.tensor(
            [i.sig_id for i in spec.sj_info], dtype=torch.int32, device=dev
        )

        def _msg_stack(kind, tag, fp, keys, src_col, rows):
            n = rows.shape[0]
            if not fingerprint:
                return torch.stack(
                    [
                        torch.full((n,), kind, dtype=torch.int32, device=dev),
                        torch.full((n,), tag, dtype=torch.int32, device=dev),
                    ]
                    + [keys[:, k] for k in range(KW)]
                    + [src_col, rows],
                    dim=1,
                )
            cols = [torch.full((n,), tag * 2 + kind, dtype=torch.int32, device=dev), fp]
            if not spec.fp_exact:
                cols += [keys[:, k] for k in range(KW)]
            if layout.row_mod:
                cols.append(src_col * layout.row_mod + rows)
            else:
                cols += [src_col, rows]
            return torch.stack(cols, dim=1)

        # ---------------- stage 0 (optional): bloom prefilter ----------------
        # Build a per-shard bloom filter over Assert keys, all-reduce(OR) it, and
        # drop Req messages whose key cannot match — trades one small all-reduce
        # for forward-shuffle bytes (beyond-paper; see DESIGN.md §7).
        def _assert_keys(local_db):
            akeys, asigs, amask, afp = [], [], [], []
            for s_id, sig in enumerate(spec.sigs):
                rel = local_db[sig.rel]
                conf, keys, fp, _ = _map_source(spec, P, rel, sig.pattern, sig.keypos, s_id)
                akeys.append(keys)
                asigs.append(torch.full((rel.cap,), s_id, dtype=torch.int32, device=dev))
                amask.append(conf)
                if fingerprint:
                    afp.append(fp)
            return (
                torch.cat(akeys, 0),
                torch.cat(asigs, 0),
                torch.cat(amask, 0),
                torch.cat(afp, 0) if fingerprint else None,
            )

        def stage_bloom(sid, local_db):
            keys, sigs_arr, mask, fp = _assert_keys(local_db)
            words = bloom_ops.build(keys, sigs_arr, mask, bloom_bits, fp=fp)
            # broadcast-by-all_to_all: every destination receives our words;
            # the next stage ORs over sources == an all-reduce(OR).  The
            # broadcast stays a view: the exchange copies it into the
            # received buffer once
            bcast = words[None].expand((P,) + tuple(words.shape))
            return (bcast,), local_db

        # ---------------- stage 1: map + forward partition ----------------
        def stage_map(sid, carry_in):
            if use_bloom:
                (recv_words,), local_db = carry_in
                # OR-reduce over sources into the packed bitset, once per shard
                bloom_packed = bloom_ops.pack(recv_words)
            else:
                local_db, bloom_packed = carry_in, None
            msgs_list, valid_list, dest_list = [], [], []
            conf_by_sj, rep_by_sj = [], []
            rep_count = torch.zeros((), dtype=torch.int32, device=dev)

            # Req messages per semi-join; hot rows are salted across the
            # route's R consecutive reducers (count phase mirrors this)
            for i, info in enumerate(spec.sj_info):
                rel = local_db[info.guard_rel]
                conf, keys, fp, dest = _map_source(
                    spec, P, rel, info.guard_pattern, info.guard_keypos, info.sig_id
                )
                conf_by_sj.append(conf)
                send = conf
                if use_bloom:
                    # before the packing dedup, so leaders match the reference;
                    # the signature column is a stride-0 view, not a fill
                    sig_col = sig_of_sj[i : i + 1].expand(rel.cap)
                    send = send & bloom_ops.probe_packed(
                        bloom_packed, keys, sig_col, bloom_bits, fp=fp
                    )
                if packing:
                    is_leader, rep = _dedup(spec, fp, keys, send)
                    rep_by_sj.append(rep)
                    send = is_leader
                else:
                    rep_by_sj.append(
                        torch.arange(rel.cap, dtype=torch.int32, device=dev)
                    )
                if skew is not None:
                    hot = _skew_hot_mask(spec, skew, info.sig_id, keys)
                    if hot is not None:
                        dest = _skew_req_dest(dest, hot, skew.R, P)
                rows = torch.arange(rel.cap, dtype=torch.int32, device=dev)
                src_col = torch.full((rel.cap,), sid, dtype=torch.int32, device=dev)
                msgs_list.append(_msg_stack(KIND_REQ, i, fp, keys, src_col, rows))
                valid_list.append(send)
                dest_list.append(dest)

            # Assert messages per signature; hot build rows are replicated
            # to all R sub-shards so every salted Req finds its build side
            # (the replicas are bitwise-identical messages — the probe is
            # an existence test, so duplicates cannot change any hit bit)
            for s_id, sig in enumerate(spec.sigs):
                rel = local_db[sig.rel]
                conf, keys, fp, dest = _map_source(spec, P, rel, sig.pattern, sig.keypos, s_id)
                send = conf
                if packing:
                    is_leader, _ = _dedup(spec, fp, keys, conf)
                    send = is_leader
                zeros = torch.zeros((rel.cap,), dtype=torch.int32, device=dev)
                msg = _msg_stack(KIND_ASSERT, s_id, fp, keys, zeros, zeros)
                msgs_list.append(msg)
                valid_list.append(send)
                dest_list.append(dest)
                if skew is not None:
                    hot = _skew_hot_mask(spec, skew, s_id, keys)
                    if hot is not None:
                        rep_valid = send & hot
                        for r in range(1, skew.R):
                            msgs_list.append(msg)
                            valid_list.append(rep_valid)
                            dest_list.append((dest + r) % P)
                        rep_count = rep_count + rep_valid.sum().to(torch.int32) * (
                            skew.R - 1
                        )

            msgs = torch.cat(msgs_list, 0)
            valid = torch.cat(valid_list, 0)
            dest = torch.cat(dest_list, 0)
            del msgs_list, valid_list, dest_list
            send_count = valid.sum().to(torch.int32)
            buf, bufvalid, ovf, _counts = shuffle.partition(msgs, valid, dest, P, cap_s)
            carry = (
                local_db, tuple(conf_by_sj), tuple(rep_by_sj),
                ovf, send_count, rep_count, bloom_packed,
            )
            return (buf, bufvalid), carry

        # ---------------- stage 2: probe + backward partition ----------------
        def stage_probe(sid, args):
            (recv, recv_valid), carry = args
            local_db, confs, reps, ovf_fwd, sent_fwd, rep_fwd, _bloom_packed = carry
            flat, flat_ok = shuffle.flatten_recv(recv, recv_valid)
            if fingerprint:
                kindtag = flat[:, 0]
                kind = kindtag & 1
                tag = kindtag >> 1
                fp = flat[:, 1]
                if spec.fp_exact:
                    keys = fp[:, None]
                else:
                    keys = flat[:, 2 : 2 + KW]
                if layout.row_mod:
                    srcrow = flat[:, W - 1]
                    src = srcrow // layout.row_mod
                    row = srcrow % layout.row_mod
                else:
                    src = flat[:, W - 2]
                    row = flat[:, W - 1]
            else:
                kind = flat[:, 0]
                tag = flat[:, 1]
                fp = None
                keys = flat[:, 2 : 2 + KW]
                src = flat[:, 2 + KW]
                row = flat[:, 3 + KW]
            is_build = flat_ok & (kind == KIND_ASSERT)
            is_probe = flat_ok & (kind == KIND_REQ)
            probe_sigs = sig_of_sj[torch.clamp(tag, 0, spec.n_sj - 1).long()]
            if pass_fp:
                hits = probe_fn(
                    tag, keys, is_build, probe_sigs, keys, is_probe,
                    build_fp=fp, probe_fp=fp,
                )
            else:
                hits = probe_fn(tag, keys, is_build, probe_sigs, keys, is_probe)
            back_valid = is_probe & hits
            back = torch.stack([row, tag], dim=1)
            bbuf, bbvalid, ovf_b, _ = shuffle.partition(back, back_valid, src, P, cap_s)
            recv_count = flat_ok.sum().to(torch.int32)
            hit_count = back_valid.sum().to(torch.int32)
            carry2 = (
                local_db, confs, reps, ovf_fwd, sent_fwd, rep_fwd,
                recv_count, hit_count,
            )
            return (bbuf, bbvalid), carry2

        # ---------------- stage 3: scatter + outputs ----------------
        def stage_out(sid, args):
            (recv, recv_valid), carry = args
            (local_db, confs, reps, ovf_fwd, sent_fwd, rep_fwd,
             recv_count, hit_count) = carry
            flat, flat_ok = shuffle.flatten_recv(recv, recv_valid)
            rows, sj_ids = flat[:, 0].long(), flat[:, 1]
            bits_by_sj = []
            for i, info in enumerate(spec.sj_info):
                gcap = local_db[info.guard_rel].cap
                sel = flat_ok & (sj_ids == i) & (rows >= 0) & (rows < gcap)
                # the reference's .at[rows].max(sel, mode="drop"): rows not
                # selected write to a spare slot past the end
                bm = torch.zeros((gcap + 1,), dtype=torch.bool, device=dev)
                bm.index_put_((torch.where(sel, rows, gcap),), sel)
                bm = bm[:gcap]
                # expand from packing leaders back to all rows of the key group
                bits = bm[reps[i].long()] & confs[i]
                bits_by_sj.append(bits)

            outputs = {}
            for i, (sj, info) in enumerate(zip(spec.sjs, spec.sj_info)):
                rel = local_db[info.guard_rel]
                proj = rel.data[:, list(info.out_pos)]
                outputs[sj.out] = Relation(sj.out, proj, bits_by_sj[i])
            for fq in fused:
                rel = local_db[fq.guard_rel]
                gconf = conform_mask(rel.data, rel.valid, fq.guard_pattern)
                leaf = {a: bits_by_sj[idx] for a, idx in fq.atom_to_sj.items()}
                ok = gconf & eval_cond(fq.cond, leaf) if fq.cond is not None else gconf
                proj = rel.data[:, list(fq.out_pos)]
                outputs[fq.name] = Relation(fq.name, proj, ok)

            stats = {
                "overflow": ovf_fwd,
                "sent_fwd": sent_fwd,
                "replicated": rep_fwd,
                "recv_fwd": recv_count,
                "hits": hit_count,
            }
            return None, (outputs, stats)

        self.stage_bloom = stage_bloom
        self.stage_map = stage_map
        self.stage_probe = stage_probe
        self.stage_out = stage_out


def _total(v) -> torch.Tensor:
    """Sum of a per-shard stat over the shard axis (int64: the
    reference's int32 totals at every size where those do not wrap)."""
    return v.sum(dtype=torch.int64)


def run_msj(
    db: dict[str, Relation],
    sjs: Sequence[SemiJoin],
    comm: Comm,
    *,
    packing: bool = True,
    fused: Sequence[FusedQuery] = (),
    probe_fn: Callable | None = None,
    forward_cap: int | None = None,
    bloom_bits: int = 0,
    fingerprint: bool = True,
    count_sized: bool = True,
    cap_slack: float = 1.0,
    tracer=None,
    skew: SkewRoute | None = None,
):
    """Evaluate MSJ(S). Returns ``(outputs, stats)``.

    ``outputs`` maps each equation's output name to a materialized
    :class:`Relation` (guard-row aligned), plus one relation per fused
    query. ``stats`` carries exact message counts / shuffled bytes /
    overflow counters for the cost model and the fault supervisor.

    ``probe_fn=None`` selects :func:`probe_sorted`; the executor resolves
    its ``probe_backend`` config (on the card: the bucketed CUDA kernel)
    before calling in.  ``count_sized`` enables the two-phase shuffle: the
    forward capacity is taken from an exchanged count vector instead of the
    worst-case bound (``forward_cap`` overrides both).  ``cap_slack < 1``
    deliberately undersizes the chosen capacity (memory saving; exact
    overflow detection + supervisor retry recover correctness).

    ``tracer`` (DESIGN.md §14) records the per-phase spans — ``msj.count``
    (count exchange), ``msj.bloom``, ``msj.shuffle.fwd`` (map + forward
    partition), ``msj.probe``, ``msj.scatter``; ``tracer=None`` (the
    default) runs the exact untraced path.

    ``skew`` (DESIGN.md §17) salts hot Req keys across R sub-shards and
    replicates the matching builds; exactness is unchanged (every Req
    reaches exactly one reducer, duplicate builds cannot flip an
    existence bit), so results are bit-identical with or without it.

    ``bloom_bits > 0`` adds the bloom prefilter stage (DESIGN.md §7): on
    the card its build and probe are the CUDA kernels of
    ``kernels/bloom``.  Outputs are the same with or without it; only
    ``sent_fwd``/``bytes_fwd`` (and what follows from them) can shrink.
    """
    spec = make_spec(sjs, fingerprint=fingerprint)
    if skew is not None:
        skew = skew.live(packing=packing, P=comm.P)
    traced = tracer is not None
    cap_s, counted = _sized_cap(
        spec, db, comm,
        packing=packing, forward_cap=forward_cap,
        count_sized=count_sized, cap_slack=cap_slack, tracer=tracer,
        skew=skew,
    )
    kit = _MSJKit(
        db, spec, comm, cap_s,
        packing=packing, fused=fused, probe_fn=probe_fn,
        bloom_bits=bloom_bits, fingerprint=fingerprint, skew=skew,
    )
    stages = ([kit.stage_bloom] if kit.use_bloom else []) + [
        kit.stage_map, kit.stage_probe, kit.stage_out,
    ]
    names = (["msj.bloom"] if kit.use_bloom else []) + [
        "msj.shuffle.fwd", "msj.probe", "msj.scatter",
    ]
    phase_spans = tracer.current() if traced else []
    base = len(phase_spans)
    outputs, stats = run_pipeline(comm, stages, kit.stacked, tracer=tracer, names=names)
    # aggregate stats over shards (the stacked run leaves a leading P axis)
    stats = {k: _total(v) for k, v in stats.items()}
    # the count phase ships one int32 per (src, dest) pair before the data
    # exchange; account for it so count-sizing can't hide traffic
    bytes_count = comm.P * comm.P * 4 if counted else 0
    stats["bytes_fwd"] = stats["sent_fwd"] * kit.W * 4 + bytes_count
    stats["bytes_bwd"] = stats["hits"] * 2 * 4
    stats["forward_cap"] = cap_s
    if traced:
        # annotate the just-recorded stage spans with the shuffled bytes:
        # the stats' own 0-d tensors, which the executor resolves to the
        # ints it reads for the job's stats (nothing is read back here)
        by_name = {sp.name: sp for sp in phase_spans[base:]}
        if "msj.shuffle.fwd" in by_name:
            by_name["msj.shuffle.fwd"].args["bytes"] = stats["bytes_fwd"]
        if "msj.scatter" in by_name:
            by_name["msj.scatter"].args["bytes"] = stats["bytes_bwd"]
        if "msj.probe" in by_name:
            by_name["msj.probe"].args["hits"] = stats["hits"]
    return outputs, stats


def run_msj_transfer(
    name: str,
    db: dict[str, Relation],
    sjs: Sequence[SemiJoin],
    comm: Comm,
    *,
    packing: bool = True,
    forward_cap: int | None = None,
    bloom_bits: int = 0,
    fingerprint: bool = True,
    count_sized: bool = True,
    cap_slack: float = 1.0,
    tracer=None,
    skew: SkewRoute | None = None,
):
    """Overlap-mode transfer half of one MSJ job (DESIGN.md §16): the
    count exchange plus map + forward ``all_to_all``, i.e. everything that
    puts bytes on the interconnect before the probe.  Returns
    ``(XferBuffer, stats)``; the buffer is published under ``name`` and
    consumed by :func:`run_msj_compute`.

    Stats carry the forward-side counters only (``overflow``, ``sent_fwd``,
    ``bytes_fwd``, ``forward_cap``); the compute half reports the rest, so
    per-report totals match the unsplit operator exactly.

    Traced runs record the forward exchange as an ``msj.xfer`` span (the
    comm-track phase name) rather than ``msj.shuffle.fwd``.

    ``skew`` (DESIGN.md §17): the salted/replicated routing lives entirely
    in this half — the compute half probes whatever landed, so a skew
    transfer pairs with an unmodified :func:`run_msj_compute`.
    """
    spec = make_spec(sjs, fingerprint=fingerprint)
    if skew is not None:
        skew = skew.live(packing=packing, P=comm.P)
    traced = tracer is not None
    cap_s, counted = _sized_cap(
        spec, db, comm,
        packing=packing, forward_cap=forward_cap,
        count_sized=count_sized, cap_slack=cap_slack, tracer=tracer,
        skew=skew,
    )
    kit = _MSJKit(
        db, spec, comm, cap_s,
        packing=packing, bloom_bits=bloom_bits, fingerprint=fingerprint,
        skew=skew,
    )
    phase_spans = tracer.current() if traced else []
    base = len(phase_spans)
    stages = ([kit.stage_bloom] if kit.use_bloom else []) + [kit.stage_map]
    names = (["msj.bloom"] if kit.use_bloom else []) + ["msj.xfer"]
    carry = run_pipeline(comm, stages, kit.stacked, tracer=tracer, names=names)
    # carry == ((recv, recv_valid), map_carry); the map carry holds the
    # per-shard forward overflow + send/replica-count scalars at fixed
    # positions
    (_, map_carry) = carry
    ovf_fwd, sent_fwd, rep_fwd = map_carry[3], map_carry[4], map_carry[5]
    stats = {
        "overflow": _total(ovf_fwd),
        "sent_fwd": _total(sent_fwd),
        "replicated": _total(rep_fwd),
    }
    bytes_count = comm.P * comm.P * 4 if counted else 0
    stats["bytes_fwd"] = stats["sent_fwd"] * kit.W * 4 + bytes_count
    stats["bytes_bwd"] = torch.zeros((), dtype=torch.int64)
    stats["forward_cap"] = cap_s
    if traced:
        by_name = {sp.name: sp for sp in phase_spans[base:]}
        if "msj.xfer" in by_name:
            by_name["msj.xfer"].args["bytes"] = stats["bytes_fwd"]
    buf = XferBuffer(
        name=name,
        sjs=tuple(sjs),
        data=carry,
        cap=cap_s,
        counted=counted,
        packing=packing,
        fingerprint=fingerprint,
        bloom_bits=bloom_bits,
    )
    return buf, stats


def run_msj_compute(
    db: dict[str, Relation],
    buf: XferBuffer,
    comm: Comm,
    *,
    fused: Sequence[FusedQuery] = (),
    probe_fn: Callable | None = None,
    tracer=None,
):
    """Overlap-mode compute half of one MSJ job: probe + route-back +
    scatter over an exchanged :class:`XferBuffer`.  Returns
    ``(outputs, stats)`` exactly like :func:`run_msj` minus the forward
    counters (those were reported by the transfer).

    The message spec/layout are rebuilt from the *buffer's* semi-joins —
    never from a (possibly narrowed) compute job — so the decode always
    matches the tags the transfer actually shuffled; the executor filters
    the outputs down to the compute node's write set."""
    spec = make_spec(list(buf.sjs), fingerprint=buf.fingerprint)
    traced = tracer is not None
    kit = _MSJKit(
        db, spec, comm, buf.cap,
        packing=buf.packing, fused=fused, probe_fn=probe_fn,
        bloom_bits=buf.bloom_bits, fingerprint=buf.fingerprint,
    )
    phase_spans = tracer.current() if traced else []
    base = len(phase_spans)
    outputs, stats = run_pipeline(
        comm, [kit.stage_probe, kit.stage_out], buf.data,
        tracer=tracer, names=["msj.probe", "msj.scatter"],
    )
    stats = {k: _total(v) for k, v in stats.items()}
    # forward-side counters were accounted by the transfer node; zero them
    # here so Report totals (bytes, overflow, replication) don't
    # double-count
    zero = torch.zeros((), dtype=torch.int64)
    stats["overflow"] = zero
    stats["sent_fwd"] = zero
    stats["replicated"] = zero
    stats["bytes_fwd"] = zero
    stats["bytes_bwd"] = stats["hits"] * 2 * 4
    stats["forward_cap"] = buf.cap
    if traced:
        by_name = {sp.name: sp for sp in phase_spans[base:]}
        if "msj.scatter" in by_name:
            by_name["msj.scatter"].args["bytes"] = stats["bytes_bwd"]
        if "msj.probe" in by_name:
            by_name["msj.probe"].args["hits"] = stats["hits"]
    return outputs, stats
