"""The MapReduce I/O cost model of Section 3.3, with the paper's refinement.

The model prices one job as

    cost_h + Σ_i cost_map(N_i, M_i) + cost_red(M, K)

where the *refinement over Wang & Chan* (``cost_gumbo`` vs ``cost_wang``) is
that the map-side sort/merge term is computed **per input partition**
(Eq. 2) rather than on the aggregated map output (Eq. 3).  The two models
disagree exactly when input relations have non-proportional map output
ratios (e.g. a constant-filtered conditional atom next to a fan-out guard).

Two constant presets are provided:

* ``HADOOP`` — the paper's Table 5 (cost units per MB on the VSC cluster).
* ``TPU_V5E`` — the same *structure* re-priced for one TPU v5e chip:
  hdfs read/write ↦ HBM traffic at 819 GB/s, transfer ↦ ICI at ~50 GB/s
  per link, local sort/merge ↦ on-chip passes over VMEM-resident buffers,
  job overhead ↦ dispatch latency of a jitted program.  Units are seconds
  per MB.  The *relative* trade-offs the planner reasons about (scan
  sharing vs. merge amplification) survive the re-pricing; absolute values
  are reported in EXPERIMENTS.md.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Mapping, Sequence

from repro_torch.core.algebra import SemiJoin

BYTES_PER_CELL = 4  # engine values are int32
MB = 1e6


@dataclass(frozen=True)
class CostConstants:
    l_r: float  # local disk (TPU: on-chip) read cost per MB
    l_w: float  # local disk write cost per MB
    h_r: float  # hdfs (TPU: HBM) read cost per MB
    h_w: float  # hdfs write cost per MB
    t: float  # transfer (TPU: ICI) cost per MB
    D: int  # external sort merge factor
    buf_map: float  # map task buffer limit (MB)
    buf_red: float  # reduce task buffer limit (MB)
    cost_h: float  # per-job startup overhead
    split_mb: float  # input split per mapper (Hadoop: 128MB)
    red_mb: float  # intermediate data per reducer (Gumbo: 256MB)
    meta_bytes: int = 16  # per-record map output metadata (Hadoop)


#: Paper Table 5 (cost units per MB).
HADOOP = CostConstants(
    l_r=0.03,
    l_w=0.085,
    h_r=0.15,
    h_w=0.25,
    t=0.017,
    D=10,
    buf_map=409.0,
    buf_red=512.0,
    cost_h=10.0,
    split_mb=128.0,
    red_mb=256.0,
)

#: TPU v5e re-pricing, seconds per MB.
#: HBM 819 GB/s -> 1/819e3 s/MB; ICI ~50 GB/s/link -> 1/50e3 s/MB;
#: on-chip merge pass ~ 1 TB/s effective -> 1e-6 s/MB; dispatch ~ 100 us.
#: buffers: VMEM-resident sort buffer ~ 64 MB of HBM staging per core.
TPU_V5E = CostConstants(
    l_r=1.0e-6,
    l_w=1.0e-6,
    h_r=1.0 / 819e3,
    h_w=1.0 / 819e3,
    t=1.0 / 50e3,
    D=8,
    buf_map=64.0,
    buf_red=64.0,
    cost_h=100e-6,
    split_mb=256.0,
    red_mb=256.0,
)


def _merge_passes(m_mb: float, meta_mb: float, workers: int, buf: float, D: int) -> float:
    """log_D ⌈((M + M̂)/m) / buf⌉, clamped to ≥ 0 (no spill → no merge)."""
    if m_mb <= 0:
        return 0.0
    spill = math.ceil(max(1.0, (m_mb + meta_mb) / max(workers, 1) / buf))
    return max(0.0, math.log(spill, D))


def cost_map(n_mb: float, m_mb: float, c: CostConstants, *, records: float = 0.0) -> float:
    """Map-phase cost on one uniform input partition (Eq. cost_map)."""
    meta_mb = records * c.meta_bytes / MB
    mappers = max(1, math.ceil(n_mb / c.split_mb))
    merge = (c.l_r + c.l_w) * m_mb * _merge_passes(m_mb, meta_mb, mappers, c.buf_map, c.D)
    return c.h_r * n_mb + merge + c.l_w * m_mb


def cost_red(m_mb: float, k_mb: float, c: CostConstants) -> float:
    """Reduce-phase cost (Eq. cost_red)."""
    reducers = max(1, math.ceil(m_mb / c.red_mb))
    merge = (c.l_r + c.l_w) * m_mb * _merge_passes(m_mb, 0.0, reducers, c.buf_red, c.D)
    return c.t * m_mb + merge + c.h_w * k_mb


def map_phase_cost(
    parts: Sequence[tuple[float, float, float]],
    c: CostConstants,
    *,
    model: str = "gumbo",
) -> float:
    """Total map cost over input partitions ``(N_mb, M_mb, records)``.

    ``model='gumbo'`` prices each partition separately (Eq. 2);
    ``model='wang'`` prices the aggregate (Eq. 3) — the paper's ablation.
    """
    if model == "gumbo":
        return sum(cost_map(n, m, c, records=r) for n, m, r in parts)
    if model == "wang":
        n = sum(p[0] for p in parts)
        m = sum(p[1] for p in parts)
        r = sum(p[2] for p in parts)
        return cost_map(n, m, c, records=r)
    raise ValueError(model)


def lpt_makespan(costs: Sequence[float], slots: int | None = None) -> float:
    """Makespan of jobs with the given costs on ``slots`` identical machines
    under longest-processing-time-first list scheduling.

    This is the slot-aware net-time primitive: a round whose jobs exceed the
    cluster's W concurrent slots cannot finish in ``max(costs)`` wall time.
    ``slots=None`` (or ≥ len(costs)) models unbounded slots and returns the
    plain maximum — exactly the paper's net-time term for one round.
    """
    costs = [float(c) for c in costs]
    if not costs:
        return 0.0
    if slots is None or math.isinf(slots) or slots >= len(costs):
        return max(costs)
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    loads = [0.0] * int(slots)
    for c in sorted(costs, reverse=True):
        i = min(range(len(loads)), key=loads.__getitem__)
        loads[i] += c
    return max(loads)


# --------------------------------------------------------------------------
# Speculative re-dispatch deadline (DESIGN.md §12)
# --------------------------------------------------------------------------

#: default multiple of a job's *own* modeled wall after which a dispatched
#: attempt counts as a straggler.  Scaling by the job's modeled cost (not a
#: round median) means the modeled-longest job is expected to be long and
#: is never flagged merely for being the longest.
SPEC_FACTOR = 2.5


def speculation_deadline(
    est_cost: float,
    *,
    scale: float | None,
    factor: float = SPEC_FACTOR,
    slots: int | None = None,
    floor: float = 0.0,
) -> float:
    """Wall-clock deadline (seconds) after which a dispatched job should be
    speculatively cloned onto a free slot (first completion wins).

    ``est_cost`` is the job's admission-time modeled cost (cost-model
    units); ``scale`` calibrates model units to observed wall seconds
    (the executor maintains it online as the median wall/cost ratio of
    completed attempts — robust to one inflated wall).  The deadline is
    ``factor × est_cost × scale``, so it is *monotone in the modeled job
    cost*: an expensive job
    earns a proportionally longer leash and the modeled-longest job is
    never flagged just for running longest.

    Returns ``inf`` (never fires) when speculation cannot help or cannot
    be priced: a single cluster slot (``slots == 1`` — the clone would
    queue behind the original, and with W=1 the modeled-longest job in
    particular must never be re-dispatched), no calibration yet
    (``scale`` is ``None`` or non-positive), or a job without a modeled
    cost (``est_cost <= 0`` — no statistics, no deadline).
    """
    if slots is not None and slots <= 1:
        return math.inf
    if scale is None or scale <= 0.0 or est_cost <= 0.0:
        return math.inf
    return max(factor * float(est_cost) * float(scale), float(floor))


# --------------------------------------------------------------------------
# Per-job probe-backend choice (how ExecutorConfig.probe_backend="auto"
# resolves — one decision per dequeued job, so a fused multi-tenant plan
# can mix backends across its jobs)
# --------------------------------------------------------------------------

#: modeled per-element weight of one argsort pass relative to one
#: vectorized compare: sorts carry a large constant factor, so the
#: quadratic dense probe wins at trivial sizes despite its asymptotics.
SORT_WEIGHT = 16.0

#: the dense probe materializes a (probe × build) compare matrix; cap the
#: per-side rows so its quadratic memory stays bounded even when the
#: modeled compare count looks cheap (e.g. 16 probes against 10^9 builds).
DENSE_MAX_SIDE = 4096.0

#: the CUDA hash join (``kernels/msj_probe/csrc/probe_hash.cu``), in the
#: units of the sort-merge model: the weight per key word of each build row
#: inserted into the table and each probe row looked up.  The card's
#: kernel / sort-merge time ratio (0.122 at a 2**14-row shard, 0.107 at
#: the main path's 15,120,032-row shard, KW = 1) implies 29.28 and 42.52:
#: the ratio hardly moves while the sort-merge model's cost per row grows
#: with log n.  This is their geometric mean, the least-squares fit of the
#: log cost (``chip_smoke.py`` ``costmodel`` line, NVIDIA H100 80GB HBM3
#: at 700 W; PERF.md §6).
KERNEL_ROW_WEIGHT = 35.28


def cost_dense(b: float, p: float, kw: int) -> float:
    return b * p * (kw + 1)


def cost_sorted(b: float, p: float, kw: int) -> float:
    n = b + p
    return SORT_WEIGHT * (kw + 1) * n * math.log2(max(n, 2.0))


def cost_kernel(b: float, p: float, kw: int) -> float:
    """Linear: one table build pass over the build rows and one lookup
    pass over the probe rows, with no sort."""
    return KERNEL_ROW_WEIGHT * (kw + 1) * (b + p)


def choose_backend(
    build_rows: float | None,
    probe_rows: float | None,
    key_width: int = 1,
    *,
    on_cuda: bool | None = None,
) -> str:
    """Pick the probe backend for ONE MSJ job from its relation statistics.

    Models the reducer work of the three backends (unit: one int32 column
    op over per-shard probe inputs):

    * ``dense``  — quadratic all-pairs compare (:func:`cost_dense`); no
      sort overhead, so it is cheapest at trivial sizes, and only taken
      with at most ``DENSE_MAX_SIDE`` rows a side.
    * ``sorted`` — torch sort-merge over (sig, key): ``key_width + 1``
      stable argsort passes (:func:`cost_sorted`), the robust default.
    * ``kernel`` — the CUDA hash join (:func:`cost_kernel`): a table build
      over the build side and a lookup per probe row, linear in both.
      ``on_cuda`` says whether the job's relations live on a CUDA device;
      off CUDA the wrapper runs its plain torch version, which has no edge
      over ``sorted``, so the kernel is never chosen there (``None`` counts
      as off CUDA).

    ``build_rows`` / ``probe_rows`` of ``None`` mean "unknown, assume
    large"; with no statistics the choice degenerates to the kernel on
    CUDA and sorted elsewhere.  Never returns ``"auto"``.
    """
    big = 1e9
    b = max(float(build_rows) if build_rows is not None else big, 1.0)
    p = max(float(probe_rows) if probe_rows is not None else big, 1.0)
    kw = max(int(key_width), 1)
    best, name = cost_sorted(b, p, kw), "sorted"
    if on_cuda and cost_kernel(b, p, kw) < best:
        best, name = cost_kernel(b, p, kw), "kernel"
    if cost_dense(b, p, kw) < best and b <= DENSE_MAX_SIDE and p <= DENSE_MAX_SIDE:
        best, name = cost_dense(b, p, kw), "dense"
    return name


# --------------------------------------------------------------------------
# Relation statistics
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RelStats:
    rows: float
    arity: int
    #: bounded top-k heavy-hitter evidence: ``((col, value, count), ...)``
    #: from the shuffle sketch (engine/shuffle.py::topk_fp_counts), empty
    #: when hitters were not collected.  Counts are per-value row counts
    #: over the whole relation; ``col`` is the column index the value
    #: appears in.  The skew planner (annotate_skew / choose_skew) reads
    #: only the columns that are join-key positions.
    heavy_hitters: tuple = ()

    @property
    def mb(self) -> float:
        return self.rows * self.arity * BYTES_PER_CELL / MB

    def hitters_for(self, col: int) -> tuple:
        """``((value, count), ...)`` for one column, count descending."""
        return tuple((v, n) for cc, v, n in self.heavy_hitters if cc == col)


class Stats:
    """Size statistics + selectivity estimates backing the planner.

    ``sel[(guard_rel, cond_rel)]`` estimates the fraction of guard facts
    surviving the semi-join (default 0.5, the paper's data generator
    midpoint); Gumbo obtains these by simulating the map on a sample —
    :func:`sample_stats` below does the analogue.
    """

    def __init__(
        self,
        rels: Mapping[str, RelStats],
        sel: Mapping[tuple, float] | None = None,
        default_sel: float = 0.5,
    ):
        self.rels = dict(rels)
        self.sel = dict(sel or {})
        self.default_sel = default_sel

    def rel(self, name: str) -> RelStats:
        return self.rels[name]

    def selectivity(self, sj: SemiJoin) -> float:
        return self.sel.get((sj.guard.rel, sj.cond_atom.rel), self.default_sel)

    def out_rows(self, sj: SemiJoin) -> float:
        return self.rels[sj.guard.rel].rows * self.selectivity(sj)

    def register_output(self, name: str, rows: float, arity: int) -> None:
        self.rels[name] = RelStats(rows=rows, arity=arity)


def stats_of_db(db, sel=None, default_sel: float = 0.5, *,
                heavy_hitters: int = 0) -> Stats:
    """Exact row counts from a materialized database.

    ``heavy_hitters=k > 0`` additionally runs the bounded top-k sketch
    (engine/shuffle.py) over every column of every relation and surfaces
    the merged per-value counts as ``RelStats.heavy_hitters`` — the
    evidence :func:`choose_skew` prices the skew defense from.
    """
    hh_of = _heavy_hitters_of if heavy_hitters > 0 else (lambda r, k: ())
    rels = {
        name: RelStats(
            rows=float(r.count()),
            arity=r.arity,
            heavy_hitters=hh_of(r, heavy_hitters),
        )
        for name, r in db.items()
    }
    return Stats(rels, sel, default_sel)


def _heavy_hitters_of(r, k: int) -> tuple:
    """Per-column merged top-k of one sharded relation via the shuffle
    sketch: the per-shard sketch over each of the P leading-axis shards,
    merged on host.  Exactly the map-side pass the SkewProfileJob runs at
    execution time, so plan-time and run-time hotness agree."""
    import torch

    from repro_torch.engine import shuffle as _shuffle

    out = []
    for col in range(r.arity):
        per_shard = [
            _shuffle.topk_fp_counts(r.data[p, :, col], r.valid[p], k)
            for p in range(r.P)
        ]
        vals = torch.stack([v for v, _ in per_shard])
        counts = torch.stack([c for _, c in per_shard])
        for value, count in _shuffle.merge_topk(vals, counts, k):
            out.append((col, value, count))
    return tuple(out)


def sample_stats(db, sjs: Sequence[SemiJoin], *, sample: int = 1024) -> Stats:
    """Sampling-based selectivity estimation (Gumbo §5.1 optimization (3)).

    Simulates the map on ≤``sample`` guard rows per semi-join: the fraction
    of sampled guard keys present in the conditional atom's key set.
    """
    import numpy as np

    from repro_torch.core.msj import conform_mask

    stats = stats_of_db(db)
    for sj in sjs:
        g = db[sj.guard.rel]
        k = db[sj.cond_atom.rel]
        gkeypos = [sj.guard.positions_of(v)[0] for v in sj.key_vars]
        kkeypos = [sj.cond_atom.positions_of(v)[0] for v in sj.key_vars]
        gdata = g.data.reshape(-1, g.arity).cpu().numpy()
        gvalid = g.valid.reshape(-1).cpu().numpy()
        kdata = k.data.reshape(-1, k.arity).cpu().numpy()
        kconf = (
            conform_mask(
                k.data.reshape(-1, k.arity),
                k.valid.reshape(-1),
                sj.cond_atom.conform_pattern(),
            )
            .cpu()
            .numpy()
        )
        gkeys = gdata[gvalid][:, gkeypos]
        if len(gkeys) > sample:
            idx = np.random.default_rng(0).choice(len(gkeys), sample, replace=False)
            gkeys = gkeys[idx]
        kkeys = {tuple(r) for r in kdata[kconf][:, kkeypos]}
        frac = (
            float(np.mean([tuple(r) in kkeys for r in gkeys])) if len(gkeys) else 0.0
        )
        stats.sel[(sj.guard.rel, sj.cond_atom.rel)] = frac
    return stats


# --------------------------------------------------------------------------
# Skew defense (DESIGN.md §17): heavy-hitter splitting with replication
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SkewDefense:
    """Plan-time skew annotation for one MSJ job.

    ``R`` is the replication factor: a hot probe (Req) key is salted
    across R consecutive reducers while every matching build (Assert) row
    is replicated to all R — the theta-join skew lever of Afrati/Ullman's
    *Efficient Multi-way Theta-Join Processing* with the replication-rate
    vs reducer-size tradeoff from *Upper and Lower Bounds on the Cost of
    a Map-Reduce Computation* (both PAPERS.md; derivation in DESIGN.md
    §17).  ``threshold`` is the run-time per-key count above which the
    profile pass declares a key hot; ``hot`` carries the plan-time
    ``((value, count), ...)`` evidence the decision was made from (it
    pins plan-cache keys; the executed hot set comes from the profile
    pass, not from here).
    """

    R: int
    threshold: int
    hot: tuple = ()


#: a key is "hot" when its per-reducer load exceeds this multiple of the
#: fair share rows/P — below it, the count-sized forward caps absorb the
#: imbalance without splitting
SKEW_FACTOR = 2.0


def choose_skew(
    probe_rows: float,
    build_rows: float,
    probe_hitters: Sequence[tuple],
    P: int,
    *,
    build_hitters: Sequence[tuple] = (),
    packing: bool = True,
    skew_factor: float = SKEW_FACTOR,
) -> SkewDefense | None:
    """Replication-vs-overflow tradeoff for one MSJ job (DESIGN.md §17).

    Returns ``None`` when splitting cannot pay:

    * fewer than 2 shards, or no per-key count exceeds
      ``skew_factor × probe_rows/P`` (the fair share) — the count-sized
      caps already absorb it;
    * ``packing=True`` — leader dedup bounds any key's forward load to
      ≤ 1 message per map shard, so effective hot counts clamp to P and
      almost never cross the fair-share bar;
    * the replicated build bytes exceed the forward bytes the split
      removes from the hottest bucket (the Afrati/Ullman bound: total
      replicated communication (R−1)·Σ_hot b̂(k) must stay under the
      straggler mass hot_max·(1−1/R) it dissolves).

    Otherwise R levels the hottest key's residual into the forward
    buffers.  ``R_level = ceil(hot_max / fair)`` brings the residual down
    to the *mean* bucket — but the forward buffers are per-(src, dest),
    and the salted residual lands on buckets that already hold their base
    load, so the max bucket still overshoots by up to the residual
    itself.  The preferred choice is therefore the aggressive
    ``2 × R_level`` (residual ≈ half the fair share, disappearing into
    bucket variance); when the replication guard rejects the doubled
    factor the minimal ``R_level`` is tried before giving up.  Per-hot-key
    build multiplicity ``b̂`` is read from ``build_hitters`` when the
    build side has its own sketch evidence, else floored at 1 row per hot
    key (a semi-join build needs only one matching row to assert
    membership).
    """
    P = int(P)
    if P < 2 or probe_rows <= 0 or not probe_hitters:
        return None
    fair = float(probe_rows) / P
    # packing dedups to ≤1 leader per key per map shard -> ≤P forwards/key
    eff = tuple(
        (v, min(int(n), P) if packing else int(n)) for v, n in probe_hitters
    )
    bar = skew_factor * fair
    hot = tuple((v, n) for v, n in eff if n > bar)
    if not hot:
        return None
    hot_max = max(n for _, n in hot)
    R_level = max(2, min(P, math.ceil(hot_max / max(fair, 1.0))))
    build_by_val = {v: n for v, n in build_hitters}
    b_hot = sum(max(build_by_val.get(v, 0), 1) for v, _ in hot)
    threshold = max(1, math.ceil(bar))
    for R in dict.fromkeys((min(P, 2 * R_level), R_level)):
        saved_rows = hot_max * (1.0 - 1.0 / R)
        extra_rows = (R - 1) * float(b_hot)
        if extra_rows < saved_rows:
            return SkewDefense(R=R, threshold=threshold, hot=hot)
    return None


# --------------------------------------------------------------------------
# Job costing (Eqs. 5–7)
# --------------------------------------------------------------------------


def _msj_parts(
    sjs: Sequence[SemiJoin],
    stats: Stats,
    *,
    packing: bool = True,
    fingerprint: bool = True,
    skew: "SkewDefense | None" = None,
) -> tuple[list[tuple[float, float, float]], float, float]:
    """Shared sizing of one MSJ job: map input partitions ``(N, M, records)``,
    total intermediate MB, and output MB (the inputs to Eqs. 5–7).

    With a ``skew`` annotation, each Assert partition carries the
    replicated-build mass: ``(R−1)`` extra copies of the build rows
    matching the hot keys (floored at one row per hot key)."""
    from repro_torch.core.msj import make_spec

    spec = make_spec(list(sjs), fingerprint=fingerprint)
    msg_mb_per_row = spec.msg_width * BYTES_PER_CELL / MB
    # replicated-build mass: (R−1) copies of ~1 build row per hot key
    # (skew.hot carries PROBE counts — build multiplicity is what gets
    # replicated, floored at one matching row per hot key)
    rep_rows = 0.0
    if skew is not None and skew.R > 1:
        rep_rows = float((skew.R - 1) * max(len(skew.hot), 1))

    parts: list[tuple[float, float, float]] = []
    # one partition per distinct guard relation
    by_guard: dict[str, int] = {}
    for info in spec.sj_info:
        by_guard[info.guard_rel] = by_guard.get(info.guard_rel, 0) + 1
    for rel, n_req in by_guard.items():
        rs = stats.rel(rel)
        if packing:
            m = rs.rows * n_req * msg_mb_per_row
        else:
            m = rs.rows * n_req * max(msg_mb_per_row, rs.mb / max(rs.rows, 1))
        parts.append((rs.mb, m, rs.rows * n_req))
    # one partition per distinct Assert signature; replication is priced
    # as extra emitted rows, clamped so a wildly-hot annotation cannot
    # claim more replicas than the build actually has rows to copy
    for sig in spec.sigs:
        rs = stats.rel(sig.rel)
        extra = min(rep_rows, rs.rows * max(skew.R - 1, 0)) if skew else 0.0
        rows = rs.rows + extra
        parts.append((rs.mb, rows * msg_mb_per_row, rows))

    m_total = sum(p[1] for p in parts)
    k_mb = sum(
        stats.out_rows(sj) * len(sj.out_vars) * BYTES_PER_CELL / MB for sj in sjs
    )
    return parts, m_total, k_mb


def msj_job_cost(
    sjs: Sequence[SemiJoin],
    stats: Stats,
    c: CostConstants = HADOOP,
    *,
    model: str = "gumbo",
    packing: bool = True,
    fingerprint: bool = True,
    skew: "SkewDefense | None" = None,
) -> float:
    """Cost of evaluating the set S in ONE MSJ job (Eq. 5, generalized).

    Guard relations are scanned once each and emit one Req per semi-join
    they guard; distinct Assert *signatures* are emitted once (conditional
    name sharing).  With ``packing``, messages carry (key, tuple-id) rather
    than the tuple (Gumbo optimizations (1)+(2)); the modeled Req/Assert
    record width follows the engine's message layout: the fingerprint
    layout (DESIGN.md §5 — kindtag + fp + wide keys + packed srcrow) by
    default, or the seed ``key_width + 4`` layout with
    ``fingerprint=False``.  The count phase of the two-phase shuffle ships
    one int32 per shard pair and is priced into the per-job overhead
    ``cost_h`` (it is orders of magnitude below the data exchange).
    """
    parts, m_total, k_mb = _msj_parts(
        sjs, stats, packing=packing, fingerprint=fingerprint, skew=skew
    )
    return c.cost_h + map_phase_cost(parts, c, model=model) + cost_red(m_total, k_mb, c)


def msj_transfer_cost(
    sjs: Sequence[SemiJoin],
    stats: Stats,
    c: CostConstants = HADOOP,
    *,
    model: str = "gumbo",
    packing: bool = True,
    fingerprint: bool = True,
    skew: "SkewDefense | None" = None,
) -> float:
    """Cost of an overlap-mode **transfer** sub-node (DESIGN.md §16): the
    map scan/emit/merge plus the network term ``t·M`` of ``cost_red`` —
    everything up to and including the forward ``all_to_all``.  The split
    keys the same Eq. 5 sizing as :func:`msj_job_cost`, so
    ``transfer + compute == msj_job_cost + cost_h`` (each sub-node is its
    own dispatch and pays its own startup overhead).  A skew-split
    transfer additionally carries the replicated-build mass in its map
    and network terms (the replicas travel in the forward exchange)."""
    parts, m_total, _ = _msj_parts(
        sjs, stats, packing=packing, fingerprint=fingerprint, skew=skew
    )
    return c.cost_h + map_phase_cost(parts, c, model=model) + c.t * m_total


def msj_compute_cost(
    sjs: Sequence[SemiJoin],
    stats: Stats,
    c: CostConstants = HADOOP,
    *,
    model: str = "gumbo",
    packing: bool = True,
    fingerprint: bool = True,
    skew: "SkewDefense | None" = None,
) -> float:
    """Cost of an overlap-mode **compute** sub-node: the reduce-side merge,
    probe and output write of ``cost_red`` — everything after the forward
    exchange landed (the ``t·M`` term belongs to the transfer)."""
    _, m_total, k_mb = _msj_parts(
        sjs, stats, packing=packing, fingerprint=fingerprint, skew=skew
    )
    return c.cost_h + cost_red(m_total, k_mb, c) - c.t * m_total


def msj_profile_cost(
    sjs: Sequence[SemiJoin],
    stats: Stats,
    c: CostConstants = HADOOP,
    *,
    fingerprint: bool = True,
) -> float:
    """Cost of a skew **profile** sub-node (DESIGN.md §17): one map-side
    scan of each guard relation to run the heavy-hitter sketch — no
    shuffle, no reduce, host-side top-k merge folded into ``cost_h``."""
    from repro_torch.core.msj import make_spec

    spec = make_spec(list(sjs), fingerprint=fingerprint)
    guards = {info.guard_rel for info in spec.sj_info}
    return c.cost_h + sum(c.h_r * stats.rel(rel).mb for rel in guards)


def eval_job_cost(
    input_sizes: Sequence[RelStats],
    out_mb: float,
    c: CostConstants = HADOOP,
    *,
    model: str = "gumbo",
) -> float:
    """Cost of one EVAL job over X_0..X_n (Eq. 7)."""
    parts = [(rs.mb, rs.mb, rs.rows) for rs in input_sizes]
    m_total = sum(p[1] for p in parts)
    return c.cost_h + map_phase_cost(parts, c, model=model) + cost_red(m_total, out_mb, c)
