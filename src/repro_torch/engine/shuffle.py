"""Radix partition for the shuffle phase + the heavy-hitter sketch.

``partition`` turns a shard-local message buffer into a ``(P, cap, W)``
send buffer addressed by destination shard, with exact overflow accounting.
The exchange itself (``all_to_all``) is performed by the comm runner.

``topk_fp_counts`` / ``merge_topk`` are the bounded top-k sketch behind
the skew defense (DESIGN.md §17): per-shard value counts are exact (one
stable sort + run-length encoding, the same primitive the packing dedup
uses), and only the *merge* across shards is bounded to k entries — a
value missing from every shard's local top-k cannot surface globally,
which is the sketch's only error mode.

Writes that the reference drops as out of range (``mode="drop"``) are
routed here to one spare slot past the end of a flat buffer and cut off
afterwards: a masked ``index_put_`` with no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.engine.hashing import MASK32, u32


def partition(
    msgs: torch.Tensor,  # (N, W) int32
    valid: torch.Tensor,  # (N,) bool
    dest: torch.Tensor,  # (N,) int32 in [0, P)
    P: int,
    cap: int,
):
    """Route messages into per-destination buckets.

    Returns ``(buf (P, cap, W) int32, bufvalid (P, cap) bool,
    overflow (scalar int32), counts (P,) int32)``.

    Deterministic: a stable sort by destination preserves source order
    within each bucket (reproducible runs — required for checkpoint/restart
    equivalence tests).
    """
    N, W = msgs.shape
    dev = msgs.device
    d = torch.where(valid, dest.to(torch.int64), P)  # invalid -> sentinel bucket
    order = torch.argsort(d, stable=True)
    d_s = d[order]
    msgs_s = msgs[order]
    counts = torch.bincount(d_s, minlength=P + 1)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N, dtype=torch.int64, device=dev) - offsets[d_s]
    inrange = (d_s < P) & (pos < cap)
    slot = torch.where(inrange, d_s * cap + pos, P * cap)  # spare slot = drop
    buf = torch.zeros((P * cap + 1, W), dtype=torch.int32, device=dev)
    buf.index_put_((slot,), msgs_s.to(torch.int32))
    bufvalid = torch.zeros((P * cap + 1,), dtype=torch.bool, device=dev)
    bufvalid.index_put_((slot,), inrange)
    overflow = torch.clamp(counts[:P] - cap, min=0).sum().to(torch.int32)
    return (
        buf[: P * cap].reshape(P, cap, W),
        bufvalid[: P * cap].reshape(P, cap),
        overflow,
        counts[:P].to(torch.int32),
    )


def flatten_recv(buf: torch.Tensor, bufvalid: torch.Tensor):
    """(P, cap, W) received buckets -> (P*cap, W) flat rows + validity."""
    P, cap, W = buf.shape
    return buf.reshape(P * cap, W), bufvalid.reshape(P * cap)


def topk_fp_counts(vals: torch.Tensor, valid: torch.Tensor, k: int):
    """Per-shard top-k value counts: ``(N,) int32 values, (N,) bool`` ->
    ``((k,) int32 values, (k,) int32 counts)``, counts descending.

    Counts are exact within the shard (sort + run-length encode); only
    the k-truncation loses information.  Slots past the number of
    distinct valid values carry count 0 — callers must treat count-0
    entries as absent rather than as "value 0 seen zero times".
    """
    n = int(vals.shape[0])
    k = max(1, min(int(k), n))
    dev = vals.device
    # invalid rows sort to the end (uint32 max sentinel); a *valid* row
    # that happens to hold 0xFFFFFFFF still counts correctly because run
    # boundaries also break on validity, and leads are masked to valid
    sortkey = torch.where(valid, u32(vals), MASK32)
    order = torch.argsort(sortkey, stable=True)
    v_s = vals[order]
    ok_s = valid[order]
    lead = torch.ones((n,), dtype=torch.bool, device=dev)
    if n > 1:
        lead[1:] = (v_s[1:] != v_s[:-1]) | ~ok_s[:-1]
    lead = lead & ok_s
    run = torch.cumsum(lead.to(torch.int64), 0) - 1  # run id per sorted row
    ridx = torch.where(ok_s, run, n)  # invalid rows -> dropped
    counts = torch.bincount(ridx, minlength=n + 1)[:n].to(torch.int32)
    rvals = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    rvals.index_put_((torch.where(lead, run, n),), v_s.to(torch.int32))
    rvals = rvals[:n]
    top = torch.argsort(-counts, stable=True)[:k]
    return rvals[top], counts[top]


def merge_topk(vals, counts, k: int):
    """Host-side merge of per-shard sketches into one global top-k.

    ``vals``/``counts`` are ``(P, k)`` (or any leading shape) tensors from
    :func:`topk_fp_counts`.  Returns ``((value, count), ...)`` sorted by
    count descending then value, at most ``k`` entries, count-0 slots
    dropped.  A value absent from *every* shard's local top-k cannot
    appear — that is the sketch's only recall loss, bounded by the
    per-shard k.
    """
    v = torch.as_tensor(vals).reshape(-1).cpu().tolist()
    c = torch.as_tensor(counts).reshape(-1).cpu().tolist()
    totals: dict[int, int] = {}
    for value, count in zip(v, c):
        if count > 0:
            totals[int(value)] = totals.get(int(value), 0) + int(count)
    ranked = sorted(totals.items(), key=lambda vc: (-vc[1], vc[0]))
    return tuple(ranked[: max(0, int(k))])
