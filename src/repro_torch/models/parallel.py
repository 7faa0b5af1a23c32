"""Sharded compute on a device mesh: ZeRO-3 gathers one layer at a time,
and tensor parallelism over ``model``.

The reference hands its ``partition_specs`` to ``jax.jit`` and XLA
partitions the step: each chip holds its shards and computes its part.
The port does that by hand.  A model module whose parameters are DTensors
(placed by ``model.partition_specs``) computes inside a :class:`Shards`
context (:func:`sharded`), which the sharded train step
(``train.train_step``) and sharded serving (``model._sharded_serve``)
open:

* **Per-layer gathers.**  Every family's forward takes its parameters
  through :func:`layer` (one layer, or the hybrid's shared block, at a
  time, inside the body that ``transformer.remat`` wraps) and
  :func:`param` (``embed``, ``lm_head``, the final norms, where they are
  used).  Each is gathered over the FSDP axes (every mesh axis but
  ``model``) with the list form of ``all_gather`` (``launch.mesh``) and
  dropped when the body returns; a checkpoint's recompute gathers again.
  Under autograd the gather is :class:`_Gather`, whose backward
  reduce-scatters the gradient into the parameter's placement as soon as
  autograd produces it (an all-reduce where the parameter is replicated
  over a batch axis); the gradients accumulate in the local shards
  (:meth:`Shards.track`).
* **Over ``model``** a parameter is either kept as the rank's shard
  (``"local"``: tensor-parallel compute; its gradient is the shard's
  own), or gathered too, and its gradient is then a partial sum over the
  ``model`` ranks (``"sum"``: each rank computed only its part with it)
  or the same on every rank (``"same"``: a computation every rank repeats;
  the rank keeps its slice).
* **Tensor parallelism** (``Shards.tp``, when ``model`` has more than one
  rank): :func:`enter` (identity forward, all-reduce of the gradient),
  :func:`reduce` (all-reduce of partial sums, identity backward),
  :func:`gather_last` (all-gather of column blocks, reduce-scatter
  backward) and :func:`scatter_last` (its inverse), :func:`part_last`
  (the rank's block), :func:`take_cols` and :func:`reshard` (one
  ``all_to_all_single`` that re-lays a shard, the inverse exchange
  backward), the vocabulary-parallel embedding (:func:`embed_lookup`,
  :func:`vocab_tp`); each is the identity without a ``model`` axis, so
  the families' layer bodies serve both cases.  :func:`plan` keeps a
  layer's tensor-parallel plan per context, :func:`local_modes` checks
  that ``model`` shards its parameters as the plan needs.
* **Caches** stay in ``cache_specs``' placement: each rank holds its rows
  and its slice of the leaf's ``model``-sharded dim.  :func:`cache_layer`
  gathers one layer of a leaf over ``model`` (the families that compute
  every head), :func:`cache_store` writes the rank's slice back,
  :func:`cache_part` cuts it from a whole value (:func:`heads_part` from
  the rank's heads), :func:`new_cache` allocates the rank's shards.

:data:`STATS` counts the gathered bytes live at once (parameters and
caches apart), from each gather's output storages; :data:`CACHE_GATHERS`
counts :func:`cache_layer`'s gathers by leaf.  Outside a context
every function here returns its input: the unsharded paths run as they
did.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from types import SimpleNamespace

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import gather_local

_ACTIVE: list = []  # the open contexts, innermost last

#: gathered bytes live now and at most, per kind ("params", "cache")
STATS = {"params_live": 0, "params_peak": 0, "cache_live": 0, "cache_peak": 0}
#: cache leaf name -> layers of it gathered over ``model`` (:func:`cache_layer`)
CACHE_GATHERS: dict = {}


def reset_stats() -> None:
    """Peaks and gather counts from now on (the live counts stay)."""
    STATS["params_peak"] = STATS["params_live"]
    STATS["cache_peak"] = STATS["cache_live"]
    CACHE_GATHERS.clear()


def _untrack(kind: str, n: int) -> None:
    STATS[f"{kind}_live"] -= n


def _track(t: torch.Tensor, kind: str) -> torch.Tensor:
    st = t.untyped_storage()
    n = st.nbytes()
    STATS[f"{kind}_live"] += n
    STATS[f"{kind}_peak"] = max(STATS[f"{kind}_peak"], STATS[f"{kind}_live"])
    weakref.finalize(st, _untrack, kind, n)
    return t


def current():
    """The innermost open :class:`Shards`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def sharded(shards):
    """Run the enclosed forward (and backward) on ``shards``."""
    _ACTIVE.append(shards)
    try:
        yield shards
    finally:
        _ACTIVE.pop()


class TP:
    """The ``model`` axis of a mesh: its process group, size and this
    rank's index."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank


class Shards:
    """One sharded call on ``mesh``.  ``split``: the batch rows are split
    over the batch (FSDP) axes, so each rank's gradient is a partial sum
    over them (else every rank ran the same rows).  ``cache_dims``: each
    cache leaf's ``model``-sharded dim, counted from the end."""

    def __init__(self, mesh, *, split: bool, cache_dims: dict | None = None):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.model = names.index("model") if "model" in names else None
        self.nm = mesh.size(self.model) if self.model is not None else 1
        self.model_rank = mesh.get_local_rank("model") if self.nm > 1 else 0
        self.tp = TP(mesh.get_group(self.model), self.nm, self.model_rank) \
            if self.nm > 1 else None
        self.split = split
        self.cache_dims = dict(cache_dims or {}) if self.nm > 1 else {}
        self.leaves: dict = {}  # id(parameter) -> its local shard recording gradients
        self.plans: dict = {}  # the families' per-module tensor-parallel plans

    def track(self, module) -> list:
        """The local shard of each of ``module``'s DTensor parameters as a
        leaf that records gradients (sharing the shard's storage), in
        ``parameters()`` order; the forward then computes from them."""
        out = []
        for p in module.parameters():
            leaf = p.to_local().detach().requires_grad_(True)
            self.leaves[id(p)] = leaf
            out.append(leaf)
        return out

    def model_dim(self, p):
        """The dim of DTensor ``p`` that ``model`` shards, counted from the
        end, or None."""
        if self.nm == 1:
            return None
        pl = p.placements[self.model]
        return pl.dim - p.ndim if pl.is_shard() else None

    def param(self, p, model: str = "same"):
        """``p``'s value for this rank's compute (see the module doc for
        ``model``): gathered over the batch axes, and over ``model`` unless
        ``model == "local"``."""
        x = self.leaves.get(id(p))
        x = p.to_local() if x is None else x
        grad = x.requires_grad and torch.is_grad_enabled()
        plan = []  # (mesh dim, tensor dim it shards or None, gradient: "sum" | "same")
        for i, pl in enumerate(p.placements):
            if self.mesh.size(i) == 1:
                continue
            if i == self.model:
                if model == "local" and pl.is_shard():
                    continue
                mode = "sum" if model == "sum" else "same"
            else:
                mode = "sum" if self.split else "same"
            if pl.is_shard():
                plan.append((i, pl.dim, mode))
            elif mode == "sum" and grad:  # replicated: its partial gradients are summed
                plan.append((i, None, mode))
        if not plan:
            return x
        if grad:
            return _Gather.apply(x, self.mesh, tuple(plan), tuple(p.shape), p.placements)
        return _gather(x, self.mesh, plan, p.shape, p.placements)


def _gather(x, mesh, plan, shape, placements):
    dims = [i for i, d, _ in plan if d is not None]
    if not dims:
        return x
    return _track(gather_local(x, mesh, placements, shape, dims), "params")


def _reduce_scatter(g, dim: int, group, n: int):
    """The sum over ``group`` (``n`` ranks) of ``g``: this rank's part of
    it, one of ``n`` along ``dim``."""
    src = g.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """Forward: a shard gathered over the mesh dims of ``plan``.  Backward:
    the gradient reduced into the shard's placement, major mesh dim first
    (the inverse of the gather's order): reduce-scattered where the
    rank's part is a partial sum, sliced where every rank has the same,
    all-reduced over a dim that replicates the parameter."""

    @staticmethod
    def forward(ctx, x, mesh, plan, shape, placements):
        ctx.mesh, ctx.plan = mesh, plan
        out = _gather(x, mesh, plan, shape, placements)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        for i, d, mode in ctx.plan:
            group, n = mesh.get_group(i), mesh.size(i)
            if d is None:
                g = g.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(g, group=group)
            elif mode == "sum":
                g = _reduce_scatter(g, d, group, n)
            else:
                g = torch.chunk(g, n, dim=d)[mesh.get_local_rank(i)]
        return g.contiguous(), None, None, None, None


def param(p, model: str = "same"):
    """``p`` as this rank computes with it (:meth:`Shards.param`); ``p``
    itself outside a sharded context."""
    s = current()
    return p if s is None else s.param(p, model)


def layer(module, modes: dict | None = None):
    """One layer's parameters as this rank computes with them: a namespace
    mirroring ``module`` (attributes, submodules) whose tensors are
    :func:`param` of each parameter, ``modes`` giving the ``model`` mode by
    dotted path (default ``"same"``); ``module`` itself outside a sharded
    context."""
    s = current()
    if s is None:
        return module
    modes = modes or {}

    def tree(m, prefix):
        ns = SimpleNamespace()
        for name, p in m.named_parameters(recurse=False):
            setattr(ns, name, s.param(p, modes.get(prefix + name, "same")))
        for name, child in m.named_children():
            setattr(ns, name, tree(child, f"{prefix}{name}."))
        return ns

    return tree(module, "")


# --------------------------------------------------------------------------
# tensor parallelism over ``model``
# --------------------------------------------------------------------------


class _Enter(torch.autograd.Function):
    """Identity; the gradient, a partial sum on each ``model`` rank, is
    all-reduced (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """The sum of the ``model`` ranks' partial values; the gradient passes
    as it is (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather_last(x, group, n: int):
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1)


class _GatherLast(torch.autograd.Function):
    """The ``model`` ranks' column blocks side by side; the gradient of
    the whole, a partial sum on each rank, is reduce-scattered back."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_gather_last(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, g.ndim - 1, ctx.group, ctx.n).contiguous(), None, None


class _ScatterLast(torch.autograd.Function):
    """The sum over the ``model`` ranks of ``x``, this rank's block of its
    last dim (reduce-scatter); the gradient's blocks all-gathered."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _reduce_scatter(x, x.ndim - 1, group, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group, ctx.n), None, None


class _AllToAll(torch.autograd.Function):
    """Rows of ``x`` (dim 0) exchanged over ``group``: ``send[j]`` rows,
    in order, to rank j; ``recv[s]`` rows from rank s, stacked in rank
    order.  The gradient goes back by the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(recv), list(send), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((sum(ctx.send),) + tuple(g.shape[1:]))
        dist.all_to_all_single(out, g.contiguous(), list(ctx.send), list(ctx.recv),
                               group=ctx.group)
        return out, None, None, None


def enter(x, tp: TP | None):
    """Identity forward, gradient all-reduced over ``tp``; ``x`` itself
    without one."""
    return x if tp is None else _Enter.apply(x, tp.group)


def reduce(x, tp: TP | None):
    """The sum over ``tp``'s ranks; ``x`` itself without one."""
    return x if tp is None else _Reduce.apply(x, tp.group)


def gather_last(x, tp: TP | None):
    """``tp``'s ranks' column blocks side by side; ``x`` itself without
    one."""
    return x if tp is None else _GatherLast.apply(x, tp.group, tp.size)


def scatter_last(x, tp: TP | None):
    """The sum over ``tp``'s ranks of ``x``, this rank's block of its last
    dim; ``x`` itself without one."""
    return x if tp is None else _ScatterLast.apply(x, tp.group, tp.size)


def part_last(x, tp: TP | None):
    """This rank's block of ``x``'s last dim (a view); ``x`` itself
    without ``tp``."""
    return x if tp is None else torch.chunk(x, tp.size, dim=-1)[tp.rank]


def take_cols(w, ranges, tp: TP | None):
    """The columns (last dim) that this rank computes with, from ``w``,
    its block of a width that ``model`` splits into equal contiguous
    blocks (rank s holds block s).  ``ranges(r)`` gives rank r's columns
    of the whole width as sorted, disjoint ``(lo, hi)``; the result holds
    this rank's, in order.  One all-to-all of the column pieces: a piece
    that several ranks want is sent to each, and its gradients add up.
    ``w`` itself without ``tp``."""
    if tp is None:
        return w
    c = w.shape[-1]
    rows = w.movedim(-1, 0)

    def overlap(lo, hi, s):  # (a, b) of [lo, hi) within rank s's block
        return max(lo, s * c), min(hi, (s + 1) * c)

    pieces, send = [], []
    for dst in range(tp.size):
        n = 0
        for a, b in (overlap(lo, hi, tp.rank) for lo, hi in ranges(dst)):
            if a < b:
                pieces.append(rows[a - tp.rank * c:b - tp.rank * c])
                n += b - a
        send.append(n)
    recv = [sum(max(0, b - a) for a, b in (overlap(lo, hi, s) for lo, hi in ranges(tp.rank)))
            for s in range(tp.size)]
    x = torch.cat(pieces) if pieces else rows[:0]
    return _AllToAll.apply(x, tp.group, tuple(send), tuple(recv)).movedim(0, -1)


def reshard(x, src: int, dst: int, tp: TP | None):
    """``x``, this rank's block along dim ``src`` of a value that ``model``
    splits there, as this rank's block along dim ``dst`` instead (whole
    along ``src``, the ranks' blocks in order): one all-to-all of equal
    pieces.  ``x`` itself without ``tp``."""
    if tp is None:
        return x
    src, dst = src % x.ndim, dst % x.ndim
    rows = x.movedim(dst, 0)
    k = rows.shape[0] // tp.size
    out = _AllToAll.apply(rows, tp.group, (k,) * tp.size, (k,) * tp.size)
    at = src + 1 if src < dst else src  # ``src``'s place in ``rows``
    out = out.unflatten(0, (tp.size, k)).movedim(0, at).flatten(at, at + 1)
    return out.movedim(0, dst)


def plan(module, key, make):
    """``make(shards)``, the tensor-parallel plan of ``module`` for
    ``key``, made once per open :class:`Shards` context; None without a
    context or with one ``model`` rank."""
    s = current()
    if s is None or s.tp is None:
        return None
    k = (id(module), key)
    if k not in s.plans:
        s.plans[k] = make(s)
    return s.plans[k]


def local_modes(s: Shards, want: dict) -> dict | None:
    """``{path: "local"}`` for ``want``, path -> (DTensor parameter, the dim
    counted from the end that the plan needs ``model`` to shard), or None
    where ``model`` shards one of them otherwise."""
    if any(s.model_dim(p) != d for p, d in want.values()):
        return None
    return dict.fromkeys(want, "local")


def vocab_tp(p, dim: int):
    """The ``model`` axis (:class:`TP`) when the open context computes
    tensor-parallel and ``model`` shards vocabulary dim ``dim`` (counted
    from the end) of DTensor ``p``, else None; with it the rank keeps its
    block of ``p`` (``param(p, "local")``)."""
    s = current()
    return s.tp if s is not None and s.tp is not None and s.model_dim(p) == dim else None


def embed_lookup(table, tokens, tp: TP | None):
    """Rows ``tokens`` (int64) of ``table``; with ``tp`` its rows are the
    rank's range of a vocabulary sharded over ``model``: each rank reads
    the tokens in its range (zero elsewhere) and the ranks' rows are
    summed."""
    if tp is None:
        return table[tokens]
    V = table.shape[0]
    ids = tokens - tp.rank * V
    hit = (ids >= 0) & (ids < V)
    rows = table[ids.clamp(0, V - 1)]
    return reduce(torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                  device=rows.device)), tp)


def all_reduce(t, tp: TP | None, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over ``tp``'s ranks; ``t`` itself without
    one."""
    if tp is not None:
        dist.all_reduce(t, op=op, group=tp.group)
    return t


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def new_cache(make, device) -> dict:
    """``make(device)``'s cache, or in a sharded context the rank's shards
    of it (its rows, as ``make`` is given them, and its slice of each
    leaf's ``model``-sharded dim), zero."""
    s = current()
    if s is None or not s.cache_dims:
        return make(device)
    full = make("meta")
    out = {}
    for k, v in full.items():
        shape = list(v.shape)
        d = s.cache_dims.get(k)
        if d is not None:
            shape[d] //= s.nm
        out[k] = torch.zeros(shape, dtype=v.dtype, device=device)
    return out


def cache_part(name: str, t):
    """This rank's slice of a value for cache leaf ``name`` that is whole
    along the leaf's ``model``-sharded dim; ``t`` itself outside a sharded
    context or where ``model`` shards nothing of the leaf."""
    s = current()
    d = None if s is None else s.cache_dims.get(name)
    return t if d is None else torch.chunk(t, s.nm, dim=d)[s.model_rank]


def heads_part(name: str, t, tp: TP | None):
    """This rank's part for cache leaf ``name`` of ``t`` ``(..., heads,
    head_dim)``, which holds the rank's block of the heads with ``tp``
    (every head without one): re-laid onto its ``head_dim`` slice where
    ``model`` splits the leaf's last dim (one all-to-all), else gathered
    and cut as :func:`cache_part` cuts a whole value."""
    if tp is not None:
        if current().cache_dims.get(name) == -1:
            return reshard(t, -2, -1, tp)
        t = gather_last(t.flatten(-2), tp).unflatten(-1, (-1, t.shape[-1]))
    return cache_part(name, t)


def cache_layer(cache: dict, name: str, index):
    """``cache[name][index]`` (one layer) whole along its ``model``-sharded
    dim, for this rank's rows: gathered over ``model`` (a copy) in a
    sharded context that shards the leaf, else the view itself."""
    v = cache[name][index]
    s = current()
    d = None if s is None else s.cache_dims.get(name)
    if d is None:
        return v
    src = v.contiguous()
    parts = [torch.empty_like(src) for _ in range(s.nm)]
    dist.all_gather(parts, src, group=s.tp.group)
    CACHE_GATHERS[name] = CACHE_GATHERS.get(name, 0) + 1
    return _track(torch.cat(parts, dim=d), "cache")


def cache_store(cache: dict, name: str, index, value, part: bool = False) -> None:
    """Write ``value`` (one layer, as :func:`cache_layer` gave it, or with
    ``part`` this rank's slice already) into ``cache[name][index]``: this
    rank's slice of it; nothing when it is that view already."""
    dst = cache[name][index]
    value = value if part else cache_part(name, value)
    if value.untyped_storage()._cdata == dst.untyped_storage()._cdata \
            and value.storage_offset() == dst.storage_offset():
        return
    dst.copy_(value)


def head_range(n_heads: int, tp: TP) -> tuple[int, int]:
    """The heads ``[lo, hi)`` rank ``tp.rank`` computes: an equal share,
    or where ``model`` does not divide the heads, ``⌊r·H/n⌋`` to
    ``⌊(r+1)·H/n⌋``."""
    return (tp.rank * n_heads // tp.size, (tp.rank + 1) * n_heads // tp.size)


def gqa_heads(q_lo: int, q_hi: int, n_heads: int, n_kv: int):
    """The KV heads ``[lo, hi)`` that q heads ``[q_lo, q_hi)`` read (q head
    i reads KV head ``i // (n_heads / n_kv)``), and ``None`` when each of
    them serves an equal run of those q heads, else the index of each q
    head's KV head among them."""
    G = n_heads // n_kv
    lo, hi = q_lo // G, (q_hi - 1) // G + 1
    idx = [i // G - lo for i in range(q_lo, q_hi)]
    n_q, n_k = q_hi - q_lo, hi - lo
    even = n_q % n_k == 0 and idx == [j // (n_q // n_k) for j in range(n_q)]
    return lo, hi, None if even else idx

