"""Mixture-of-Experts FFN with the reference's two dispatch implementations.

The counterpart of ``repro.models.moe``; autograd differentiates both
dispatches, through the router weights that ``router_topk`` gathered.

* ``dense`` — loop over experts; every expert processes every token and
  the results combine with the (mostly zero) router weights.  Exact, and
  E/k times the useful work: the baseline.
* ``sort`` — capacity dispatch: (token, expert) pairs sorted by expert,
  each expert runs a fixed-capacity batch of its tokens, outputs
  scatter-add back.  Pairs beyond an expert's capacity are dropped.

Router: top-k gating, probabilities renormalized over the selected experts
(Mixtral-style).  Ties among the logits go to the lower expert index, as
``jax.lax.top_k`` breaks them (``torch.topk`` leaves their order
unspecified): the same experts are chosen, so the same pairs drop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import swiglu


class MoE(nn.Module):
    """The reference's ``init_moe`` dict as a module: ``router`` ``(d, E)``,
    ``w1`` and ``w3`` ``(E, d, d_ff)``, ``w2`` ``(E, d_ff, d)``."""

    def __init__(self, d_model, d_ff, n_experts, *, device=None, dtype=torch.float32):
        super().__init__()

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.router = zeros(d_model, n_experts)
        self.w1 = zeros(n_experts, d_model, d_ff)
        self.w3 = zeros(n_experts, d_model, d_ff)
        self.w2 = zeros(n_experts, d_ff, d_model)


def init_moe(p: MoE, gen: torch.Generator) -> MoE:
    """The reference's ``init_moe`` values drawn from ``gen`` into ``p``:
    every weight normal(0, 0.02)."""
    with torch.no_grad():
        for name in ("router", "w1", "w3", "w2"):
            w = getattr(p, name)
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * 0.02)
    return p


def router_topk(x, router_w, top_k: int):
    """Returns (indices (..., k) int64, weights (..., k) renormalized, in
    ``x.dtype``).  Logits are taken in ``x.dtype``, then float32; a stable
    descending sort puts tied logits in index order."""
    logits = (x @ router_w.to(x.dtype)).to(torch.float32)
    top_logits, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_logits, top_idx = top_logits[..., :top_k], top_idx[..., :top_k]
    return top_idx, torch.softmax(top_logits, dim=-1).to(x.dtype)


def moe_dense(p: MoE, x, top_k: int):
    """Loop-over-experts combine: y = Σ_e w_e(x) · FFN_e(x), accumulated in
    ``x.dtype`` in expert order, as the reference's scan."""
    E = p.router.shape[-1]
    idx, w = router_topk(x, p.router, top_k)  # (..., k)
    weights = (F.one_hot(idx, E).to(x.dtype) * w[..., None]).sum(dim=-2)  # (..., E)
    acc = torch.zeros_like(x)
    dt = x.dtype
    for e in range(E):
        y = swiglu(x, p.w1[e].to(dt), p.w3[e].to(dt), p.w2[e].to(dt))
        acc = acc + y * weights[..., e, None]
    return acc


def capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Per-expert capacity C, with Python's ``round`` (ties to even) as in
    the reference, so that the same pairs drop."""
    return int(max(1, round(n_tokens * top_k / n_experts * capacity_factor)))


def dispatch(idx, n_experts: int, C: int):
    """The (token, k) pairs of ``idx`` (N, k) in the reference's sorted
    order: a stable sort by expert, each pair's rank within its expert.

    Returns (tok_s, k_s, keep, slot), each (N*k,): the token and the
    position in ``idx`` of every sorted pair, whether it fits its expert's
    capacity, and its row ``e*C + min(rank, C-1)`` of the (E*C, d) buffer."""
    N, top_k = idx.shape
    flat_e = idx.reshape(-1)
    e_s, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(e_s, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * top_k, device=idx.device) - starts[e_s]
    keep = rank < C
    slot = e_s * C + torch.clamp(rank, 0, C - 1)
    return order // top_k, order, keep, slot


def moe_sort(p: MoE, x, top_k: int, capacity_factor: float = 1.25):
    """Sort-based capacity dispatch (the reference's EP-friendly path)."""
    shape = x.shape
    d = shape[-1]
    E = p.router.shape[-1]
    xf = x.reshape(-1, d)
    N = xf.shape[0]
    idx, w = router_topk(xf, p.router, top_k)  # (N, k)
    C = capacity(N, top_k, E, capacity_factor)
    tok_s, k_s, keep, slot = dispatch(idx, E, C)
    w_s = w.reshape(-1)[k_s]

    buf = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    buf[slot[keep]] = xf[tok_s[keep]]
    h = buf.reshape(E, C, d)
    dt = x.dtype
    h1 = torch.bmm(h, p.w1.to(dt))
    h3 = torch.bmm(h, p.w3.to(dt))
    y = torch.bmm(F.silu(h1) * h3, p.w2.to(dt)).reshape(E * C, d)

    contrib = y[torch.where(keep, slot, 0)] * (w_s * keep)[:, None]
    out = torch.zeros((N, d), dtype=x.dtype, device=x.device)
    out.index_add_(0, tok_s, contrib)
    return out.reshape(shape)


def moe_sort_local(p: MoE, x, top_k: int, capacity_factor: float = 1.25):
    """Sort dispatch with shard-local routing.  On one card there is no
    batch shard, and the reference then runs :func:`moe_sort` itself; the
    mesh case waits for the multi-card port (ROADMAP Queue 1 item 8)."""
    return moe_sort(p, x, top_k, capacity_factor)


def moe_ffn(p: MoE, x, top_k: int, impl: str, capacity_factor: float = 1.25):
    if impl == "dense":
        return moe_dense(p, x, top_k)
    if impl == "sort":
        return moe_sort(p, x, top_k, capacity_factor)
    if impl == "sort_local":
        return moe_sort_local(p, x, top_k, capacity_factor)
    raise ValueError(impl)
