"""Shared transformer layers: RMSNorm, RoPE, GQA attention (chunked
causal / bidirectional / decode), SwiGLU and GELU FFNs.

The counterpart of ``repro.models.layers``.  Matrices keep the
reference's ``(d_in, d_out)`` layout and are applied as ``x @ w``, so the
reference's parameters load without a transpose.  Attention is the
chunked online softmax of :mod:`repro_torch.models.flash`; nothing of
shape ``(S, S)`` is materialized.  ``rmsnorm`` carries the reference's
custom backward.  The reference's activation sharding hooks
(``set_activation_batch_axes``, ``constrain_batch``) act on DTensor
activations only; no forward of the port calls ``constrain_batch``, since
the sharded train step runs the forward on each rank's batch shard as
plain tensors (``repro_torch.train.train_step``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30

# --------------------------------------------------------------------------
# Basics
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """``(d_in, d_out)`` normal(0, 0.02) from ``gen`` (which must live on
    ``device``); the reference's ``dense_init`` with torch's generator."""
    return torch.randn((d_in, d_out), generator=gen, device=device, dtype=dtype) * 0.02


class _RMSNorm(torch.autograd.Function):
    """The reference's custom-VJP ``rmsnorm``.  Forward: the sum of squares
    in float32, ``r`` cast to ``x.dtype``, then ``x * r * w`` in
    ``x.dtype``.  Backward (``_rmsnorm_bwd``): the tensor math stays in
    ``x.dtype``, float32 only for the row statistic ``t``; ``dw`` is summed
    in float32 and cast to ``w.dtype``."""

    @staticmethod
    def forward(ctx, x, w, eps):
        x32 = x.float()
        sq = (x32 * x32).sum(-1, keepdim=True)
        r = torch.rsqrt(sq / x.shape[-1] + eps)  # (..., 1) f32
        ctx.save_for_backward(x, w, r)
        return x * r.to(x.dtype) * w

    @staticmethod
    def backward(ctx, dy):
        x, w, r = ctx.saved_tensors
        g = dy * w  # (..., d) in x.dtype
        t = (g.float() * x.float()).sum(-1, keepdim=True)
        coef = (r * r * r * t / x.shape[-1]).to(x.dtype)  # (..., 1)
        rx = r.to(x.dtype)
        dx = g * rx - x * coef
        dw = (dy * (x * rx)).float().reshape(-1, x.shape[-1]).sum(0).to(w.dtype)
        return dx, dw.reshape(w.shape), None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim with the reference's forward and backward
    (:class:`_RMSNorm`); ``w`` has shape ``(d,)``."""
    return _RMSNorm.apply(x, w, eps)


def swiglu(x, w1, w3, w2):
    """SwiGLU FFN: (silu(x@w1) * (x@w3)) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def gelu_ffn(x, w1, w2):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w1, approximate="tanh") @ w2


# --------------------------------------------------------------------------
# Activation sharding
# --------------------------------------------------------------------------
# Launch code names the batch axes here (``model.batch_axes(mesh)``).  The
# reference's forwards re-constrain the residual stream at every layer
# boundary; the port's run on plain local tensors and do not.  The callers
# are ``moe_sort_local`` and, with ``seq_axis``, the dry-run
# (``launch/dryrun.py``, where the reference calls it), on whose local
# activations it has no effect.  A DTensor carries its mesh, so no mesh is
# kept here.

_ACT_BATCH_AXES: tuple | None = None
_ACT_SEQ_AXIS: str | None = None  # sequence parallelism: seq dim over model


def set_activation_batch_axes(axes: tuple | None, seq_axis: str | None = None):
    global _ACT_BATCH_AXES, _ACT_SEQ_AXIS
    _ACT_BATCH_AXES = tuple(axes) if axes else None
    _ACT_SEQ_AXIS = seq_axis


def _activation_placements(mesh, ndim: int) -> list:
    """``Shard(0)`` on the batch axes, ``Shard(1)`` on the sequence axis
    of a 3-d activation when one is set, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for a in mesh.mesh_dim_names:
        if a in _ACT_BATCH_AXES:
            out.append(Shard(0))
        elif a == _ACT_SEQ_AXIS and ndim == 3:
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return out


def constrain_batch(x):
    """A DTensor activation redistributed to its batch dim over the
    configured axes (and with sequence parallelism its seq dim over
    ``model``); a plain tensor, or any tensor with no axes set, as it is."""
    from torch.distributed.tensor import DTensor

    if _ACT_BATCH_AXES is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, _activation_placements(x.device_mesh, x.ndim))


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    # float32, as the reference's weakly typed ``theta ** (...)``; a Python
    # scalar base needs no copy to the device
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    Rotates split halves (not interleaved pairs), with float32 angles; the
    rotation is computed in float32 and cast back, as the reference's
    promotion of ``x * cos`` does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def _fit_chunk(n: int, chunk: int) -> int:
    """Largest divisor of n that is ≤ chunk (the reference's chunked scans
    need S % c == 0; the port pads instead, see ``flash``)."""
    c = min(chunk, n)
    while n % c:
        c -= 1
    return c


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """(Q, K) boolean admissibility from absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Flash attention (chunked online softmax, models/flash.py) with GQA
    head grouping: K/V are never repeated across query groups."""
    from repro_torch.models.flash import flash_attention

    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kg = k.permute(0, 2, 1, 3)
    vg = v.permute(0, 2, 1, 3)
    o = flash_attention(qg, kg, vg, causal, window, q_offset, q_chunk, kv_chunk)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)


def decode_attention(q, k_cache, v_cache, valid_len):
    """One-token attention against a KV cache.

    q: (B, 1, Hq, D); caches: (B, T, Hkv, D); valid_len: int or (B,)
    per-slot valid counts (continuous batching runs slots at different
    positions).  For rotating (windowed) caches all T slots are admissible
    once full; ``valid_len`` masks the not-yet-written tail.  (The
    reference's ``window`` and ``pos`` arguments are unused there and not
    taken here: the rotating buffer does the windowing.)  As in the
    reference, all T slots are read and the tail is masked; the scores are
    rounded to ``q.dtype`` before the float32 softmax, and the weights are
    cast back to ``q.dtype`` for the PV product.
    """
    B, _, Hq, D = q.shape
    _, T, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    valid_len = torch.as_tensor(valid_len, device=q.device).broadcast_to((B,))
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k_cache).to(torch.float32)
    s = s / math.sqrt(D)
    msk = torch.arange(T, device=q.device)[None, :] < valid_len[:, None]  # (B, T)
    s = torch.where(msk[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhgt,bthd->bhgd", p, v_cache)
    return o.reshape(B, 1, Hq, D)


# --------------------------------------------------------------------------
# Attention block (shared across families)
# --------------------------------------------------------------------------


class Attention(nn.Module):
    """The reference's ``init_attn`` parameter dict as a module: ``wq``,
    ``wk``, ``wv``, ``wo`` as ``(d_in, d_out)`` matrices, the biases when
    ``qkv_bias`` and the per-head norms when ``qk_norm``."""

    def __init__(self, d_model, n_heads, n_kv, head_dim, *, qkv_bias=False, qk_norm=False,
                 d_in=None, device=None, dtype=torch.float32):
        super().__init__()
        d_in = d_in or d_model

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.wq = zeros(d_in, n_heads * head_dim)
        self.wk = zeros(d_in, n_kv * head_dim)
        self.wv = zeros(d_in, n_kv * head_dim)
        self.wo = zeros(n_heads * head_dim, d_model)
        if qkv_bias:
            self.bq = zeros(n_heads * head_dim)
            self.bk = zeros(n_kv * head_dim)
            self.bv = zeros(n_kv * head_dim)
        if qk_norm:
            self.q_norm = zeros(head_dim)
            self.k_norm = zeros(head_dim)


def init_attn(p: Attention, gen: torch.Generator) -> Attention:
    """The reference's ``init_attn`` values drawn from ``gen`` into ``p``:
    normal(0, 0.02) matrices, zero biases, unit qk-norms."""
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            w = getattr(p, name)
            w.copy_(dense_init(gen, *w.shape, device=w.device))
        for name in ("bq", "bk", "bv"):
            if hasattr(p, name):
                getattr(p, name).zero_()
        for name in ("q_norm", "k_norm"):
            if hasattr(p, name):
                getattr(p, name).fill_(1.0)
    return p


def qkv_project(p: Attention, x, n_heads, n_kv, head_dim, positions, *, theta=1e4,
                qk_norm=False):
    """x -> roped (q, k, v) with optional bias and per-head qk-norm.

    Each weight is cast to ``x.dtype`` at use, as in the reference (no copy
    when it already has that dtype)."""
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if hasattr(p, "bq"):
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if qk_norm:
        # rmsnorm's default eps (1e-6), not cfg.rmsnorm_eps, as in the reference
        q = rmsnorm(q, p.q_norm.to(dt))
        k = rmsnorm(k, p.k_norm.to(dt))
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v
