"""Decoder-only transformer: the dense, MoE and stub-frontend VLM families.

The counterpart of ``repro.models.transformer``.  Where the reference
stacks the layers' parameters on a leading ``L`` axis and scans over
them, the port holds one :class:`DecoderLayer` module per layer and loops
(the reference's stacked pytree loads through
:func:`repro_torch.models.model.params_from_numpy`).  Weights are cast to
``cfg.dtype`` at each use as in the reference; a model whose weights were
cast once when they were loaded skips those casts.  Logits are float32.

A ``moe`` config's layers hold an :class:`~repro_torch.models.moe.MoE` in
place of the MLP (``_ffn`` dispatches on ``cfg.moe_impl``).  A ``vlm``
batch carries ``embeds`` ``(B, frontend_tokens, d)``, the stub frontend's
patch embeddings, prepended to the token embeddings: they take the first
positions of the KV cache, and decode positions count them.

Training: :func:`loss_fn` is the next-token cross-entropy over the text
positions, computed in sequence chunks by :func:`ce_loss`, which never
holds ``(B, S, V)`` logits (its backward recomputes each chunk's logits).
Under autograd each layer runs inside ``torch.utils.checkpoint`` as the
config's ``remat`` asks (:func:`remat`).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.relation import resolve_device
from repro_torch.models import kvcache, moe
from repro_torch.models.layers import (
    Attention,
    attention,
    decode_attention,
    dense_init,
    init_attn,
    qkv_project,
    rmsnorm,
    swiglu,
)

def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype), requires_grad=False)


# --------------------------------------------------------------------------
# Modules and init
# --------------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU weights ``w1``, ``w3`` ``(d, d_ff)`` and ``w2`` ``(d_ff, d)``."""

    def __init__(self, d_model, d_ff, *, device=None, dtype=torch.float32):
        super().__init__()
        self.w1 = _param(d_model, d_ff, device=device, dtype=dtype)
        self.w3 = _param(d_model, d_ff, device=device, dtype=dtype)
        self.w2 = _param(d_ff, d_model, device=device, dtype=dtype)


class DecoderLayer(nn.Module):
    """One layer's parameters, named as the reference's layer dict:
    ``ln1``, ``ln2``, ``attn`` and ``mlp`` (``moe`` for a MoE config)."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.ln1 = _param(cfg.d_model, device=device, dtype=dtype)
        self.ln2 = _param(cfg.d_model, device=device, dtype=dtype)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                              qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
                              device=device, dtype=dtype)
        if cfg.family == "moe":
            self.moe = moe.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, device=device, dtype=dtype)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device, dtype=dtype)


class Transformer(nn.Module):
    """The reference's parameter pytree as modules: ``embed`` ``(V, d)``,
    ``layers``, ``final_norm`` and ``lm_head`` ``(d, V)``."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(cfg.vocab, cfg.d_model, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device=device, dtype=dtype) for _ in range(cfg.n_layers)
        )
        self.final_norm = _param(cfg.d_model, device=device, dtype=dtype)
        self.lm_head = _param(cfg.d_model, cfg.vocab, device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_layer(lp: DecoderLayer, gen: torch.Generator) -> DecoderLayer:
    """The reference's ``init_layer`` values drawn from ``gen`` into ``lp``."""
    init_attn(lp.attn, gen)
    with torch.no_grad():
        lp.ln1.fill_(1.0)
        lp.ln2.fill_(1.0)
        if hasattr(lp, "moe"):
            moe.init_moe(lp.moe, gen)
        else:
            for name in ("w1", "w3", "w2"):
                w = getattr(lp.mlp, name)
                w.copy_(dense_init(gen, *w.shape, device=w.device))
    return lp


def init_params(cfg, seed: int = 0, *, device=None, dtype=None) -> Transformer:
    """Random init from ``seed`` with a ``torch.Generator`` on ``device``
    (the card unless ``device="cpu"``): normal(0, 0.02) matrices and
    embedding, unit norms, zero biases, as the reference's ``init_params``
    (whose ``jax.random`` draws other numbers).  Weights are drawn in
    float32 and stored in ``dtype`` (default ``cfg.dtype``)."""
    device = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, device=device, dtype=dtype)
    for lp in model.layers:
        init_layer(lp, gen)
    return init_head(model, gen)


def init_head(model, gen: torch.Generator):
    """Every family's ends, drawn after its layers: unit ``final_norm``,
    normal(0, 0.02) ``lm_head`` ``(d, V)`` and ``embed`` ``(V, d)``."""
    with torch.no_grad():
        model.final_norm.fill_(1.0)
        for w in (model.lm_head, model.embed):
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * 0.02)
    return model


def expected_initial_loss(cfg) -> float:
    """The mean next-token loss of freshly initialised weights on uniform
    tokens: the final norm gives rows of unit RMS over d entries and the
    head's weights have std 0.02, so the logits are about normal with
    variance σ² = d · 0.02², E[logsumexp] = ln V + σ²/2 over V of them,
    and the target's logit is 0 on average."""
    return math.log(cfg.vocab) + cfg.d_model * 0.02**2 / 2


# --------------------------------------------------------------------------
# Layer body (shared by train / prefill / decode)
# --------------------------------------------------------------------------


def _ffn(cfg, lp: DecoderLayer, h):
    if cfg.family == "moe":
        return moe.moe_ffn(lp.moe, h, cfg.top_k, cfg.moe_impl, cfg.capacity_factor)
    m = lp.mlp
    return swiglu(h, m.w1.to(h.dtype), m.w3.to(h.dtype), m.w2.to(h.dtype))


def layer_fwd(cfg, lp: DecoderLayer, x, positions):
    """Full-sequence layer (train / prefill). Returns (x', (k, v))."""
    h = rmsnorm(x, lp.ln1.to(x.dtype), cfg.rmsnorm_eps)
    q, k, v = qkv_project(
        lp.attn, h, cfg.n_heads, cfg.n_kv, cfg.head_dim, positions,
        theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
    )
    o = attention(
        q, k, v, causal=True, window=cfg.window,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
    )
    B, S, _, _ = o.shape
    x = x + o.reshape(B, S, -1) @ lp.attn.wo.to(x.dtype)
    h = rmsnorm(x, lp.ln2.to(x.dtype), cfg.rmsnorm_eps)
    x = x + _ffn(cfg, lp, h)
    return x, (k, v)


def layer_decode(cfg, lp: DecoderLayer, x, k_cache, v_cache, length):
    """One-token layer against a cache (written in place). x: (B, 1, d)."""
    h = rmsnorm(x, lp.ln1.to(x.dtype), cfg.rmsnorm_eps)
    pos = torch.as_tensor(length, device=x.device).broadcast_to((x.shape[0],))[:, None]
    q, k, v = qkv_project(
        lp.attn, h, cfg.n_heads, cfg.n_kv, cfg.head_dim, pos,
        theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
    )
    k_cache, v_cache = kvcache.cache_write_token(k_cache, v_cache, k, v, length)
    T = k_cache.shape[1]
    valid = torch.clamp(length + 1, max=T)
    o = decode_attention(q, k_cache, v_cache, valid)
    B = x.shape[0]
    x = x + o.reshape(B, 1, -1) @ lp.attn.wo.to(x.dtype)
    h = rmsnorm(x, lp.ln2.to(x.dtype), cfg.rmsnorm_eps)
    x = x + _ffn(cfg, lp, h)
    return x, k_cache, v_cache


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------


def embed_inputs(cfg, params: Transformer, batch):
    """Token embeddings, with stub-frontend embeddings prepended when the
    batch carries ``embeds``.  Tokens may be int32 (the reference's type);
    they are indexed as int64."""
    tokens = batch["tokens"].long()
    dtype = compute_dtype(cfg)
    # the reference casts the table, then gathers: the same values
    x = params.embed[tokens].to(dtype)
    n_prefix = 0
    if batch.get("embeds") is not None:
        pre = batch["embeds"].to(dtype)
        x = torch.cat([pre, x], dim=1)
        n_prefix = pre.shape[1]
    return x, n_prefix


def remat(cfg, fn):
    """``fn`` wrapped as the config's remat policy asks when autograd is
    recording (the reference's ``_remat``): ``"full"`` runs it under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only its inputs
    and recomputes it in the backward; ``"none"`` keeps every activation.
    ``"dots"`` (the reference keeps the matmul outputs) falls back to
    ``"full"``: torch's checkpoint has no per-op save policy."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward(cfg, params: Transformer, batch, *, collect_kv: bool = False):
    """Full-sequence forward to final hidden states.

    Returns (hidden (B,S,d), n_prefix, kv or None), kv as layer-stacked
    ``(k, v)`` of shape (L, B, S, Hkv, D)."""
    x, n_prefix = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).broadcast_to((B, S))
    # prefill collects each layer's K/V and runs without autograd, where
    # ``remat`` returns the body as it is
    body = remat(cfg, lambda x, lp: layer_fwd(cfg, lp, x, positions))
    ks, vs = [], []
    for lp in params.layers:
        x, (k, v) = body(x, lp)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = rmsnorm(x, params.final_norm.to(x.dtype), cfg.rmsnorm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, n_prefix, kvs


class _ChunkedCE(torch.autograd.Function):
    """Masked mean next-token cross-entropy of ``hidden @ lm_head``, chunk by
    chunk along the sequence: the forward keeps each position's float32
    log-sum-exp, the backward recomputes each chunk's logits, so no more
    than one chunk's ``(B, chunk, V)`` logits are ever live."""

    @staticmethod
    def forward(ctx, hidden, lm_head, targets, mask, chunk):
        S = hidden.shape[1]
        w = lm_head.to(hidden.dtype)
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        lses = []
        for lo in range(0, S, chunk):
            logits = (hidden[:, lo:lo + chunk] @ w).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, targets[:, lo:lo + chunk, None])[..., 0]
            tot += ((lse - tgt) * mask[:, lo:lo + chunk]).sum()
            lses.append(lse)
            del logits
        cnt = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(hidden, lm_head, targets, mask, torch.cat(lses, 1), cnt)
        ctx.chunk = chunk
        return tot / cnt

    @staticmethod
    def backward(ctx, g):
        hidden, lm_head, targets, mask, lse, cnt = ctx.saved_tensors
        chunk = ctx.chunk
        S, d = hidden.shape[1], hidden.shape[2]
        w = lm_head.to(hidden.dtype)
        coef = mask * (g / cnt)  # (B, S) f32
        dh = torch.empty_like(hidden)
        dw = torch.zeros(lm_head.shape, dtype=torch.float32, device=lm_head.device)
        for lo in range(0, S, chunk):
            xc = hidden[:, lo:lo + chunk]
            # d loss / d logits = (softmax - onehot(target)) * mask * g / cnt
            p = torch.exp((xc @ w).to(torch.float32) - lse[:, lo:lo + chunk, None])
            p.scatter_add_(-1, targets[:, lo:lo + chunk, None],
                           torch.full_like(p[..., :1], -1.0))
            p *= coef[:, lo:lo + chunk, None]
            dl = p.to(hidden.dtype)
            del p
            dh[:, lo:lo + chunk] = dl @ w.T
            dw += (xc.reshape(-1, d).T @ dl.reshape(-1, dl.shape[-1])).to(torch.float32)
        return dh, dw.to(lm_head.dtype), None, None, None


def ce_loss(cfg, hidden, lm_head, targets, mask):
    """Chunked cross-entropy; never materializes (B, S, V).

    The reference's ``ce_loss``: logits ``hidden @ lm_head`` in
    ``hidden.dtype``, then float32; the loss is ``sum((lse - logit[target])
    * mask) / max(sum(mask), 1)``.  The reference takes chunks of the
    largest divisor of S that is ≤ ``cfg.ce_chunk``; the port takes chunks
    of ``cfg.ce_chunk`` and a shorter last one (the same sum in another
    order)."""
    return _ChunkedCE.apply(hidden, lm_head, targets.long(), mask.to(torch.float32),
                            min(cfg.ce_chunk, hidden.shape[1]))


def next_token_targets(tokens, n_prefix: int = 0):
    """(targets, mask) over ``n_prefix`` + S positions: position t predicts
    ``tokens[t+1]``; the last position and the ``n_prefix`` frontend
    positions in front are masked out (the reference's ``loss_fn``)."""
    B, St = tokens.shape
    targets = torch.zeros((B, n_prefix + St), dtype=torch.int64, device=tokens.device)
    targets[:, n_prefix:n_prefix + St - 1] = tokens[:, 1:]
    mask = torch.zeros((B, n_prefix + St), dtype=torch.float32, device=tokens.device)
    mask[:, n_prefix:n_prefix + St - 1] = 1.0
    return targets, mask


def loss_fn(cfg, params: Transformer, batch):
    """Next-token CE over text positions (prefix embeddings unsupervised)."""
    hidden, n_prefix, _ = forward(cfg, params, batch)
    targets, mask = next_token_targets(batch["tokens"], n_prefix)
    return ce_loss(cfg, hidden, params.lm_head, targets, mask)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    return kvcache.init_attn_cache(
        cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim,
        window=cfg.decode_window or cfg.window, dtype=compute_dtype(cfg),
        device=resolve_device(device),
    )


def _logits(params: Transformer, h):
    # the reference's `h @ lm_head.astype(h.dtype)`, then float32
    return (h @ params.lm_head.to(h.dtype)).to(torch.float32)


def prefill(cfg, params: Transformer, batch, max_len: int):
    """Encode the prompt; returns (cache, last-token logits)."""
    hidden, _, kvs = forward(cfg, params, batch, collect_kv=True)
    cache = init_cache(cfg, batch["tokens"].shape[0], max_len, device=params.device)
    cache = kvcache.cache_write_prefill(cache, kvs[0], kvs[1])
    return cache, _logits(params, hidden[:, -1])


def decode_step(cfg, params: Transformer, cache, tokens):
    """One decode step. tokens: (B, 1) -> (cache', logits (B, V)).

    Every slot's clock advances, active or not, as in the reference.  The
    returned cache holds the same ``k``/``v`` tensors, written in place, and
    a new ``len``."""
    x = params.embed[tokens.long()].to(compute_dtype(cfg))
    length = cache["len"]
    for i, lp in enumerate(params.layers):
        x, _, _ = layer_decode(cfg, lp, x, cache["k"][i], cache["v"][i], length)
    x = rmsnorm(x, params.final_norm.to(x.dtype), cfg.rmsnorm_eps)
    logits = _logits(params, x[:, -1])
    return {"k": cache["k"], "v": cache["v"], "len": length + 1}, logits
