"""Decoder-only transformer, dense and MoE families: the serving path.

The counterpart of ``repro.models.transformer``.  Where the reference
stacks the layers' parameters on a leading ``L`` axis and scans over
them, the port holds one :class:`DecoderLayer` module per layer and loops
(the reference's stacked pytree loads through
:func:`repro_torch.models.model.params_from_numpy`).  Weights are cast to
``cfg.dtype`` at each use as in the reference; a model whose weights were
cast once when they were loaded skips those casts.  Logits are float32.

A ``moe`` config's layers hold an :class:`~repro_torch.models.moe.MoE` in
place of the MLP (``_ffn`` dispatches on ``cfg.moe_impl``).  The chunked
cross-entropy (``ce_loss``) and ``loss_fn`` wait for the training slice
and raise ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import torch
from torch import nn

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

TRAIN_ITEM = "ROADMAP Queue 1 item 6f (training)"


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


# --------------------------------------------------------------------------
# Layer body (shared by prefill / decode)
# --------------------------------------------------------------------------


def _ffn(cfg, lp: DecoderLayer, h):
    if cfg.family == "moe":
        return moe.moe_ffn(lp.moe, h, cfg.top_k, cfg.moe_impl, cfg.capacity_factor)
    m = lp.mlp
    return swiglu(h, m.w1.to(h.dtype), m.w3.to(h.dtype), m.w2.to(h.dtype))


def layer_fwd(cfg, lp: DecoderLayer, x, positions):
    """Full-sequence layer (prefill). Returns (x', (k, v))."""
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


def forward(cfg, params: Transformer, batch, *, collect_kv: bool = False):
    """Full-sequence forward to final hidden states.

    Returns (hidden (B,S,d), n_prefix, kv or None), kv as layer-stacked
    ``(k, v)`` of shape (L, B, S, Hkv, D)."""
    x, n_prefix = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).broadcast_to((B, S))
    ks, vs = [], []
    for lp in params.layers:
        x, (k, v) = layer_fwd(cfg, lp, x, positions)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = rmsnorm(x, params.final_norm.to(x.dtype), cfg.rmsnorm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, n_prefix, kvs


def ce_loss(cfg, hidden, lm_head, targets, mask):
    raise NotImplementedError(f"the chunked cross-entropy is not ported yet: {TRAIN_ITEM}")


def loss_fn(cfg, params, batch):
    raise NotImplementedError(f"the training loss is not ported yet: {TRAIN_ITEM}")


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
