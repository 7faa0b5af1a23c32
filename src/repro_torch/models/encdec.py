"""Encoder–decoder transformer (seamless-m4t family).

The counterpart of ``repro.models.encdec``.  The speech frontend is a stub:
the encoder consumes precomputed frame embeddings ``batch["embeds"]``
``(B, T_a, d_model)``.  The encoder is bidirectional; the decoder is a
causal transformer with cross-attention to the encoder output.  Serving
caches the decoder's self-attention K/V and the cross-attention K/V, which
are computed once at prefill; decode reads all ``T_a`` cross positions.
Cross-attention projections carry no RoPE.

As in :mod:`repro_torch.models.transformer`, one module per layer where
the reference stacks and scans (``enc_layers.<i>.*``, ``dec_layers.<i>.*``);
caches are written in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.relation import resolve_device
from repro_torch.models import kvcache
from repro_torch.models.layers import (
    Attention,
    attention,
    decode_attention,
    dense_init,
    gelu_ffn,
    init_attn,
    qkv_project,
    rmsnorm,
)
from repro_torch.models.transformer import (
    _logits,
    _param,
    ce_loss,
    compute_dtype,
    init_head,
    next_token_targets,
    remat,
)


class FFN(nn.Module):
    """GELU FFN weights ``w1`` ``(d, d_ff)`` and ``w2`` ``(d_ff, d)``."""

    def __init__(self, d_model, d_ff, *, device=None, dtype=torch.float32):
        super().__init__()
        self.w1 = _param(d_model, d_ff, device=device, dtype=dtype)
        self.w2 = _param(d_ff, d_model, device=device, dtype=dtype)


def _attn(cfg, device, dtype) -> Attention:
    return Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim, device=device,
                     dtype=dtype)


class EncLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``, as the reference's encoder layer."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.ln1 = _param(cfg.d_model, device=device, dtype=dtype)
        self.attn = _attn(cfg, device, dtype)
        self.ln2 = _param(cfg.d_model, device=device, dtype=dtype)
        self.mlp = FFN(cfg.d_model, cfg.d_ff, device=device, dtype=dtype)


class DecLayer(nn.Module):
    """``ln1``, ``self_attn``, ``lnx``, ``cross_attn``, ``ln2``, ``mlp``, as the
    reference's decoder layer."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.ln1 = _param(cfg.d_model, device=device, dtype=dtype)
        self.self_attn = _attn(cfg, device, dtype)
        self.lnx = _param(cfg.d_model, device=device, dtype=dtype)
        self.cross_attn = _attn(cfg, device, dtype)
        self.ln2 = _param(cfg.d_model, device=device, dtype=dtype)
        self.mlp = FFN(cfg.d_model, cfg.d_ff, device=device, dtype=dtype)


class EncDec(nn.Module):
    """The reference's parameter pytree as modules: ``embed`` ``(V, d)``,
    ``enc_layers``, ``enc_norm``, ``dec_layers``, ``final_norm`` and
    ``lm_head`` ``(d, V)``."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(cfg.vocab, cfg.d_model, device=device, dtype=dtype)
        self.enc_layers = nn.ModuleList(
            EncLayer(cfg, device=device, dtype=dtype) for _ in range(cfg.enc_layers))
        self.enc_norm = _param(cfg.d_model, device=device, dtype=dtype)
        self.dec_layers = nn.ModuleList(
            DecLayer(cfg, device=device, dtype=dtype) for _ in range(cfg.dec_layers))
        self.final_norm = _param(cfg.d_model, device=device, dtype=dtype)
        self.lm_head = _param(cfg.d_model, cfg.vocab, device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, seed: int = 0, *, device=None, dtype=None) -> EncDec:
    """Random init from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), the reference's ``init_params`` distributions, stored
    in ``dtype`` (default ``cfg.dtype``)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = EncDec(cfg, device=device, dtype=dtype or compute_dtype(cfg))
    for lp in list(model.enc_layers) + list(model.dec_layers):
        for attn in (lp.attn,) if isinstance(lp, EncLayer) else (lp.self_attn, lp.cross_attn):
            init_attn(attn, gen)
        with torch.no_grad():
            for name in ("ln1", "lnx", "ln2"):
                if hasattr(lp, name):
                    getattr(lp, name).fill_(1.0)
            for w in (lp.mlp.w1, lp.mlp.w2):
                w.copy_(dense_init(gen, *w.shape, device=device))
    with torch.no_grad():
        model.enc_norm.fill_(1.0)
    return init_head(model, gen)


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).broadcast_to((B, S))


def _enc_layer(cfg, lp: EncLayer, x, positions):
    B, T, _ = x.shape
    h = rmsnorm(x, lp.ln1.to(x.dtype), cfg.rmsnorm_eps)
    q, k, v = qkv_project(lp.attn, h, cfg.n_heads, cfg.n_kv, cfg.head_dim, positions,
                          theta=cfg.rope_theta)
    o = attention(q, k, v, causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + o.reshape(B, T, -1) @ lp.attn.wo.to(x.dtype)
    h = rmsnorm(x, lp.ln2.to(x.dtype), cfg.rmsnorm_eps)
    return x + gelu_ffn(h, lp.mlp.w1.to(x.dtype), lp.mlp.w2.to(x.dtype))


def encode(cfg, params: EncDec, embeds):
    """Bidirectional encoder over stub frame embeddings (B, T_a, d)."""
    x = embeds.to(compute_dtype(cfg))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    body = remat(cfg, lambda x, lp: _enc_layer(cfg, lp, x, positions))
    for lp in params.enc_layers:
        x = body(x, lp)
    return rmsnorm(x, params.enc_norm.to(x.dtype), cfg.rmsnorm_eps)


def _cross_kv(lp: DecLayer, enc_out, cfg):
    """The cross-attention K/V of one decoder layer (no RoPE)."""
    B, T, _ = enc_out.shape
    k = (enc_out @ lp.cross_attn.wk.to(enc_out.dtype)).reshape(B, T, cfg.n_kv, cfg.head_dim)
    v = (enc_out @ lp.cross_attn.wv.to(enc_out.dtype)).reshape(B, T, cfg.n_kv, cfg.head_dim)
    return k, v


def _cross(cfg, lp: DecLayer, x, attend):
    """The cross-attention half-block: ``attend(q)`` -> (B, S, H, D)."""
    B, S, _ = x.shape
    h = rmsnorm(x, lp.lnx.to(x.dtype), cfg.rmsnorm_eps)
    q = (h @ lp.cross_attn.wq.to(x.dtype)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    return x + attend(q).reshape(B, S, -1) @ lp.cross_attn.wo.to(x.dtype)


def _ffn(cfg, lp, x):
    h = rmsnorm(x, lp.ln2.to(x.dtype), cfg.rmsnorm_eps)
    return x + gelu_ffn(h, lp.mlp.w1.to(x.dtype), lp.mlp.w2.to(x.dtype))


def _dec_layer(cfg, lp: DecLayer, x, enc_out, positions):
    """One teacher-forced decoder layer. Returns (x', (k, v))."""
    B, S, _ = x.shape
    h = rmsnorm(x, lp.ln1.to(x.dtype), cfg.rmsnorm_eps)
    q, k, v = qkv_project(lp.self_attn, h, cfg.n_heads, cfg.n_kv, cfg.head_dim, positions,
                          theta=cfg.rope_theta)
    o = attention(q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + o.reshape(B, S, -1) @ lp.self_attn.wo.to(x.dtype)
    kx, vx = _cross_kv(lp, enc_out, cfg)
    x = _cross(cfg, lp, x, lambda qx: attention(qx, kx, vx, causal=False,
                                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk))
    return _ffn(cfg, lp, x), (k, v)


def decode_full(cfg, params: EncDec, tokens, enc_out, *, collect_kv=False):
    """Teacher-forced decoder pass. Returns (hidden, self-kv or None), the
    self K/V layer-stacked as (L, B, S, Hkv, D)."""
    x = params.embed[tokens.long()].to(compute_dtype(cfg))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    kvs = None
    if collect_kv:
        ks, vs = [], []
        for lp in params.dec_layers:
            x, (k, v) = _dec_layer(cfg, lp, x, enc_out, positions)
            ks.append(k)
            vs.append(v)
        kvs = (torch.stack(ks), torch.stack(vs))
    else:
        body = remat(cfg, lambda x, lp, enc_out: _dec_layer(cfg, lp, x, enc_out, positions)[0])
        for lp in params.dec_layers:
            x = body(x, lp, enc_out)
    return rmsnorm(x, params.final_norm.to(x.dtype), cfg.rmsnorm_eps), kvs


def loss_fn(cfg, params: EncDec, batch):
    """Next-token CE over the decoder's text positions."""
    enc_out = encode(cfg, params, batch["embeds"])
    hidden, _ = decode_full(cfg, params, batch["tokens"], enc_out)
    targets, mask = next_token_targets(batch["tokens"])
    return ce_loss(cfg, hidden, params.lm_head, targets, mask)


def init_cache(cfg, batch: int, max_len: int, cross_len: int, *, device=None):
    """Self K/V of ``max_len`` positions and cross K/V of ``cross_len``, per
    decoder layer, in ``cfg.dtype``, and the per-slot clock ``len``."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg)

    def zeros(T):
        return torch.zeros((cfg.dec_layers, batch, T, cfg.n_kv, cfg.head_dim), dtype=dtype,
                           device=device)

    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(cross_len), "cross_v": zeros(cross_len),
            "len": torch.zeros((batch,), dtype=torch.int64, device=device)}


def prefill(cfg, params: EncDec, batch, max_len: int):
    """Encode the frames and the prompt; returns (cache, last-token logits).
    The cache is the prefill's own, of ``max_len`` self positions and the
    ``T_a`` encoder positions, as the reference's."""
    enc_out = encode(cfg, params, batch["embeds"])
    hidden, (ks, vs) = decode_full(cfg, params, batch["tokens"], enc_out, collect_kv=True)
    B, S = batch["tokens"].shape
    cache = init_cache(cfg, B, max_len, enc_out.shape[1], device=params.device)
    cache["self_k"][:, :, :S] = ks
    cache["self_v"][:, :, :S] = vs
    for i, lp in enumerate(params.dec_layers):
        cache["cross_k"][i], cache["cross_v"][i] = _cross_kv(lp, enc_out, cfg)
    cache["len"].fill_(S)
    return cache, _logits(params, hidden[:, -1])


def decode_step(cfg, params: EncDec, cache, tokens):
    """One decode step. tokens: (B, 1) -> (cache', logits (B, V)); the self
    K/V are written in place and every slot's clock advances."""
    x = params.embed[tokens.long()].to(compute_dtype(cfg))  # (B, 1, d)
    length = cache["len"]
    B = x.shape[0]
    T_a = cache["cross_k"].shape[2]
    pos = length.broadcast_to((B,))[:, None]
    for i, lp in enumerate(params.dec_layers):
        kc, vc = cache["self_k"][i], cache["self_v"][i]
        h = rmsnorm(x, lp.ln1.to(x.dtype), cfg.rmsnorm_eps)
        q, k, v = qkv_project(lp.self_attn, h, cfg.n_heads, cfg.n_kv, cfg.head_dim, pos,
                              theta=cfg.rope_theta)
        kvcache.cache_write_token(kc, vc, k, v, length)
        o = decode_attention(q, kc, vc, torch.clamp(length + 1, max=kc.shape[1]))
        x = x + o.reshape(B, 1, -1) @ lp.self_attn.wo.to(x.dtype)
        x = _cross(cfg, lp, x, lambda qx: decode_attention(qx, cache["cross_k"][i],
                                                           cache["cross_v"][i], T_a))
        x = _ffn(cfg, lp, x)
    x = rmsnorm(x, params.final_norm.to(x.dtype), cfg.rmsnorm_eps)
    return dict(cache, len=length + 1), _logits(params, x[:, -1])
