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

Sharded (:mod:`~repro_torch.models.parallel`): each layer's parameters
are gathered over the FSDP axes inside its body, and where ``model`` has
more than one rank each layer computes the rank's heads and ``d_ff``
slice (:func:`_tp_plan`): column-parallel ``wq wk wv w1``, row-parallel
``wo w2`` summed over ``model``; the cross-attention's K and V of the
rank's heads from the whole ``enc_out``.  Prefill re-lays each layer's
K and V onto the ``head_dim``-sharded caches of ``cache_specs``; decode
reads them there, the q rows all-gathered and the partial scores summed
(:func:`~repro_torch.models.layers.decode_attention`).  Where the rules
do not shard a leaf as that needs, the layer is gathered whole over
``model`` too and every rank computes it, one layer's caches gathered
over ``model`` at a time.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.core.relation import resolve_device
from repro_torch.models import kvcache, parallel
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
    embed_tokens,
    final_norm,
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


_ENC = {"attn.wq": -1, "attn.wk": -1, "attn.wv": -1, "mlp.w1": -1, "attn.wo": -2,
        "mlp.w2": -2}
_DEC = {f"{a}.{w}": d for a in ("self_attn", "cross_attn")
        for w, d in (("wq", -1), ("wk", -1), ("wv", -1), ("wo", -2))}
_DEC.update({"mlp.w1": -1, "mlp.w2": -2})
_CACHE = ("self_k", "self_v", "cross_k", "cross_v")


def _tp_plan(cfg, lp, *, serve: bool):
    """How encoder or decoder layer ``lp`` (DTensor parameters) computes
    tensor-parallel in the open sharded context: ``tp`` and its
    parameters' ``model`` modes, or None where it cannot (no context, one
    ``model`` rank, heads that do not split into whole heads a rank, a
    projection not split on its column or row dim, or in serving a cache
    leaf not split on ``head_dim``)."""
    def make(s):
        want = _ENC if isinstance(lp, EncLayer) else _DEC
        modes = parallel.local_modes(s, {k: (lp.get_parameter(k), d) for k, d in want.items()})
        if modes is None or cfg.n_heads % s.nm or cfg.n_kv % s.nm or serve and any(
                s.cache_dims.get(k) != -1 for k in _CACHE):
            return None
        return SimpleNamespace(tp=s.tp, modes=modes)

    return parallel.plan(lp, serve, make)


def _layer(cfg, lp, *, serve: bool):
    """(``lp``'s parameters as this rank computes with them, ``tp`` or None)."""
    plan = _tp_plan(cfg, lp, serve=serve)
    return parallel.layer(lp, plan and plan.modes), plan and plan.tp


def _enc_layer(cfg, lp: EncLayer, x, positions):
    lp, tp = _layer(cfg, lp, serve=False)
    B, T, _ = x.shape
    h = parallel.enter(rmsnorm(x, lp.ln1.to(x.dtype), cfg.rmsnorm_eps), tp)
    q, k, v = qkv_project(lp.attn, h, cfg.head_dim, positions,
                          theta=cfg.rope_theta)
    o = attention(q, k, v, causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + parallel.reduce(o.reshape(B, T, -1) @ lp.attn.wo.to(x.dtype), tp)
    return _ffn(cfg, lp, x, tp)


def encode(cfg, params: EncDec, embeds):
    """Bidirectional encoder over stub frame embeddings (B, T_a, d)."""
    x = embeds.to(compute_dtype(cfg))
    positions = _positions(x.shape[0], x.shape[1], x.device)
    body = remat(cfg, lambda x, lp: _enc_layer(cfg, lp, x, positions))
    for lp in params.enc_layers:
        x = body(x, lp)
    return final_norm(cfg, params, x, "enc_norm")


def _cross_kv(lp: DecLayer, enc_out, cfg, tp=None):
    """The cross-attention K/V of one decoder layer (no RoPE); with ``tp``
    the rank's heads."""
    B, T, _ = enc_out.shape
    enc_out = parallel.enter(enc_out, tp)
    k = (enc_out @ lp.cross_attn.wk.to(enc_out.dtype)).reshape(B, T, -1, cfg.head_dim)
    v = (enc_out @ lp.cross_attn.wv.to(enc_out.dtype)).reshape(B, T, -1, cfg.head_dim)
    return k, v


def _cross(cfg, lp: DecLayer, x, attend, tp=None, whole=None):
    """The cross-attention half-block: ``attend(q)`` -> (B, S, H, D), or
    with ``tp`` the rank's block of its heads (the ``wo`` rows it holds);
    ``whole`` maps the rank's q columns to the ones it attends with."""
    B, S, _ = x.shape
    h = parallel.enter(rmsnorm(x, lp.lnx.to(x.dtype), cfg.rmsnorm_eps), tp)
    q = h @ lp.cross_attn.wq.to(x.dtype)
    q = (q if whole is None else whole(q)).reshape(B, S, -1, cfg.head_dim)
    return x + parallel.reduce(attend(q).reshape(B, S, -1) @ lp.cross_attn.wo.to(x.dtype), tp)


def _ffn(cfg, lp, x, tp=None):
    h = parallel.enter(rmsnorm(x, lp.ln2.to(x.dtype), cfg.rmsnorm_eps), tp)
    return x + parallel.reduce(gelu_ffn(h, lp.mlp.w1.to(x.dtype), lp.mlp.w2.to(x.dtype)), tp)


def _dec_layer(cfg, lp: DecLayer, x, enc_out, positions, tp=None):
    """One teacher-forced decoder layer (``lp`` as :func:`parallel.layer
    <repro_torch.models.parallel.layer>` gives it; with ``tp`` the rank's
    heads). Returns (x', (k, v))."""
    B, S, _ = x.shape
    h = parallel.enter(rmsnorm(x, lp.ln1.to(x.dtype), cfg.rmsnorm_eps), tp)
    q, k, v = qkv_project(lp.self_attn, h, cfg.head_dim, positions,
                          theta=cfg.rope_theta)
    o = attention(q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + parallel.reduce(o.reshape(B, S, -1) @ lp.self_attn.wo.to(x.dtype), tp)
    kx, vx = _cross_kv(lp, enc_out, cfg, tp)
    x = _cross(cfg, lp, x, lambda qx: attention(qx, kx, vx, causal=False,
                                                q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk), tp)
    return _ffn(cfg, lp, x, tp), (k, v)


def decode_full(cfg, params: EncDec, tokens, enc_out, *, collect_kv=False, on_layer=None):
    """Teacher-forced decoder pass. Returns (hidden, self-kv or None), the
    self K/V layer-stacked as (L, B, S, Hkv, D) with ``collect_kv``; with
    ``on_layer``, ``on_layer(i, lp, k, v, tp)`` is called with each layer's
    parameters, self K/V (of the rank's heads with ``tp``) and ``tp``
    instead."""
    x = embed_tokens(cfg, params, tokens)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    kvs = None
    if collect_kv or on_layer is not None:
        ks, vs = [], []
        for i, lp in enumerate(params.dec_layers):
            lp, tp = _layer(cfg, lp, serve=on_layer is not None)
            x, (k, v) = _dec_layer(cfg, lp, x, enc_out, positions, tp)
            if on_layer is not None:
                on_layer(i, lp, k, v, tp)
            else:
                ks.append(k)
                vs.append(v)
        kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    else:
        def body(x, lp, enc_out):
            lp, tp = _layer(cfg, lp, serve=False)
            return _dec_layer(cfg, lp, x, enc_out, positions, tp)[0]

        body = remat(cfg, body)
        for lp in params.dec_layers:
            x = body(x, lp, enc_out)
    return final_norm(cfg, params, x), kvs


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
    B, S = batch["tokens"].shape
    cache = parallel.new_cache(
        lambda dev: init_cache(cfg, B, max_len, enc_out.shape[1], device=dev), params.device)

    def keep(i, lp, k, v, tp):
        cache["self_k"][i][:, :S] = parallel.heads_part("self_k", k, tp)
        cache["self_v"][i][:, :S] = parallel.heads_part("self_v", v, tp)
        kx, vx = _cross_kv(lp, enc_out, cfg, tp)
        cache["cross_k"][i].copy_(parallel.heads_part("cross_k", kx, tp))
        cache["cross_v"][i].copy_(parallel.heads_part("cross_v", vx, tp))

    hidden, _ = decode_full(cfg, params, batch["tokens"], enc_out, on_layer=keep)
    cache["len"].fill_(S)
    return cache, _logits(params, hidden[:, -1])


def decode_step(cfg, params: EncDec, cache, tokens):
    """One decode step. tokens: (B, 1) -> (cache', logits (B, V)); the self
    K/V are written in place and every slot's clock advances.
    Tensor-parallel, as ``transformer.layer_decode``: q, k and v from the
    rank's column blocks all-gathered, the new token's ``head_dim`` slice
    written, the partial scores summed, the output's row block through the
    rank's ``wo`` rows."""
    x = embed_tokens(cfg, params, tokens)  # (B, 1, d)
    length = cache["len"]
    B = x.shape[0]
    T_a = cache["cross_k"].shape[2]
    pos = length.broadcast_to((B,))[:, None]
    for i, lp in enumerate(params.dec_layers):
        lp, tp = _layer(cfg, lp, serve=True)
        n, r = (1, 0) if tp is None else (tp.size, tp.rank)
        kc, vc, kx, vx = (cache[k][i] if tp else parallel.cache_layer(cache, k, i)
                          for k in _CACHE)
        whole = None if tp is None else (lambda *t: [parallel.gather_last(u, tp) for u in t])
        h = rmsnorm(x, lp.ln1.to(x.dtype), cfg.rmsnorm_eps)
        q, k, v = qkv_project(lp.self_attn, h, cfg.head_dim, pos,
                              theta=cfg.rope_theta, whole=whole)
        D = cfg.head_dim // n
        kvcache.cache_write_token(kc, vc, k[..., r * D:(r + 1) * D], v[..., r * D:(r + 1) * D],
                                  length)
        o = decode_attention(q, kc, vc, torch.clamp(length + 1, max=kc.shape[1]), tp)
        if tp is None:
            parallel.cache_store(cache, "self_k", i, kc)
            parallel.cache_store(cache, "self_v", i, vc)
        o = parallel.part_last(o.reshape(B, 1, -1), tp)
        x = x + parallel.reduce(o @ lp.self_attn.wo.to(x.dtype), tp)
        x = _cross(cfg, lp, x, lambda qx: parallel.part_last(
            decode_attention(qx, kx, vx, T_a, tp).reshape(B, 1, -1), tp), tp,
            whole and (lambda q: whole(q)[0]))
        x = _ffn(cfg, lp, x, tp)
    x = final_norm(cfg, params, x)
    return dict(cache, len=length + 1), _logits(params, x[:, -1])
