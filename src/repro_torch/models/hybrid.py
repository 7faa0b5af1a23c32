"""Zamba2-style hybrid: Mamba-2 backbone + one *shared* attention block.

The counterpart of ``repro.models.hybrid``: serving and the training loss.  The stack is
``n_groups = n_layers // period`` groups of ``period`` Mamba-2 blocks, each
group preceded by the shared attention block (one parameter set, one KV
cache per group), plus ``n_layers % period`` trailing Mamba-2 blocks.  The
shared block sees ``concat(hidden, original embeddings)`` at width
2·d_model; its output projects back to d_model and adds to the residual.

Cache leaves: ``attn_k``/``attn_v`` ``(g, B, T, Hkv, D)`` with ``T`` capped
by ``decode_window`` (the rotating buffer of :mod:`kvcache`), the grouped
``conv`` ``(g, per, B, W-1, C)`` and ``ssm`` ``(g, per, B, H, P, N)`` (batch
on dim 2), the tail's ``conv_tail``/``ssm_tail`` (batch on dim 1) and
``len``.  Caches are written in place.

Sharded (:mod:`~repro_torch.models.parallel`): each Mamba-2 layer's
parameters are gathered whole (over every axis: this family computes no
tensor-parallel part) inside its body, and the shared block's at each of
its uses, so no rank holds more than one layer's gathered weights; under
autograd each use then runs in a remat body too (its recompute gathers
again, and its gradient is reduce-scattered use by use).  Each layer's
cache leaves are gathered over ``model`` for the rank's rows and its
slice written back.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.relation import resolve_device
from repro_torch.models import kvcache, parallel, ssm
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
from repro_torch.models.ssm_model import MambaLayer, init_mamba_layer
from repro_torch.models.transformer import (
    MLP,
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


def n_groups(cfg) -> tuple[int, int]:
    g = cfg.n_layers // cfg.shared_attn_period
    return g, cfg.n_layers - g * cfg.shared_attn_period


def shared_head_dim(cfg) -> int:
    return 2 * cfg.d_model // cfg.n_heads


class SharedBlock(nn.Module):
    """The reference's ``init_shared_block`` dict: ``ln1``, ``attn`` (input
    and output width 2·d), ``ln2``, ``mlp`` and ``down`` ``(2d, d)``."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        d2 = 2 * cfg.d_model
        self.ln1 = _param(d2, device=device, dtype=dtype)
        self.attn = Attention(d2, cfg.n_heads, cfg.n_kv, shared_head_dim(cfg), d_in=d2,
                              device=device, dtype=dtype)
        self.ln2 = _param(d2, device=device, dtype=dtype)
        self.mlp = MLP(d2, cfg.d_ff, device=device, dtype=dtype)
        self.down = _param(d2, cfg.d_model, device=device, dtype=dtype)


class Hybrid(nn.Module):
    """The reference's parameter pytree as modules: ``embed``, ``groups``
    (``g`` lists of ``per`` Mamba-2 layers), ``shared``, ``final_norm``,
    ``lm_head`` and, when the period does not divide the depth, ``tail``."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        g, tail = n_groups(cfg)

        def layer():
            return MambaLayer(cfg, variant="mamba2", device=device, dtype=dtype)

        self.embed = _param(cfg.vocab, cfg.d_model, device=device, dtype=dtype)
        self.groups = nn.ModuleList(
            nn.ModuleList(layer() for _ in range(cfg.shared_attn_period)) for _ in range(g)
        )
        self.shared = SharedBlock(cfg, device=device, dtype=dtype)
        self.final_norm = _param(cfg.d_model, device=device, dtype=dtype)
        self.lm_head = _param(cfg.d_model, cfg.vocab, device=device, dtype=dtype)
        if tail:
            self.tail = nn.ModuleList(layer() for _ in range(tail))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def mamba_layers(self):
        """Every Mamba-2 layer in stack order: the groups', then the tail's."""
        for group in self.groups:
            yield from group
        yield from getattr(self, "tail", ())


def init_params(cfg, seed: int = 0, *, device=None, dtype=None) -> Hybrid:
    """Random init from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), the reference's ``init_params`` distributions."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Hybrid(cfg, device=device, dtype=dtype or compute_dtype(cfg))
    for lp in model.mamba_layers():
        init_mamba_layer(lp, gen)
    sp = model.shared
    init_attn(sp.attn, gen)
    with torch.no_grad():
        sp.ln1.fill_(1.0)
        sp.ln2.fill_(1.0)
        for w in (sp.mlp.w1, sp.mlp.w3, sp.mlp.w2, sp.down):
            w.copy_(dense_init(gen, *w.shape, device=device))
    return init_head(model, gen)


# -- shared attention block -------------------------------------------------


def _shared_mlp_down(sp: SharedBlock, x, h1, eps):
    """The block's second half: h1 + SwiGLU(norm(h1)), projected down and
    added to the residual x."""
    dt = x.dtype
    h2 = rmsnorm(h1, sp.ln2.to(dt), eps)
    m = sp.mlp
    h1 = h1 + swiglu(h2, m.w1.to(dt), m.w3.to(dt), m.w2.to(dt))
    return x + h1 @ sp.down.to(dt)


def shared_block_fwd(cfg, sp: SharedBlock, x, x0, positions):
    """Full sequence; returns (x', (k, v))."""
    h0 = torch.cat([x, x0], dim=-1)
    h = rmsnorm(h0, sp.ln1.to(x.dtype), cfg.rmsnorm_eps)
    q, k, v = qkv_project(sp.attn, h, shared_head_dim(cfg), positions,
                          theta=cfg.rope_theta)
    o = attention(q, k, v, causal=True, window=cfg.window,
                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    B, S = x.shape[:2]
    h1 = h0 + o.reshape(B, S, -1) @ sp.attn.wo.to(x.dtype)
    return _shared_mlp_down(sp, x, h1, cfg.rmsnorm_eps), (k, v)


def shared_block_decode(cfg, sp: SharedBlock, x, x0, k_cache, v_cache, length):
    """One token (B, 1, d) against one group's cache (written in place)."""
    h0 = torch.cat([x, x0], dim=-1)  # (B, 1, 2d)
    h = rmsnorm(h0, sp.ln1.to(x.dtype), cfg.rmsnorm_eps)
    B = x.shape[0]
    pos = torch.as_tensor(length, device=x.device).broadcast_to((B,))[:, None]
    q, k, v = qkv_project(sp.attn, h, shared_head_dim(cfg), pos,
                          theta=cfg.rope_theta)
    kvcache.cache_write_token(k_cache, v_cache, k, v, length)
    valid = torch.clamp(length + 1, max=k_cache.shape[1])
    o = decode_attention(q, k_cache, v_cache, valid)
    h1 = h0 + o.reshape(B, 1, -1) @ sp.attn.wo.to(x.dtype)
    return _shared_mlp_down(sp, x, h1, cfg.rmsnorm_eps)


# -- full model ---------------------------------------------------------------


def _mamba_fwd(cfg, lp: MambaLayer, x):
    """One residual Mamba-2 block; returns (x', its decode cache)."""
    lp = parallel.layer(lp)
    h = rmsnorm(x, lp.ln.to(x.dtype), cfg.rmsnorm_eps)
    y, c = ssm.mamba2_prefill(lp.mamba, h, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                              chunk=cfg.ssm_chunk)
    return x + y, c


def forward(cfg, params: Hybrid, batch):
    """Full-sequence forward to the final hidden states (B, S, d)."""
    x = embed_tokens(cfg, params, batch["tokens"])
    x0 = x
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).broadcast_to((B, S))
    # as the reference, the Mamba-2 blocks run under the remat policy and
    # the shared block does not, but where it is sharded: there each use
    # gathers it, and a remat body keeps the gathered copy from being saved
    mb = remat(cfg, lambda x, lp: _mamba_fwd(cfg, lp, x)[0])

    def shared_use(x, sp):
        return shared_block_fwd(cfg, parallel.layer(sp), x, x0, positions)[0]

    sb = remat(cfg, shared_use) if parallel.current() is not None else shared_use
    for group in params.groups:
        x = sb(x, params.shared)
        for lp in group:
            x = mb(x, lp)
    for lp in getattr(params, "tail", ()):
        x = mb(x, lp)
    return final_norm(cfg, params, x)


def loss_fn(cfg, params: Hybrid, batch):
    """Next-token CE over every position but the last."""
    targets, mask = next_token_targets(batch["tokens"])
    return ce_loss(cfg, forward(cfg, params, batch), params.lm_head, targets, mask)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    device = resolve_device(device)
    g, tail = n_groups(cfg)
    per = cfg.shared_attn_period
    di = cfg.ssm_expand * cfg.d_model
    H = di // cfg.ssm_head_dim
    conv_ch = di + 2 * cfg.ssm_state
    T = kvcache.attn_cache_len(max_len, cfg.decode_window or cfg.window)
    dtype = compute_dtype(cfg)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    cache = {
        "attn_k": zeros((g, batch, T, cfg.n_kv, shared_head_dim(cfg))),
        "attn_v": zeros((g, batch, T, cfg.n_kv, shared_head_dim(cfg))),
        "conv": zeros((g, per, batch, cfg.ssm_conv - 1, conv_ch)),
        "ssm": zeros((g, per, batch, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
        "len": zeros((batch,), torch.int64),
    }
    if tail:
        cache["conv_tail"] = zeros((tail, batch, cfg.ssm_conv - 1, conv_ch))
        cache["ssm_tail"] = zeros((tail, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                                  torch.float32)
    return cache


def prefill(cfg, params: Hybrid, batch, max_len: int):
    """Prompt pass writing each group's shared-attention KV and every
    layer's SSM states into a new cache; returns (cache, last logits)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    x0 = x
    positions = torch.arange(S, device=x.device).broadcast_to((B, S))
    cache = parallel.new_cache(lambda dev: init_cache(cfg, B, max_len, device=dev),
                               params.device)
    for gi, group in enumerate(params.groups):
        x, (k, v) = shared_block_fwd(cfg, parallel.layer(params.shared), x, x0, positions)
        kvcache.cache_write_prefill_layer(cache["attn_k"][gi], cache["attn_v"][gi],
                                          parallel.cache_part("attn_k", k),
                                          parallel.cache_part("attn_v", v))
        for j, lp in enumerate(group):
            x, c = _mamba_fwd(cfg, lp, x)
            parallel.cache_store(cache, "conv", (gi, j), c["conv"])
            parallel.cache_store(cache, "ssm", (gi, j), c["ssm"])
    for i, lp in enumerate(getattr(params, "tail", ())):
        x, c = _mamba_fwd(cfg, lp, x)
        parallel.cache_store(cache, "conv_tail", i, c["conv"])
        parallel.cache_store(cache, "ssm_tail", i, c["ssm"])
    cache["len"].fill_(S)
    x = final_norm(cfg, params, x)
    return cache, _logits(params, x[:, -1])


def _mamba_step(cfg, lp: MambaLayer, x, conv, state):
    """One token through a residual Mamba-2 block; its conv window and
    state are written in place."""
    lp = parallel.layer(lp)
    h = rmsnorm(x, lp.ln.to(x.dtype), cfg.rmsnorm_eps)
    c, y = ssm.mamba2_decode(lp.mamba, {"conv": conv, "ssm": state}, h[:, 0],
                             d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
    conv.copy_(c["conv"])
    state.copy_(c["ssm"])
    return x + y[:, None]


def decode_step(cfg, params: Hybrid, cache, tokens):
    """One decode step. tokens: (B, 1) -> (cache', logits (B, V)); every
    slot's clock advances."""
    x = embed_tokens(cfg, params, tokens)  # (B, 1, d)
    x0 = x
    length = cache["len"]

    def step(names, index, fn):
        """``fn`` on one layer of the cache leaves ``names`` (written in
        place), the rank's slice written back."""
        parts = [parallel.cache_layer(cache, n, index) for n in names]
        out = fn(*parts)
        for n, t in zip(names, parts):
            parallel.cache_store(cache, n, index, t)
        return out

    for gi, group in enumerate(params.groups):
        x = step(("attn_k", "attn_v"), gi, lambda k, v: shared_block_decode(
            cfg, parallel.layer(params.shared), x, x0, k, v, length))
        for j, lp in enumerate(group):
            x = step(("conv", "ssm"), (gi, j), lambda c, st: _mamba_step(cfg, lp, x, c, st))
    for i, lp in enumerate(getattr(params, "tail", ())):
        x = step(("conv_tail", "ssm_tail"), i, lambda c, st: _mamba_step(cfg, lp, x, c, st))
    x = final_norm(cfg, params, x)
    return dict(cache, len=length + 1), _logits(params, x[:, -1])
