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
parameters are gathered over the FSDP axes inside its body, and the
shared block's at each of its uses, so no rank holds more than one
layer's gathered weights; under autograd each use then runs in a remat
body too (its recompute gathers again, and its gradient is
reduce-scattered use by use).  Where ``model`` has more than one rank,
each Mamba-2 layer computes the rank's heads (:func:`_mamba_plan`,
:func:`~repro_torch.models.ssm.mamba2_prefill`) and the shared block is
the transformer's layer body at width 2·d with its plan
(:func:`transformer._tp_plan <repro_torch.models.transformer._tp_plan>`:
the rank's heads and ``d_ff`` slice, its ``down`` rows summed over
``model``).  The SSM states stay ``N``-sharded, the KV caches
``head_dim``-sharded, as ``cache_specs`` places them; only the small conv
windows, split in blocks that do not follow the heads, are gathered over
``model``, one layer at a time.  Where the rules do not shard a leaf as
that needs, the layer (or the block) is gathered whole over ``model`` too
and every rank computes it, one layer's cache gathered at a time.
"""
from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.core.relation import resolve_device
from repro_torch.models import kvcache, parallel, ssm
from repro_torch.models.layers import Attention, dense_init, init_attn, rmsnorm
from repro_torch.models.ssm_model import MambaLayer, init_mamba_layer
from repro_torch.models.transformer import (
    MLP,
    _logits,
    _param,
    _tp_plan,
    ce_loss,
    compute_dtype,
    embed_tokens,
    final_norm,
    init_head,
    layer_decode,
    layer_fwd,
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


def _shared_cfg(cfg):
    """``cfg`` as the transformer's layer body reads it for the shared
    block: heads of width 2·d / ``n_heads``."""
    return replace(cfg, head_dim=shared_head_dim(cfg))


def _shared_plan(cfg, sp: SharedBlock, *, decode: bool):
    """The shared block's tensor-parallel plan (``transformer._tp_plan``
    at width 2·d, ``down`` row-parallel; KV leaves ``attn_k``/``attn_v``),
    or None."""
    return _tp_plan(_shared_cfg(cfg), sp, decode=decode, kv=("attn_k", "attn_v"))


def _down(sp: SharedBlock, x, h1, tp):
    """x + h1 @ ``down``; with ``tp``, ``sp.down`` is the rank's row block:
    the rank's columns of h1 through it, summed over ``model``."""
    h1 = parallel.part_last(parallel.enter(h1, tp), tp)
    return x + parallel.reduce(h1 @ sp.down.to(x.dtype), tp)


def shared_block_fwd(cfg, sp: SharedBlock, x, x0, positions, plan=None):
    """Full sequence; returns (x', (k, v)): the transformer's layer body on
    ``concat(x, x0)`` at width 2·d (tensor-parallel with ``plan``), then
    ``down`` to d and the residual."""
    h1, kv = layer_fwd(_shared_cfg(cfg), sp, torch.cat([x, x0], dim=-1), positions, plan)
    return _down(sp, x, h1, plan and plan.tp), kv


def shared_block_decode(cfg, sp: SharedBlock, x, x0, k_cache, v_cache, length, tp=None):
    """One token (B, 1, d) against one group's cache (written in place)."""
    h1, _, _ = layer_decode(_shared_cfg(cfg), sp, torch.cat([x, x0], dim=-1), k_cache, v_cache,
                            length, tp)
    return _down(sp, x, h1, tp)


# -- full model ---------------------------------------------------------------

_HEADS = {"in_proj": -1, "D": -1, "dt_bias": -1, "norm_w": -1, "out_proj": -2}  # split by model


def _mamba_plan(lp: MambaLayer, ssm_leaf: str | None):
    """How Mamba-2 layer ``lp`` computes tensor-parallel on the rank's heads
    in the open sharded context: ``tp`` and its parameters' ``model``
    modes (``conv_w``, ``conv_b`` and ``A_log`` gathered whole, the rank
    picking its channels), or None where ``model`` does not split a leaf
    of :data:`_HEADS` so, or in serving its state leaf ``ssm_leaf`` on
    ``N``."""
    def make(s):
        m = lp.mamba
        modes = parallel.local_modes(s, {f"mamba.{k}": (getattr(m, k), d)
                                         for k, d in _HEADS.items()})
        if modes is None or ssm_leaf and s.cache_dims.get(ssm_leaf) != -1:
            return None
        modes.update({"mamba.conv_w": "sum", "mamba.conv_b": "sum", "mamba.A_log": "sum"})
        return SimpleNamespace(tp=s.tp, modes=modes)

    return parallel.plan(lp, ssm_leaf, make)


def _mamba_fwd(cfg, lp: MambaLayer, x, ssm_leaf=None):
    """One residual Mamba-2 block; returns (x', its decode cache, ``tp``)."""
    plan = _mamba_plan(lp, ssm_leaf)
    tp = plan and plan.tp
    lp = parallel.layer(lp, plan and plan.modes)
    h = rmsnorm(x, lp.ln.to(x.dtype), cfg.rmsnorm_eps)
    y, c = ssm.mamba2_prefill(lp.mamba, h, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                              chunk=cfg.ssm_chunk, tp=tp)
    return x + y, c, tp


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
        plan = _shared_plan(cfg, sp, decode=False)
        return shared_block_fwd(cfg, parallel.layer(sp, plan and plan.modes), x, x0, positions,
                                plan)[0]

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


def _store_state(cfg, cache, names, index, c, tp):
    """A Mamba-2 layer's (conv window, state) ``c`` into cache leaves
    ``names`` at ``index``: the rank's slices (the window of its channels
    made whole over ``model`` first)."""
    conv, state = names
    parallel.cache_store(cache, conv, index, ssm.mamba2_conv_whole(c["conv"], cfg.ssm_state, tp))
    parallel.cache_store(cache, state, index, c["ssm"], part=tp is not None)


def prefill(cfg, params: Hybrid, batch, max_len: int):
    """Prompt pass writing each group's shared-attention KV and every
    layer's SSM states into a new cache; returns (cache, last logits).
    Sharded, each Mamba-2 layer's final state, of the rank's heads, is
    re-laid onto the ``N``-sharded cache (one all-to-all), and the shared
    block's K and V, of the rank's heads, onto the ``head_dim``-sharded one."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    x0 = x
    positions = torch.arange(S, device=x.device).broadcast_to((B, S))
    cache = parallel.new_cache(lambda dev: init_cache(cfg, B, max_len, device=dev),
                               params.device)

    def layers(lps, names, index):
        nonlocal x
        for j, lp in enumerate(lps):
            x, c, tp = _mamba_fwd(cfg, lp, x, names[1])
            if tp is not None:
                c = dict(c, ssm=parallel.reshard(c["ssm"], -3, -1, tp))
            _store_state(cfg, cache, names, index(j), c, tp)

    for gi, group in enumerate(params.groups):
        plan = _shared_plan(cfg, params.shared, decode=False)
        x, (k, v) = shared_block_fwd(cfg, parallel.layer(params.shared, plan and plan.modes),
                                     x, x0, positions, plan)
        tp = plan.tp if plan is not None and plan.kv_local else None  # K, V of its heads
        kvcache.cache_write_prefill_layer(cache["attn_k"][gi], cache["attn_v"][gi],
                                          parallel.heads_part("attn_k", k, tp),
                                          parallel.heads_part("attn_v", v, tp))
        layers(group, ("conv", "ssm"), lambda j: (gi, j))
    layers(getattr(params, "tail", ()), ("conv_tail", "ssm_tail"), lambda i: i)
    cache["len"].fill_(S)
    x = final_norm(cfg, params, x)
    return cache, _logits(params, x[:, -1])


def _mamba_step(cfg, lp: MambaLayer, x, cache, names, index):
    """One token through a residual Mamba-2 block; its conv window and
    state are written in place (sharded: the rank's slices; tensor-parallel,
    the conv window gathered over ``model`` and the rank's ``N`` slice of
    the state updated where it is)."""
    plan = _mamba_plan(lp, names[1])
    tp = plan and plan.tp
    lp = parallel.layer(lp, plan and plan.modes)
    conv = parallel.cache_layer(cache, names[0], index)
    state = cache[names[1]][index] if tp else parallel.cache_layer(cache, names[1], index)
    h = rmsnorm(x, lp.ln.to(x.dtype), cfg.rmsnorm_eps)
    c, y = ssm.mamba2_decode(lp.mamba, {"conv": ssm.mamba2_conv_part(conv, cfg.ssm_state, tp),
                                        "ssm": state}, h[:, 0],
                             d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, tp=tp)
    _store_state(cfg, cache, names, index, c, tp)
    return x + y[:, None]


def decode_step(cfg, params: Hybrid, cache, tokens):
    """One decode step. tokens: (B, 1) -> (cache', logits (B, V)); every
    slot's clock advances."""
    x = embed_tokens(cfg, params, tokens)  # (B, 1, d)
    x0 = x
    length = cache["len"]
    for gi, group in enumerate(params.groups):
        plan = _shared_plan(cfg, params.shared, decode=True)
        sp = parallel.layer(params.shared, plan and plan.modes)
        if plan is not None:
            x = shared_block_decode(cfg, sp, x, x0, cache["attn_k"][gi], cache["attn_v"][gi],
                                    length, plan.tp)
        else:
            k, v = (parallel.cache_layer(cache, n, gi) for n in ("attn_k", "attn_v"))
            x = shared_block_decode(cfg, sp, x, x0, k, v, length)
            parallel.cache_store(cache, "attn_k", gi, k)
            parallel.cache_store(cache, "attn_v", gi, v)
        for j, lp in enumerate(group):
            x = _mamba_step(cfg, lp, x, cache, ("conv", "ssm"), (gi, j))
    for i, lp in enumerate(getattr(params, "tail", ())):
        x = _mamba_step(cfg, lp, x, cache, ("conv_tail", "ssm_tail"), i)
    x = final_norm(cfg, params, x)
    return dict(cache, len=length + 1), _logits(params, x[:, -1])
