"""Attention-free Mamba-1 LM (falcon-mamba family): serving and the training loss.

The counterpart of ``repro.models.ssm_model``: a stack of pre-norm
residual Mamba-1 blocks whose decode carries O(1) state per slot (a conv
window and an SSM state per layer), with no KV cache.  As in
:mod:`repro_torch.models.transformer`, one module per layer where the
reference stacks and scans; caches are written in place.

Sharded (:mod:`~repro_torch.models.parallel`): each layer's parameters
are gathered over the FSDP axes inside its body, and where ``model`` has
more than one rank the layer computes tensor-parallel on the rank's
``d_inner`` slice (:func:`_tp_plan`, :func:`~repro_torch.models.ssm.
mamba1_prefill`): prefill re-lays each layer's final state, ``(B,
d_inner/n, N)`` a rank, into the ``N``-sharded cache of ``cache_specs``
(one all-to-all), and decode updates the rank's ``N`` slice in place,
its conv window the rank's ``d_inner`` slice; nothing of the cache is
gathered.  Where the rules do not shard a leaf as that needs, the layer
is gathered whole (over ``model`` too) and every rank computes it, one
layer's states gathered over ``model`` at a time.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.core.relation import resolve_device
from repro_torch.models import parallel, ssm
from repro_torch.models.layers import rmsnorm
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


class MambaLayer(nn.Module):
    """``ln`` and ``mamba``, as the reference's layer dict; ``mamba`` is a
    :class:`~repro_torch.models.ssm.Mamba1` (``variant="mamba1"``) or a
    :class:`~repro_torch.models.ssm.Mamba2` (the hybrid's layers)."""

    def __init__(self, cfg, *, variant="mamba1", device=None, dtype=torch.float32):
        super().__init__()
        self.ln = _param(cfg.d_model, device=device, dtype=dtype)
        if variant == "mamba1":
            self.mamba = ssm.Mamba1(cfg.d_model, d_state=cfg.ssm_state, expand=cfg.ssm_expand,
                                    conv=cfg.ssm_conv, device=device, dtype=dtype)
        else:
            self.mamba = ssm.Mamba2(cfg.d_model, d_state=cfg.ssm_state,
                                    head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                                    conv=cfg.ssm_conv, device=device, dtype=dtype)


def init_mamba_layer(lp: MambaLayer, gen: torch.Generator) -> MambaLayer:
    with torch.no_grad():
        lp.ln.fill_(1.0)
    if isinstance(lp.mamba, ssm.Mamba1):
        ssm.init_mamba1(lp.mamba, gen)
    else:
        ssm.init_mamba2(lp.mamba, gen)
    return lp


class SSMModel(nn.Module):
    """The reference's parameter pytree as modules: ``embed`` ``(V, d)``,
    ``layers``, ``final_norm`` and ``lm_head`` ``(d, V)``."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(cfg.vocab, cfg.d_model, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            MambaLayer(cfg, device=device, dtype=dtype) for _ in range(cfg.n_layers)
        )
        self.final_norm = _param(cfg.d_model, device=device, dtype=dtype)
        self.lm_head = _param(cfg.d_model, cfg.vocab, device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, seed: int = 0, *, device=None, dtype=None) -> SSMModel:
    """Random init from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), the reference's ``init_params`` distributions;
    stored in ``dtype`` (default ``cfg.dtype``) apart from the float32
    ``A_log`` and ``dt_bias``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = SSMModel(cfg, device=device, dtype=dtype or compute_dtype(cfg))
    for lp in model.layers:
        init_mamba_layer(lp, gen)
    return init_head(model, gen)


_D_INNER = {"in_proj": -1, "x_proj": -1, "dt_proj": -1, "conv_b": -1, "dt_bias": -1, "D": -1,
            "out_proj": -2, "conv_w": -2, "A_log": -2}  # where ``model`` splits each leaf


def _tp_plan(lp: MambaLayer, *, serve: bool):
    """How Mamba-1 layer ``lp`` (DTensor parameters) computes tensor-parallel
    in the open sharded context: ``tp`` and the ``model`` modes of its
    parameters, or None where it cannot (no context, one ``model`` rank,
    a leaf that ``model`` does not split on the dim of :data:`_D_INNER`, or
    in serving a conv window not split on ``d_inner`` or a state not split
    on ``N``)."""
    def make(s):
        m = lp.mamba
        modes = parallel.local_modes(s, {f"mamba.{k}": (getattr(m, k), d)
                                         for k, d in _D_INNER.items()})
        if modes is None or serve and (s.cache_dims.get("conv"), s.cache_dims.get("ssm")) \
                != (-1, -1):
            return None
        return SimpleNamespace(tp=s.tp, modes=modes)

    return parallel.plan(lp, serve, make)


def _layer(lp: MambaLayer, *, serve: bool):
    """(``lp``'s parameters as this rank computes with them, ``tp`` or None)."""
    plan = _tp_plan(lp, serve=serve)
    return parallel.layer(lp, plan and plan.modes), plan and plan.tp


def forward(cfg, params: SSMModel, batch):
    """Full-sequence forward to the final hidden states (B, S, d)."""
    x = embed_tokens(cfg, params, batch["tokens"])

    def body(x, lp):
        lp, tp = _layer(lp, serve=False)
        h = rmsnorm(x, lp.ln.to(x.dtype), cfg.rmsnorm_eps)
        return x + ssm.mamba1(lp.mamba, h, d_state=cfg.ssm_state, chunk=cfg.ssm_chunk, tp=tp)

    body = remat(cfg, body)
    for lp in params.layers:
        x = body(x, lp)
    return final_norm(cfg, params, x)


def loss_fn(cfg, params: SSMModel, batch):
    """Next-token CE over every position but the last."""
    targets, mask = next_token_targets(batch["tokens"])
    return ce_loss(cfg, forward(cfg, params, batch), params.lm_head, targets, mask)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    """SSM state only, independent of ``max_len``: per layer a conv window
    (``cfg.dtype``) and an SSM state (float32), and the per-slot clock."""
    device = resolve_device(device)
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, di),
                            dtype=compute_dtype(cfg), device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, di, cfg.ssm_state), dtype=torch.float32,
                           device=device),
        "len": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


def prefill(cfg, params: SSMModel, batch, max_len: int):
    """Prompt scan (chunked, not per token) to the final states; returns
    (cache, last-token logits).  The conv state is the *pre-conv* window."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    cache = parallel.new_cache(lambda dev: init_cache(cfg, B, max_len, device=dev),
                               params.device)
    for i, lp in enumerate(params.layers):
        lp, tp = _layer(lp, serve=True)
        h = rmsnorm(x, lp.ln.to(x.dtype), cfg.rmsnorm_eps)
        y, c = ssm.mamba1_prefill(lp.mamba, h, d_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
                                  tp=tp)
        x = x + y
        if tp is not None:  # the rank's d_inner slice; its state re-laid onto its N slice
            c["ssm"] = parallel.reshard(c["ssm"], -2, -1, tp)
        for k in ("conv", "ssm"):
            parallel.cache_store(cache, k, i, c[k], part=tp is not None)
    cache["len"].fill_(S)
    x = final_norm(cfg, params, x)
    return cache, _logits(params, x[:, -1])


def decode_step(cfg, params: SSMModel, cache, tokens):
    """One token per slot. tokens: (B, 1) -> (cache', logits (B, V)); the
    states are written in place and every slot's clock advances."""
    xt = embed_tokens(cfg, params, tokens[:, 0])
    for i, lp in enumerate(params.layers):
        lp, tp = _layer(lp, serve=True)
        h = rmsnorm(xt, lp.ln.to(xt.dtype), cfg.rmsnorm_eps)
        state = {k: cache[k][i] if tp else parallel.cache_layer(cache, k, i)
                 for k in ("conv", "ssm")}
        c, y = ssm.mamba1_decode(lp.mamba, state, h, d_state=cfg.ssm_state, tp=tp)
        xt = xt + y
        for k in ("conv", "ssm"):
            parallel.cache_store(cache, k, i, c[k], part=tp is not None)
    xt = final_norm(cfg, params, xt)
    return {"conv": cache["conv"], "ssm": cache["ssm"], "len": cache["len"] + 1}, \
        _logits(params, xt)
