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

Sharded (a module of DTensor parameters inside a
:class:`~repro_torch.models.parallel.Shards` context): each layer's
parameters are gathered over the FSDP axes inside its (remat) body, and
where ``model`` has more than one rank the same layer bodies compute
tensor-parallel (:func:`_tp_plan`; the ``parallel`` helpers they call are
identities otherwise): the rank's q heads and ``d_ff`` slice (its column
blocks of ``wq``, ``w1``, ``w3`` and of each MoE expert), K and V
all-gathered from the column blocks where those are not whole KV heads,
the row-parallel ``wo`` and ``w2`` summed over ``model``; the vocabulary
is split the same way for the embedding, the cross-entropy and the
logits.  Where a rank's ``wq`` columns are not whole heads (24 heads on
16 ranks), ``wq``, ``bq`` and ``wo`` are gathered over ``model`` for that
layer and the rank computes heads ``⌊r·H/16⌋`` to ``⌊(r+1)·H/16⌋``.
Decode reads the cache in ``cache_specs``' layout, each rank its slice of
every head's ``head_dim``, the partial scores all-reduced
(:func:`~repro_torch.models.layers.decode_attention`).
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.relation import resolve_device
from repro_torch.models import kvcache, moe, parallel
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


def layer_fwd(cfg, lp: DecoderLayer, x, positions, plan=None):
    """Full-sequence layer (train / prefill). Returns (x', (k, v)).

    Tensor-parallel with a ``plan`` (:func:`_tp_plan`; ``lp`` then holds
    the rank's column blocks of ``wq wk wv w1 w3`` and row blocks of ``wo
    w2``): the rank's q heads ``plan.q`` against the KV heads they read,
    its ``d_ff`` slice, the partial outputs summed over ``model``; (k, v)
    are the KV heads the rank computed (every head unless
    ``plan.kv_local``)."""
    tp = None if plan is None else plan.tp
    dt = x.dtype
    B, S, _ = x.shape
    a = lp.attn
    wq, bq, wo = a.wq, getattr(a, "bq", None), a.wo
    whole = None
    if tp is not None:
        if not plan.whole:  # the rank's columns split a head: its heads from the whole
            D = cfg.head_dim
            lo, hi = plan.q
            wq, wo = wq[:, lo * D:hi * D], wo[lo * D:hi * D]
            bq = None if bq is None else bq[lo * D:hi * D]
        if not plan.kv_local:  # every head's K and V; the rank's q heads read some
            def whole(q, k, v):
                return q, parallel.gather_last(k, tp), parallel.gather_last(v, tp)
    h = parallel.enter(rmsnorm(x, lp.ln1.to(dt), cfg.rmsnorm_eps), tp)
    q, k, v = qkv_project(a, h, cfg.head_dim, positions, theta=cfg.rope_theta,
                          qk_norm=cfg.qk_norm, wq=wq, bq=bq, whole=whole)
    ka, va = k, v
    if whole is not None:
        k_lo, k_hi, idx = parallel.gqa_heads(*plan.q, cfg.n_heads, cfg.n_kv)
        ka, va = k[:, :, k_lo:k_hi], v[:, :, k_lo:k_hi]
        if idx is not None:
            ka, va = ka[:, :, idx], va[:, :, idx]
    o = attention(
        q, ka, va, causal=True, window=cfg.window,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
    )
    x = x + parallel.reduce(o.reshape(B, S, -1) @ wo.to(dt), tp)
    h = parallel.enter(rmsnorm(x, lp.ln2.to(dt), cfg.rmsnorm_eps), tp)
    x = x + parallel.reduce(_ffn(cfg, lp, h), tp)
    return x, (k, v)


def layer_decode(cfg, lp: DecoderLayer, x, k_cache, v_cache, length, tp=None):
    """One-token layer against a cache (written in place). x: (B, 1, d).

    Tensor-parallel over ``tp`` (``lp`` holding the rank's column and row
    blocks, the caches its part of every head's ``head_dim``): q, k and v
    from the column blocks all-gathered, the new token's part written, the
    partial scores summed (:func:`~repro_torch.models.layers.
    decode_attention`), the output's row block through the rank's ``wo``
    rows and the partial sums summed."""
    n, r = (1, 0) if tp is None else (tp.size, tp.rank)
    dt = x.dtype
    B = x.shape[0]
    h = rmsnorm(x, lp.ln1.to(dt), cfg.rmsnorm_eps)
    pos = torch.as_tensor(length, device=x.device).broadcast_to((B,))[:, None]
    whole = None if tp is None else (
        lambda *qkv: [parallel.gather_last(t, tp) for t in qkv])
    q, k, v = qkv_project(lp.attn, h, cfg.head_dim, pos, theta=cfg.rope_theta,
                          qk_norm=cfg.qk_norm, whole=whole)
    D = cfg.head_dim // n
    k_cache, v_cache = kvcache.cache_write_token(k_cache, v_cache, k[..., r * D:(r + 1) * D],
                                                 v[..., r * D:(r + 1) * D], length)
    T = k_cache.shape[1]
    valid = torch.clamp(length + 1, max=T)
    o = decode_attention(q, k_cache, v_cache, valid, tp).reshape(B, 1, -1)
    rows = o.shape[-1] // n
    x = x + parallel.reduce(o[..., r * rows:(r + 1) * rows] @ lp.attn.wo.to(dt), tp)
    h = rmsnorm(x, lp.ln2.to(dt), cfg.rmsnorm_eps)
    x = x + parallel.reduce(_ffn(cfg, lp, h), tp)
    return x, k_cache, v_cache


# --------------------------------------------------------------------------
# Tensor parallelism over ``model``
# --------------------------------------------------------------------------


def _tp_plan(cfg, lp: DecoderLayer, *, decode: bool, kv=("k", "v")):
    """How layer ``lp`` (DTensor parameters) computes tensor-parallel in
    the open sharded context, or None where it cannot: no context, one
    ``model`` rank, fewer q heads than ranks, a projection that ``model``
    does not shard on its column (``wq wk wv w1 w3``, the biases) or row
    (``wo w2``, the hybrid shared block's ``down``) dim, or in decode a KV
    cache (leaves ``kv``) whose ``head_dim`` it does not shard.  The layer
    then runs every head on every rank, its weights gathered over
    ``model`` too."""
    return parallel.plan(lp, decode, lambda s: _make_tp_plan(cfg, lp, s, decode, kv))


def _make_tp_plan(cfg, lp, s, decode: bool, kv):
    a = lp.attn
    pre = "moe" if cfg.family == "moe" else "mlp"
    ffn = getattr(lp, pre)
    want = {f"attn.{n}": (getattr(a, n), -1) for n in ("wq", "wk", "wv", "bq", "bk", "bv")
            if hasattr(a, n)}
    want.update({f"{pre}.w1": (ffn.w1, -1), f"{pre}.w3": (ffn.w3, -1),
                 "attn.wo": (a.wo, -2), f"{pre}.w2": (ffn.w2, -2)})
    if hasattr(lp, "down"):
        want["down"] = (lp.down, -2)
    modes = parallel.local_modes(s, want)
    if cfg.n_heads < s.nm or modes is None:
        return None
    if decode and any(s.cache_dims.get(k) != -1 for k in kv):
        return None
    # replicated over ``model`` and used on the rank's part only
    modes.update({"attn.q_norm": "sum", "attn.k_norm": "sum", "moe.router": "sum"})
    whole = cfg.n_heads % s.nm == 0
    if not (decode or whole):  # the rank's columns split a head: its heads from the whole
        modes.update({"attn.wq": "sum", "attn.bq": "sum", "attn.wo": "sum"})
    return SimpleNamespace(tp=s.tp, modes=modes, q=parallel.head_range(cfg.n_heads, s.tp),
                           whole=whole, kv_local=whole and cfg.n_kv % s.nm == 0)


def _layer_fwd_at(cfg, lp: DecoderLayer, x, positions, collect_kv: bool = False):
    """:func:`layer_fwd` on layer module ``lp`` as it is placed: its
    parameters gathered for this rank (tensor-parallel where
    :func:`_tp_plan` allows); with ``collect_kv`` (k, v) of every KV head."""
    plan = _tp_plan(cfg, lp, decode=False)
    x, (k, v) = layer_fwd(cfg, parallel.layer(lp, plan and plan.modes), x, positions, plan)
    if collect_kv and plan is not None and plan.kv_local:
        with torch.no_grad():
            k, v = (parallel.gather_last(t.flatten(2), plan.tp).unflatten(2, (-1, cfg.head_dim))
                    for t in (k, v))
    return x, (k, v)


def _layer_decode_at(cfg, lp: DecoderLayer, x, cache, i: int, length):
    """:func:`layer_decode` of layer ``i`` (module ``lp``) as it is placed,
    against ``cache`` (written in place); returns x'."""
    plan = _tp_plan(cfg, lp, decode=True)
    if plan is not None:
        return layer_decode(cfg, parallel.layer(lp, plan.modes), x, cache["k"][i],
                            cache["v"][i], length, plan.tp)[0]
    kc, vc = parallel.cache_layer(cache, "k", i), parallel.cache_layer(cache, "v", i)
    x, kc, vc = layer_decode(cfg, parallel.layer(lp), x, kc, vc, length)
    parallel.cache_store(cache, "k", i, kc)
    parallel.cache_store(cache, "v", i, vc)
    return x


# --------------------------------------------------------------------------
# Forward passes
# --------------------------------------------------------------------------


def embed_tokens(cfg, params, tokens):
    """``params.embed[tokens]`` in the compute dtype (the reference casts
    the table, then gathers: the same values).  Tokens may be int32 (the
    reference's type); they are indexed as int64.  Sharded: a
    vocabulary-parallel lookup where ``model`` shards the table's rows,
    else the table gathered."""
    tp = parallel.vocab_tp(params.embed, -2)
    table = parallel.param(params.embed, "local" if tp else "same")
    x = parallel.embed_lookup(table, tokens.long(), tp)
    return x.to(compute_dtype(cfg))


def final_norm(cfg, params, x, name: str = "final_norm"):
    """RMSNorm of ``x`` with the model's ``name`` weight."""
    return rmsnorm(x, parallel.param(getattr(params, name)).to(x.dtype), cfg.rmsnorm_eps)


def embed_inputs(cfg, params: Transformer, batch):
    """Token embeddings, with stub-frontend embeddings prepended when the
    batch carries ``embeds``."""
    dtype = compute_dtype(cfg)
    x = embed_tokens(cfg, params, batch["tokens"])
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


def forward(cfg, params: Transformer, batch, *, collect_kv: bool = False, on_kv=None):
    """Full-sequence forward to final hidden states.

    Returns (hidden (B,S,d), n_prefix, kv or None), kv as layer-stacked
    ``(k, v)`` of shape (L, B, S, Hkv, D) with ``collect_kv``; with
    ``on_kv``, ``on_kv(i, k, v)`` is called with each layer's instead."""
    x, n_prefix = embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).broadcast_to((B, S))
    # prefill collects each layer's K/V and runs without autograd, where
    # ``remat`` returns the body as it is
    keep = collect_kv or on_kv is not None
    body = remat(cfg, lambda x, lp: _layer_fwd_at(cfg, lp, x, positions, keep))
    ks, vs = [], []
    for i, lp in enumerate(params.layers):
        x, kv = body(x, lp)
        if on_kv is not None:
            on_kv(i, *kv)
        elif collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    x = final_norm(cfg, params, x)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, n_prefix, kvs


class _ChunkedCE(torch.autograd.Function):
    """Masked mean next-token cross-entropy of ``hidden @ lm_head``, chunk by
    chunk along the sequence: the forward keeps each position's float32
    log-sum-exp, the backward recomputes each chunk's logits, so no more
    than one chunk's ``(B, chunk, V)`` logits are ever live.

    Vocabulary-parallel with ``tp`` (``lm_head`` the rank's column block):
    the row max and the sum of exponentials are all-reduced into the
    log-sum-exp, the target's logit comes from the rank whose block holds
    it; ``dw`` stays on the rank's block and the partial ``dh`` is
    all-reduced."""

    @staticmethod
    def forward(ctx, hidden, lm_head, targets, mask, chunk, tp=None):
        S = hidden.shape[1]
        w = lm_head.to(hidden.dtype)
        V = w.shape[1]
        targets = targets - (0 if tp is None else tp.rank * V)
        hit = (targets >= 0) & (targets < V)  # the targets in this rank's columns
        targets = targets.clamp(0, V - 1)
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        lses = []
        for lo in range(0, S, chunk):
            logits = (hidden[:, lo:lo + chunk] @ w).to(torch.float32)
            m = parallel.all_reduce(logits.amax(-1), tp, dist.ReduceOp.MAX)
            lse = m + torch.log(parallel.all_reduce(torch.exp(logits - m[..., None]).sum(-1), tp))
            tgt = logits.gather(-1, targets[:, lo:lo + chunk, None])[..., 0]
            tgt = parallel.all_reduce(torch.where(hit[:, lo:lo + chunk], tgt, 0.0), tp)
            tot += ((lse - tgt) * mask[:, lo:lo + chunk]).sum()
            lses.append(lse)
            del logits
        cnt = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(hidden, lm_head, targets, hit, mask, torch.cat(lses, 1), cnt)
        ctx.chunk, ctx.tp = chunk, tp
        return tot / cnt

    @staticmethod
    def backward(ctx, g):
        hidden, lm_head, targets, hit, mask, lse, cnt = ctx.saved_tensors
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
                           -hit[:, lo:lo + chunk, None].to(p.dtype))
            p *= coef[:, lo:lo + chunk, None]
            dl = p.to(hidden.dtype)
            del p
            dh[:, lo:lo + chunk] = dl @ w.T
            dw += (xc.reshape(-1, d).T @ dl.reshape(-1, dl.shape[-1])).to(torch.float32)
        parallel.all_reduce(dh, ctx.tp)
        return dh, dw.to(lm_head.dtype), None, None, None, None


def ce_loss(cfg, hidden, lm_head, targets, mask):
    """Chunked cross-entropy; never materializes (B, S, V).

    The reference's ``ce_loss``: logits ``hidden @ lm_head`` in
    ``hidden.dtype``, then float32; the loss is ``sum((lse - logit[target])
    * mask) / max(sum(mask), 1)``.  The reference takes chunks of the
    largest divisor of S that is ≤ ``cfg.ce_chunk``; the port takes chunks
    of ``cfg.ce_chunk`` and a shorter last one (the same sum in another
    order).  Sharded: vocabulary-parallel where ``model`` shards
    ``lm_head``'s columns, else from ``lm_head`` gathered."""
    chunk = min(cfg.ce_chunk, hidden.shape[1])
    tp = parallel.vocab_tp(lm_head, -1)
    return _ChunkedCE.apply(hidden, parallel.param(lm_head, "local" if tp else "same"),
                            targets.long(), mask.to(torch.float32), chunk, tp)


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
    """The reference's ``h @ lm_head.astype(h.dtype)``, then float32
    (sharded: vocabulary-parallel, all-gathered)."""
    tp = parallel.vocab_tp(params.lm_head, -1)
    w = parallel.param(params.lm_head, "local" if tp else "same")
    return parallel.gather_last((h @ w.to(h.dtype)).to(torch.float32), tp)


def prefill(cfg, params: Transformer, batch, max_len: int):
    """Encode the prompt; returns (cache, last-token logits).  Each layer's
    K and V are written as the layer ends (sharded: the rank's slice)."""
    B = batch["tokens"].shape[0]
    cache = parallel.new_cache(lambda dev: init_cache(cfg, B, max_len, device=dev),
                               params.device)

    def keep(i, k, v):
        kvcache.cache_write_prefill_layer(cache["k"][i], cache["v"][i],
                                          parallel.cache_part("k", k),
                                          parallel.cache_part("v", v))

    hidden, _, _ = forward(cfg, params, batch, on_kv=keep)
    cache["len"] = torch.full((B,), hidden.shape[1], dtype=torch.int64, device=hidden.device)
    return cache, _logits(params, hidden[:, -1])


def decode_step(cfg, params: Transformer, cache, tokens):
    """One decode step. tokens: (B, 1) -> (cache', logits (B, V)).

    Every slot's clock advances, active or not, as in the reference.  The
    returned cache holds the same ``k``/``v`` tensors, written in place, and
    a new ``len``."""
    x = embed_tokens(cfg, params, tokens)
    length = cache["len"]
    for i, lp in enumerate(params.layers):
        x = _layer_decode_at(cfg, lp, x, cache, i, length)
    x = final_norm(cfg, params, x)
    logits = _logits(params, x[:, -1])
    return {"k": cache["k"], "v": cache["v"], "len": length + 1}, logits
