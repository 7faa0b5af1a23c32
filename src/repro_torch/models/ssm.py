"""State-space sequence layers: Mamba-1 (selective scan) and Mamba-2 (SSD).

The counterpart of ``repro.models.ssm``; autograd differentiates the
blocks (the reference has no custom backward here).  Both blocks expose
a one-token ``*_decode`` step carrying (conv window, SSM state): O(1)
per token, with no KV cache.

Where the port parts from the reference:

* **Chunks.** The reference takes chunks of the largest divisor of S that
  is ≤ ``chunk`` (``_fit_chunk``: 1 for a prime S, so S sequential steps
  per layer).  The port pads S up to whole chunks of ``min(chunk, S)``
  with ``dt = 0`` rows, where ``exp(dt·A) = 1`` and ``dt·x·B = 0``: the
  state passes a padded row unchanged, so the state after the last padded
  row is the state after row S-1, and the padded outputs are dropped.
* **Every chunk at once.** Torch has no ``associative_scan``.  Mamba-1
  runs the recurrence inside all chunks together, one fused multiply-add
  per position of a chunk (``chunk`` steps, each over every chunk), takes
  each prefix's product of ``dA`` as ``exp(A · cumsum(dt))``, then carries
  the state across chunks in a loop of ``S / chunk`` small steps; Mamba-2's
  intra-chunk terms and per-chunk states are batched over the chunks the
  same way.  The functions are the reference's; only the order and
  rounding of the arithmetic differ.

Casts follow the reference: projections in ``x.dtype``, ``dt`` softplus in
float32 plus ``dt_bias``, states float32, ``y + x·D`` in ``x.dtype``.
``A_log`` and ``dt_bias`` enter float32 arithmetic uncast in the
reference, so the modules keep them in float32 whatever the model's dtype.
A float64 model (a reference for float32 runs) keeps float64 throughout.

Tensor-parallel over ``model`` with a ``tp`` (``models.parallel.TP``;
the ``parallel`` helpers are identities without one, so one body serves
both cases).  Mamba-1 splits ``d_inner``: the block's parameters are the
rank's ``d_inner`` slices (``in_proj``'s block of ``[x | z]`` columns
re-laid into the rank's ``x`` and ``z`` columns by one all-to-all,
``x_proj``'s column block into its row block), ``x_proj``'s partial sums
and the row-parallel ``out_proj``'s are summed over ``model``.  Mamba-2
splits the heads: ``in_proj``'s columns re-laid into the rank's ``z``,
``x`` and ``dt`` heads and all of ``B`` and ``C``, ``conv_w``/``conv_b``
and ``A_log`` given whole (the rank picks its channels), the gated norm's
sum of squares summed over ``model``.  Decode keeps the SSM state
``N``-sharded (``cache_specs``): each rank updates its ``N`` slice of
every channel from the all-gathered ``x`` and ``dt`` rows, and ``y``'s
partial sums over ``N`` are reduce-scattered to the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import parallel
from repro_torch.models.layers import dense_init, rmsnorm


def causal_conv1d(x, w, b=None):
    """Depthwise causal conv. x: (B, S, C); w: (C, W)."""
    S, W = x.shape[1], w.shape[-1]
    acc = x * w[:, W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        acc = acc + shifted * w[:, W - 1 - i]
    if b is not None:
        acc = acc + b
    return acc


def conv_step(state, xt, w, b=None):
    """One-token causal conv. state: (B, W-1, C); xt: (B, C)."""
    window = torch.cat([state, xt[:, None]], dim=1)  # (B, W, C)
    y = torch.einsum("bwc,cw->bc", window, w)
    if b is not None:
        y = y + b
    return window[:, 1:], y


def _conv_window(xs, W: int):
    """The last W-1 positions of the pre-conv input (B, S, C), zero-padded
    in front when S < W-1: the decode's conv state after a prompt."""
    S = xs.shape[1]
    if S >= W - 1:
        return xs[:, S - (W - 1):]
    return F.pad(xs, (0, 0, W - 1 - S, 0))


def _wide(dtype):
    """float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _f32(t):
    """``t`` in float32, or in float64 if it is float64."""
    return t.to(_wide(t.dtype))


def _chunks(S: int, chunk: int) -> tuple[int, int]:
    """(chunk length, number of chunks) covering S with padding."""
    c = min(chunk, S)
    return c, -(-S // c)


def _pad_seq(t, n: int):
    """Zero-pad dim 1 of t to length n."""
    extra = n - t.shape[1]
    if extra == 0:
        return t
    return F.pad(t, [0, 0] * (t.ndim - 2) + [0, extra])


def _param(*shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device, dtype=dtype), requires_grad=False)


# --------------------------------------------------------------------------
# Mamba-1
# --------------------------------------------------------------------------


class Mamba1(nn.Module):
    """The reference's ``init_mamba1`` dict as a module."""

    def __init__(self, d_model, *, d_state, expand=2, conv=4, device=None,
                 dtype=torch.float32):
        super().__init__()
        DI = expand * d_model
        dt_rank = max(1, d_model // 16)
        self.in_proj = _param(d_model, 2 * DI, device=device, dtype=dtype)
        self.conv_w = _param(DI, conv, device=device, dtype=dtype)
        self.conv_b = _param(DI, device=device, dtype=dtype)
        self.x_proj = _param(DI, dt_rank + 2 * d_state, device=device, dtype=dtype)
        self.dt_proj = _param(dt_rank, DI, device=device, dtype=dtype)
        self.dt_bias = _param(DI, device=device, dtype=torch.float32)
        self.A_log = _param(DI, d_state, device=device, dtype=torch.float32)
        self.D = _param(DI, device=device, dtype=dtype)
        self.out_proj = _param(DI, d_model, device=device, dtype=dtype)


def init_mamba1(p: Mamba1, gen: torch.Generator) -> Mamba1:
    """The reference's ``init_mamba1`` values drawn from ``gen`` into ``p``."""
    dev = p.in_proj.device
    with torch.no_grad():
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            w = getattr(p, name)
            w.copy_(dense_init(gen, *w.shape, device=dev))
        p.conv_w.copy_(torch.randn(p.conv_w.shape, generator=gen, device=dev) * 0.02)
        p.conv_b.zero_()
        p.dt_bias.zero_()
        N = p.A_log.shape[1]
        p.A_log.copy_(torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev))
                      .expand(p.A_log.shape))
        p.D.fill_(1.0)
    return p


def _chunk_recurrence(dA, dBx):
    """h_t = dA_t · h_{t-1} + dBx_t along dim 2 (the positions of a chunk)
    from h = 0, for every chunk at once: one fused multiply-add over all
    chunks per position, the reference's ``associative_scan`` of
    ``combine`` evaluated in order."""
    if torch.is_grad_enabled() and (dA.requires_grad or dBx.requires_grad):
        # autograd records no ``out=``: the same fused steps, stacked (at
        # a cost the in-place form below spares inference: a second copy of
        # the states while they are stacked)
        h = [dBx[:, :, 0]]
        for t in range(1, dBx.shape[2]):
            h.append(torch.addcmul(dBx[:, :, t], dA[:, :, t], h[-1]))
        return torch.stack(h, 2)
    hs = torch.empty_like(dBx)
    hs[:, :, 0] = dBx[:, :, 0]
    for t in range(1, dBx.shape[2]):
        torch.addcmul(dBx[:, :, t], dA[:, :, t], hs[:, :, t - 1], out=hs[:, :, t])
    return hs


def _xz_cols(q: int, tp):
    """Rank r's columns of Mamba-1's ``in_proj`` ``[x | z]`` (``q`` of
    ``d_inner`` a rank over ``tp``'s ranks): its ``x`` block, then its ``z``
    block."""
    return lambda r: [(r * q, (r + 1) * q), (tp.size * q + r * q, tp.size * q + (r + 1) * q)]


def _x_proj(p: Mamba1, dtype, tp):
    """``x_proj`` in ``dtype`` (with ``tp``: its column block re-laid into
    the rank's ``d_inner`` rows)."""
    return parallel.reshard(p.x_proj.to(dtype), -1, -2, tp)


def _mamba1_inner(p: Mamba1, x, h0, *, d_state: int, chunk: int, tp=None):
    """Selective scan over (B, S, d_inner) activations; returns (y, h_last)."""
    B, S, DI = x.shape
    dt_rank = p.dt_proj.shape[0]
    # summed over ``model``, then used on the rank's channels: its gradient
    # is a partial sum again
    bcdt = parallel.enter(parallel.reduce(x @ _x_proj(p, x.dtype, tp), tp), tp)
    dt_low, Bc, Cc = torch.split(bcdt, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(_f32(dt_low @ p.dt_proj.to(x.dtype)) + p.dt_bias)
    A = -torch.exp(p.A_log)  # (DI, N)

    c, nc = _chunks(S, chunk)
    n = c * nc
    xs, dts = _pad_seq(x, n), _pad_seq(dt, n)  # dt = 0 in padded rows
    Bs, Cs = _pad_seq(Bc, n), _pad_seq(Cc, n)
    dts = dts.reshape(B, nc, c, DI)
    dA = torch.exp(dts[..., None] * A)  # (B, nc, c, DI, N) f32
    dBx = (dts * _f32(xs).reshape(B, nc, c, DI))[..., None] \
        * _f32(Bs).reshape(B, nc, c, 1, d_state)
    hs = _chunk_recurrence(dA, dBx)
    del dA, dBx
    # Π dA over each chunk's prefix, and the state carried across chunks:
    # h_{z+1} = hs[z, -1] + prodA[z, -1] * h_z
    prodA = torch.exp(torch.cumsum(dts, dim=2)[..., None] * A)
    carries, h = [], h0
    for z in range(nc):
        carries.append(h)
        h = hs[:, z, -1] + prodA[:, z, -1] * h
    hs += prodA * torch.stack(carries, 1)[:, :, None]
    y = torch.einsum("bzcdn,bzcn->bzcd", hs, _f32(Cs).reshape(B, nc, c, d_state))
    y = y.to(x.dtype).reshape(B, n, DI)[:, :S]
    return y + x * p.D.to(x.dtype), h


def mamba1_prefill(p: Mamba1, x, *, d_state: int, chunk: int = 128, tp=None):
    """The Mamba-1 block over a prompt x (B, S, d_model); returns (out,
    cache): the pre-conv window of the last W-1 positions and the final
    SSM state (the reference's ``ssm_model.prefill`` layer body); with
    ``tp`` both of the rank's ``d_inner`` slice."""
    B = x.shape[0]
    dt = x.dtype
    DI, W = p.conv_w.shape
    w_in = parallel.take_cols(p.in_proj.to(dt), _xz_cols(DI, tp), tp)
    xi, z = (parallel.enter(x, tp) @ w_in).chunk(2, dim=-1)
    conv_state = _conv_window(xi, W)
    xi = F.silu(causal_conv1d(xi, p.conv_w.to(dt), p.conv_b.to(dt)))
    h0 = torch.zeros((B, DI, d_state), dtype=_wide(x.dtype), device=x.device)
    y, h_last = _mamba1_inner(p, xi, h0, d_state=d_state, chunk=chunk, tp=tp)
    y = y * F.silu(z)
    return parallel.reduce(y @ p.out_proj.to(dt), tp), {"conv": conv_state, "ssm": h_last}


def mamba1(p: Mamba1, x, *, d_state: int, chunk: int = 128, tp=None):
    """Full Mamba-1 block. x: (B, S, d_model) -> (B, S, d_model)."""
    return mamba1_prefill(p, x, d_state=d_state, chunk=chunk, tp=tp)[0]


def mamba1_init_cache(p: Mamba1, batch: int, d_state: int, dtype=torch.bfloat16):
    DI, W = p.conv_w.shape
    dev = p.conv_w.device
    return {
        "conv": torch.zeros((batch, W - 1, DI), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, DI, d_state), dtype=torch.float32, device=dev),
    }


def mamba1_decode(p: Mamba1, cache, xt, *, d_state: int, tp=None):
    """One token. xt: (B, d_model) -> (cache', (B, d_model)).  With ``tp``
    the conv window is the rank's ``d_inner`` slice and the SSM state its
    ``N`` slice of every channel (B, d_inner, N/n)."""
    dt_rank = p.dt_proj.shape[0]
    dt = xt.dtype
    DI = p.conv_w.shape[0]
    xi, z = (xt @ parallel.take_cols(p.in_proj.to(dt), _xz_cols(DI, tp), tp)).chunk(2, dim=-1)
    conv_state, xi = conv_step(cache["conv"], xi, p.conv_w.to(dt), p.conv_b.to(dt))
    xi = F.silu(xi)
    bcdt = parallel.reduce(xi @ _x_proj(p, dt, tp), tp)
    dt_low, Bc, Cc = torch.split(bcdt, [dt_rank, d_state, d_state], dim=-1)
    delta = F.softplus(_f32(dt_low @ p.dt_proj.to(dt)) + p.dt_bias)  # (B, DI)
    # every channel's x and delta, and A, B, C on the state's N slice
    A = -torch.exp(parallel.reshard(p.A_log, -2, -1, tp))
    xa, da = parallel.gather_last(xi, tp), parallel.gather_last(delta, tp)
    dA = torch.exp(da[..., None] * A)  # (B, DI, N)
    dBx = (da * _f32(xa))[..., None] \
        * _f32(parallel.part_last(Bc, tp))[:, None, :]
    h = cache["ssm"] * dA + dBx
    y = parallel.scatter_last(
        torch.einsum("bdn,bn->bd", h, _f32(parallel.part_last(Cc, tp))), tp).to(dt)
    y = y + xi * p.D.to(dt)
    y = y * F.silu(z)
    return {"conv": conv_state, "ssm": h}, parallel.reduce(y @ p.out_proj.to(dt), tp)


# --------------------------------------------------------------------------
# Mamba-2 (SSD)
# --------------------------------------------------------------------------


class Mamba2(nn.Module):
    """The reference's ``init_mamba2`` dict as a module; ``in_proj`` maps to
    ``[z (DI), x (DI), B (N), C (N), dt (H)]``."""

    def __init__(self, d_model, *, d_state, head_dim=64, expand=2, conv=4, device=None,
                 dtype=torch.float32):
        super().__init__()
        DI = expand * d_model
        H = DI // head_dim
        self.in_proj = _param(d_model, 2 * DI + 2 * d_state + H, device=device, dtype=dtype)
        self.conv_w = _param(DI + 2 * d_state, conv, device=device, dtype=dtype)
        self.conv_b = _param(DI + 2 * d_state, device=device, dtype=dtype)
        self.A_log = _param(H, device=device, dtype=torch.float32)
        self.D = _param(H, device=device, dtype=dtype)
        self.dt_bias = _param(H, device=device, dtype=torch.float32)
        self.norm_w = _param(DI, device=device, dtype=dtype)
        self.out_proj = _param(DI, d_model, device=device, dtype=dtype)


def init_mamba2(p: Mamba2, gen: torch.Generator) -> Mamba2:
    """The reference's ``init_mamba2`` values drawn from ``gen`` into ``p``."""
    dev = p.in_proj.device
    with torch.no_grad():
        for name in ("in_proj", "out_proj"):
            w = getattr(p, name)
            w.copy_(dense_init(gen, *w.shape, device=dev))
        p.conv_w.copy_(torch.randn(p.conv_w.shape, generator=gen, device=dev) * 0.02)
        p.conv_b.zero_()
        p.A_log.zero_()
        p.D.fill_(1.0)
        p.dt_bias.zero_()
        p.norm_w.fill_(1.0)
    return p


def _ssd_chunk_scan(xh, dt, A, Bc, Cc, h0, *, chunk: int):
    """Chunked SSD. xh: (B,S,H,P); dt: (B,S,H) f32; A: (H,) f32 (negative);
    Bc/Cc: (B,S,N). Returns (y (B,S,H,P), h_last (B,H,P,N)).

    Per chunk, as the reference: the intra-chunk term ``(L ∘ C Bᵀ)(dt·X)``
    with ``L = exp(seg_i - seg_j)`` below the diagonal, the carried state's
    term, and the state update; the first two and the chunks' own state
    contributions are computed for all chunks at once, the carry in a loop."""
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    c, nc = _chunks(S, chunk)
    n = c * nc

    def resh(t):  # (B, S, ...) -> (B, nc, c, ...), padded with zeros (dt = 0)
        t = _pad_seq(t, n)
        return t.reshape((B, nc, c) + t.shape[2:])

    xs, dts, Bs, Cs = resh(xh), resh(dt), resh(Bc), resh(Cc)
    seg = torch.cumsum(dts * A, dim=2)  # (B, nc, c, H), decreasing
    cb = torch.einsum("bzin,bzjn->bzij", Cs, Bs)  # x.dtype, as the reference
    decay = torch.exp(seg[:, :, :, None] - seg[:, :, None]).permute(0, 1, 4, 2, 3)
    causal = torch.ones((c, c), dtype=torch.bool, device=xh.device).tril()
    # above the diagonal exp() overflows to inf: select, never multiply by
    # the mask (inf·0 = nan)
    scores = torch.where(causal, cb[:, :, None] * decay, 0.0)  # (B, nc, H, c, c)
    xdt = _f32(xs) * dts[..., None]  # (B, nc, c, H, P)
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", scores, xdt)
    # each chunk's own contribution to the state at its end
    w = torch.exp(seg[:, :, -1:] - seg)  # (B, nc, c, H)
    Bs32, Cs32 = _f32(Bs), _f32(Cs)
    own = torch.einsum("bzjhp,bzjn->bzhpn", xdt * w[..., None], Bs32)
    carries, h = [], h0
    for z in range(nc):
        carries.append(h)
        h = own[:, z] + h * torch.exp(seg[:, z, -1])[..., None, None]
    y_inter = torch.einsum("bzin,bzhpn->bzihp", Cs32, torch.stack(carries, 1)) \
        * torch.exp(seg)[..., None]
    y = (y_intra + y_inter).to(xh.dtype).reshape(B, n, H, P)[:, :S]
    return y, h


def _zxbcdt_cols(q: int, hp: int, N: int, tp):
    """Rank r's columns of Mamba-2's ``in_proj`` ``[z | x | B | C | dt]``
    (``q`` channels and ``hp`` heads a rank over ``tp``'s ranks): its ``z``
    and ``x`` heads, all of ``B`` and ``C``, its ``dt`` heads: the block's
    own layout at width ``q``."""
    def cols(r):
        DI = tp.size * q
        return [(r * q, (r + 1) * q), (DI + r * q, DI + (r + 1) * q), (2 * DI, 2 * DI + 2 * N),
                (2 * DI + 2 * N + r * hp, 2 * DI + 2 * N + (r + 1) * hp)]
    return cols


def mamba2_conv_part(t, N: int, tp, dim: int = -1):
    """The channels of Mamba-2's conv input ``[x | B | C]`` that the rank
    uses, from ``t`` whole over them along ``dim``: its ``x`` block, all of
    ``B`` and ``C``; ``t`` itself without ``tp``."""
    if tp is None:
        return t
    DI = t.shape[dim] - 2 * N
    q = DI // tp.size
    return torch.cat([t.narrow(dim, tp.rank * q, q), t.narrow(dim, DI, 2 * N)], dim)


def mamba2_conv_whole(t, N: int, tp):
    """The inverse of :func:`mamba2_conv_part` along the last dim: the
    ranks' ``x`` blocks all-gathered, ``B`` and ``C`` (the same on every
    rank) after them; ``t`` itself without ``tp``."""
    if tp is None:
        return t
    return torch.cat([parallel.gather_last(t[..., :-2 * N], tp), t[..., -2 * N:]], -1)


def _mamba2_in(p: Mamba2, x, d_state: int, head_dim: int, tp):
    """(z, [x | B | C] before the conv, dt) of x's rows through ``in_proj``
    (the rank's heads with ``tp``), and the conv's weights and bias on
    those channels."""
    DI, N = p.norm_w.shape[0], d_state
    dt_ = x.dtype
    zxbcdt = x @ parallel.take_cols(p.in_proj.to(dt_), _zxbcdt_cols(DI, DI // head_dim, N, tp), tp)
    w, b = (mamba2_conv_part(t.to(dt_), N, tp, 0) for t in (p.conv_w, p.conv_b))
    # [x, B, C], the reference's concatenation
    return zxbcdt[..., :DI], zxbcdt[..., DI:2 * DI + 2 * N], zxbcdt[..., 2 * DI + 2 * N:], w, b


def mamba2_prefill(p: Mamba2, x, *, d_state: int, head_dim: int = 64, chunk: int = 128,
                   tp=None):
    """The Mamba-2 block over x (B, S, d_model); returns (out, cache): the
    pre-conv window of the last W-1 positions and the final SSM state;
    with ``tp`` the window of the rank's channels (:func:`mamba2_conv_part`)
    and the state of its heads."""
    B, S, _ = x.shape
    DI = p.norm_w.shape[0]
    H = DI // head_dim
    N = d_state
    dt_ = x.dtype
    W = p.conv_w.shape[-1]
    z, xbc_raw, dt, conv_w, conv_b = _mamba2_in(p, parallel.enter(x, tp), N, head_dim, tp)
    conv_state = _conv_window(xbc_raw, W)
    xbc = F.silu(causal_conv1d(xbc_raw, conv_w, conv_b))
    xi, Bc, Cc = torch.split(xbc, [DI, N, N], dim=-1)
    dt = F.softplus(_f32(dt) + p.dt_bias)  # (B, S, H)
    A = parallel.part_last(-torch.exp(p.A_log), tp)
    xh = xi.reshape(B, S, H, head_dim)
    h0 = torch.zeros((B, H, head_dim, N), dtype=_wide(x.dtype), device=x.device)
    y, h_last = _ssd_chunk_scan(xh, dt, A, Bc, Cc, h0, chunk=chunk)
    y = y + xh * p.D[:, None].to(dt_)
    y = rmsnorm(y.reshape(B, S, DI) * F.silu(z), p.norm_w.to(dt_), tp=tp)
    return parallel.reduce(y @ p.out_proj.to(dt_), tp), {"conv": conv_state, "ssm": h_last}


def mamba2(p: Mamba2, x, *, d_state: int, head_dim: int = 64, chunk: int = 128, tp=None):
    """Full Mamba-2 block. x: (B, S, d_model)."""
    return mamba2_prefill(p, x, d_state=d_state, head_dim=head_dim, chunk=chunk, tp=tp)[0]


def mamba2_init_cache(p: Mamba2, batch: int, d_state: int, dtype=torch.bfloat16):
    H = p.A_log.shape[0]
    P = p.norm_w.shape[0] // H
    C, W = p.conv_w.shape
    dev = p.conv_w.device
    return {
        "conv": torch.zeros((batch, W - 1, C), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, H, P, d_state), dtype=torch.float32, device=dev),
    }


def mamba2_decode(p: Mamba2, cache, xt, *, d_state: int, head_dim: int = 64, tp=None):
    """One token. xt: (B, d_model) -> (cache', (B, d_model)).  With ``tp``
    the conv window holds the rank's channels (:func:`mamba2_conv_part`)
    and the SSM state its ``N`` slice of every head (B, H, P, N/n)."""
    DI = p.norm_w.shape[0]
    H = DI // head_dim
    N = d_state
    B = xt.shape[0]
    dt_ = xt.dtype
    z, xbc, dt, conv_w, conv_b = _mamba2_in(p, xt, N, head_dim, tp)
    conv_state, xbc = conv_step(cache["conv"], xbc, conv_w, conv_b)
    xi, Bc, Cc = torch.split(F.silu(xbc), [DI, N, N], dim=-1)
    dt = F.softplus(_f32(dt) + p.dt_bias)  # (B, H)
    # every head's x and dt, and B and C on the state's N slice
    dt = parallel.gather_last(dt, tp)
    dA = torch.exp(dt * -torch.exp(p.A_log))  # (B, H)
    xa = parallel.gather_last(xi, tp).reshape(B, -1, head_dim)
    dBx = (dt[..., None] * _f32(xa))[..., None] \
        * _f32(parallel.part_last(Bc, tp))[:, None, None, :]
    h = cache["ssm"] * dA[..., None, None] + dBx  # (B, H, P, N)
    y = torch.einsum("bhpn,bn->bhp", h, _f32(parallel.part_last(Cc, tp)))
    y = parallel.scatter_last(y.flatten(1), tp).to(dt_).unflatten(1, (H, head_dim))
    y = y + xi.reshape(B, H, head_dim) * p.D[:, None].to(dt_)
    y = rmsnorm(y.reshape(B, DI) * F.silu(z), p.norm_w.to(dt_), tp=tp)
    return {"conv": conv_state, "ssm": h}, parallel.reduce(y @ p.out_proj.to(dt_), tp)

