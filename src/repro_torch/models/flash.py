"""Flash attention: chunked online softmax with GQA grouping, and its
memory-correct backward.

The counterpart of ``repro.models.flash``: ``flash_attention`` is a
``torch.autograd.Function`` as the reference's is a ``jax.custom_vjp``.
Plain torch: the reference has no Pallas kernel here, only ``lax.scan``.
The forward saves only ``(q, k, v, o, lse)``; the backward recomputes each
KV chunk's scores from them (the reference's ``_bwd``: an outer loop over
KV chunks, ``dq`` accumulated in float32, ``delta = sum(do * o)``), so
nothing of shape S×S is live: its largest transients are
``(B, Hkv, G, Sq, kv_chunk)`` float32.

Internal layout: (B, Hkv, G, S, D) with G = Hq/Hkv query groups per KV
head, so GQA never materializes repeated K/V.  Scores, the running max,
the denominator and the accumulator are float32; the weights ``p`` are
cast to the query dtype for the PV product, as in the reference.

Where the port parts from the reference:

* **Chunk sizes.** The reference takes the largest divisor of S that is
  ≤ the chunk (``_fit_chunk``), which is 1 for a prime S: thousands of
  tiny steps per layer.  The port pads Sq and Sk up to whole chunks of
  ``min(chunk, S)`` and masks the padded keys; padded queries are dropped.
  The backward pads Sk the same way: the padded keys' weights are 0, so
  they get zero gradient, and the padding is sliced off ``dk`` and ``dv``
  (it walks all Sq queries per KV chunk, as the reference, so ``dq`` has
  no padding).  The function is the same; only the summation order
  differs (rounding).
* **Skipped chunks.** A KV chunk that the mask rejects for every query of
  the current chunk is not computed.  That changes nothing: the reference
  then adds ``exp(-1e30 - m) = 0`` with ``alpha = 1``, or, before the
  first admissible chunk, state that the next admissible chunk's
  ``alpha = 0`` wipes.  The backward skips a KV chunk that no query sees,
  whose ``p`` and gradients would be 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import NEG_INF, _mask


def _pad_to(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    extra = n - x.shape[dim]
    if extra == 0:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, extra]
    return F.pad(x, pad)


def _fully_masked(q_lo, q_hi, k_lo, k_hi, causal: bool, window: int) -> bool:
    """No (q, k) pair of the two position ranges (inclusive) is admissible."""
    if causal and k_lo > q_hi:
        return True
    return window > 0 and q_lo - k_hi >= window


def flash_attention(q, k, v, causal=True, window=0, q_offset=0, q_chunk=512, kv_chunk=1024):
    """q: (B,Hkv,G,Sq,D); k/v: (B,Hkv,Sk,D) -> o (B,Hkv,G,Sq,D)."""
    return _Flash.apply(q, k, v, causal, window, q_offset, q_chunk, kv_chunk)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
        o, lse = _flash_fwd_impl(q, k, v, causal, window, q_offset, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, q_offset, kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return _flash_bwd_impl(q, k, v, o, lse, do, *ctx.args) + (None,) * 5


def _flash_fwd_impl(q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
    """q: (B,Hkv,G,Sq,D); k/v: (B,Hkv,Sk,D) -> (o, lse)."""
    B, Hkv, G, Sq, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    cq, ck = min(q_chunk, Sq), min(kv_chunk, Sk)
    nq, nk = -(-Sq // cq), -(-Sk // ck)
    q = _pad_to(q, 3, nq * cq)
    k = _pad_to(k, 2, nk * ck)
    v = _pad_to(v, 2, nk * ck)
    dev = q.device
    ar_q = torch.arange(cq, device=dev)
    ar_k = torch.arange(ck, device=dev)

    os_, lses = [], []
    for iq in range(nq):
        qi = q[:, :, :, iq * cq:(iq + 1) * cq]
        q_lo = q_offset + iq * cq
        q_pos = q_lo + ar_q
        m = torch.full((B, Hkv, G, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, G, cq, D), dtype=torch.float32, device=dev)
        for ik in range(nk):
            k_lo = ik * ck
            if _fully_masked(q_lo, q_lo + cq - 1, k_lo, k_lo + ck - 1, causal, window):
                continue
            ki = k[:, :, k_lo:k_lo + ck]
            vi = v[:, :, k_lo:k_lo + ck]
            k_pos = k_lo + ar_k
            msk = _mask(q_pos, k_pos, causal, window)
            if k_lo + ck > Sk:  # padded keys
                msk &= (k_pos < Sk)[None, :]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, ki).to(torch.float32) * scale
            s = torch.where(msk, s, NEG_INF)
            m_cur = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(s - m_cur[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(qi.dtype), vi
            ).to(torch.float32)
            m = m_cur
        os_.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    o = torch.cat(os_, dim=3)[:, :, :, :Sq]
    lse = torch.cat(lses, dim=3)[:, :, :, :Sq]
    return o, lse


def _flash_bwd_impl(q, k, v, o, lse, do, causal, window, q_offset, kv_chunk):
    """The reference's ``_bwd``: outer loop over KV chunks (dk/dv written
    per chunk), dq accumulated in float32.  Returns (dq, dk, dv)."""
    B, Hkv, G, Sq, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    ck = min(kv_chunk, Sk)
    nk = -(-Sk // ck)
    kp, vp = _pad_to(k, 2, nk * ck), _pad_to(v, 2, nk * ck)
    dev = q.device
    do32, q32 = do.to(torch.float32), q.to(torch.float32)
    delta = (do32 * o.to(torch.float32)).sum(-1)  # (B,Hkv,G,Sq)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    ar_k = torch.arange(ck, device=dev)
    dq = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Hkv, nk * ck, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for ik in range(nk):
        k_lo = ik * ck
        if _fully_masked(q_offset, q_offset + Sq - 1, k_lo, k_lo + ck - 1, causal, window):
            continue
        ki, vi = kp[:, :, k_lo:k_lo + ck], vp[:, :, k_lo:k_lo + ck]
        k_pos = k_lo + ar_k
        msk = _mask(q_pos, k_pos, causal, window)
        if k_lo + ck > Sk:  # padded keys
            msk &= (k_pos < Sk)[None, :]
        s = torch.einsum("bhgqd,bhkd->bhgqk", q, ki).to(torch.float32) * scale
        s = torch.where(msk, s, NEG_INF)
        p = torch.exp(s - lse[..., None])  # (B,Hkv,G,Sq,ck) f32
        del s
        dp = torch.einsum("bhgqd,bhkd->bhgqk", do32, vi.to(torch.float32))
        ds = p * (dp - delta[..., None]) * scale
        del dp
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, ki.to(torch.float32))
        dk[:, :, k_lo:k_lo + ck] = torch.einsum("bhgqk,bhgqd->bhkd", ds, q32)
        dv[:, :, k_lo:k_lo + ck] = torch.einsum("bhgqk,bhgqd->bhkd", p, do32)
    return dq.to(q.dtype), dk[:, :, :Sk].to(k.dtype), dv[:, :, :Sk].to(v.dtype)
