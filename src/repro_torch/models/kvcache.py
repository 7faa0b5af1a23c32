"""KV cache containers for serving.

The counterpart of ``repro.models.kvcache``.  A cache is a dict of
tensors with layers stacked on the leading axis: ``k`` and ``v`` of shape
``(L, B, T, Hkv, D)`` and ``len``, the per-slot absolute clock ``(B,)``
(int64 here, int32 in the reference: torch indexes with int64).

Windowed (SWA) caches are rotating buffers of ``T = min(max_len, window)``
slots addressed by absolute position mod T; keys are stored *after* RoPE
(absolute), so rotation never invalidates scores.  ``len`` counts tokens
written so far (absolute), from which the valid-slot count is
``min(len, T)``.

Where the reference returns new arrays, the port writes into the cache it
is given (:func:`cache_write_prefill`, :func:`cache_write_token`), so a
decode step does not copy the whole cache.
"""
from __future__ import annotations

import torch


def attn_cache_len(max_len: int, window: int) -> int:
    return min(max_len, window) if window > 0 else max_len


def init_attn_cache(n_layers: int, batch: int, max_len: int, n_kv: int, head_dim: int,
                    *, window: int = 0, dtype=torch.bfloat16, device=None) -> dict:
    T = attn_cache_len(max_len, window)
    return {
        "k": torch.zeros((n_layers, batch, T, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, T, n_kv, head_dim), dtype=dtype, device=device),
        # per-slot absolute clock: continuous batching runs each batch slot
        # at its own position
        "len": torch.zeros((batch,), dtype=torch.int64, device=device),
    }


def cache_write_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Insert prefill keys/values (layer-stacked: (L, B, S, Hkv, D)) with
    :func:`cache_write_prefill_layer`, layer by layer.  Writes into the
    cache it is given and returns it."""
    L, B, S, H, D = k.shape
    for i in range(L):
        cache_write_prefill_layer(cache["k"][i], cache["v"][i], k[i], v[i])
    cache["len"] = torch.full((B,), S, dtype=torch.int64, device=k.device)
    return cache


def cache_write_prefill_layer(k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> None:
    """Insert one layer's prefill keys/values (B, S, Hkv, D) into its
    caches (B, T, Hkv, D), in place.

    Rotating buffers keep the invariant *position p lives at slot p % T*:
    the last T positions are rolled into place so subsequent single-token
    writes (slot = len % T) stay consistent for any S."""
    S, T = k.shape[1], k_cache.shape[1]
    if S >= T:
        # slice index i holds position S-T+i -> slot (i + S%T) % T
        k_cache[...] = torch.roll(k[:, S - T:], shifts=S % T, dims=1)
        v_cache[...] = torch.roll(v[:, S - T:], shifts=S % T, dims=1)
    else:
        k_cache[:, :S] = k
        v_cache[:, :S] = v


def cache_write_token(layer_k_cache: torch.Tensor, layer_v_cache: torch.Tensor,
                      k_t: torch.Tensor, v_t: torch.Tensor, length):
    """Write one token (B, 1, Hkv, D) at per-slot absolute ``length`` (B,),
    in place; returns the two caches."""
    B, T = layer_k_cache.shape[:2]
    length = torch.as_tensor(length, device=layer_k_cache.device).broadcast_to((B,))
    slot = length % T
    rows = torch.arange(B, device=layer_k_cache.device)
    layer_k_cache[rows, slot] = k_t[:, 0]
    layer_v_cache[rows, slot] = v_t[:, 0]
    return layer_k_cache, layer_v_cache
