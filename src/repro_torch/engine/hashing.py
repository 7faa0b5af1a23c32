"""Vectorized 32-bit hashing for join keys.

All engine values are int32; keys are (possibly multi-column) int32 tuples.
Routing uses a mixed 32-bit hash; *matching* always compares the exact key
columns, so hash collisions only affect load balance, never correctness.

torch has no full uint32 arithmetic, so the unsigned 32-bit hash state
lives in int64 tensors holding values in ``[0, 2**32)``: every step masks
with ``0xFFFFFFFF``, ``>>`` on a non-negative int64 is the logical shift,
``%`` on it is the unsigned modulo, and a product of two 32-bit values
(which overflows int64) is formed from 16-bit halves of the constant.
Results are bit-identical to the reference's jnp uint32 arithmetic.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or int64) tensor -> its uint32 value held in int64."""
    return x.to(torch.int64) & MASK32


def to_i32(h: torch.Tensor) -> torch.Tensor:
    """uint32 value in int64 -> the int32 with the same bits (two's
    complement wrap, as jnp's ``astype(int32)`` does)."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` without int64
    overflow: each partial product stays below ``2**48``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Low-bias 32-bit finalizer (triple32-style); uint32 in int64."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def hash_cols(cols: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Hash rows of an ``(N, K)`` int32 tensor into ``(N,)`` uint32 values
    (held in int64).

    Columns are folded left-to-right with a golden-ratio combine, so the
    hash depends on column order (keys are ordered tuples).
    """
    if cols.ndim == 1:
        cols = cols[:, None]
    h = torch.full(
        (cols.shape[0],), (salt & MASK32) ^ _GOLDEN, dtype=torch.int64,
        device=cols.device,
    )
    for k in range(cols.shape[1]):
        t = (u32(cols[:, k]) + _GOLDEN + ((h << 6) & MASK32) + (h >> 2)) & MASK32
        h = mix32(h ^ t)
    return h


def bucket_of(h: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Map uint32 hashes (in int64) to [0, num_buckets) as int32."""
    return (u32(h) % num_buckets).to(torch.int32)


# --------------------------------------------------------------------------
# (signature, key) fingerprints — DESIGN.md §5
# --------------------------------------------------------------------------
#
# The MSJ hot path computes one int32 fingerprint column per message at map
# time and reuses it for everything downstream: shard routing, the packing
# dedup sort, and the bucketed probe kernel's sort/prune key.  Matching is
# always exact on the key columns, so fingerprint collisions can cost load
# balance or packing efficiency but never correctness.


def fingerprint(keys: torch.Tensor, *, salt: int = 0, exact: bool = False) -> torch.Tensor:
    """(N, K) int32 key columns -> (N,) int32 fingerprint.

    ``exact=True`` (single key column) is the lex-preserving identity pack:
    the fingerprint *is* the key, collision-free, and messages need not
    carry the key columns separately.  Otherwise a salted mixed hash of all
    columns (salt the signature id so distinct signatures decorrelate).
    """
    if exact:
        assert keys.shape[1] == 1, "exact fingerprint requires a single key column"
        return keys[:, 0].to(torch.int32)
    return to_i32(hash_cols(keys, salt=salt))


def route_of(fp: torch.Tensor, salt: int, P: int) -> torch.Tensor:
    """Destination shard from a fingerprint.

    One extra ``mix32`` decorrelates the shard route from the raw
    fingerprint, so (a) exact (identity) fingerprints of structured keys
    still spread over shards and (b) the reducer-side bucket sort, which
    orders by the fingerprint itself, is independent of the ``% P`` route.
    """
    step = ((((salt & MASK32) + 1) & MASK32) * _GOLDEN) & MASK32
    h = mix32((u32(fp) + step) & MASK32)
    return bucket_of(h, P)


def prune_key(fp: torch.Tensor) -> torch.Tensor:
    """Non-negative int32 sort/prune key with the uint32 order of ``fp``.

    Dropping the lowest bit keeps all comparisons signed-safe inside the
    probe kernel (int32 compares); two fingerprints differing only in
    bit 0 share a prune key, which merely widens a bucket band.
    """
    return (u32(fp) >> 1).to(torch.int32)
