"""The control: an approximate semi-join that the benchmark must refuse.

A Bloom filter over each conditional relation's facts answers membership
with false positives and never a false negative: the step a faster
program might take by keeping the bloom prefilter and dropping the exact
probe behind it.  Put in the program's place, it breaks the guarantee the
configurations state (exact answers), so ``correct`` has to come out
false on it.
"""
from __future__ import annotations

import torch

#: bits per fact and hash functions: about 4.9 % false positives a probe
BITS_PER_KEY = 8
HASHES = 2

_MIX = (0x9E3779B97F4A7C15 - 2**64, 0xC2B2AE3D27D4EB4F - 2**64, 0x165667B19E3779F9)


def _row_hash(rows: torch.Tensor) -> torch.Tensor:
    h = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for c in range(rows.shape[1]):
        h = (h ^ rows[:, c].to(torch.int64)) * _MIX[c % 2]
        h = h ^ (h >> 29)
    return h


def _positions(h: torch.Tensor, j: int, nbits: int) -> torch.Tensor:
    g = (h + (j + 1) * _MIX[2]) * _MIX[j % 2]
    g = g ^ (g >> 31)
    return torch.remainder(g, nbits)


def bloom_member(keys: torch.Tensor, facts: torch.Tensor, bits_per_key: int = BITS_PER_KEY,
                 hashes: int = HASHES) -> torch.Tensor:
    """Approximate ``semijoin.member``: true for every member, and for
    about ``(1 - exp(-hashes / bits_per_key)) ** hashes`` of the others."""
    nbits = max(64, bits_per_key * facts.shape[0])
    bits = torch.zeros(nbits, dtype=torch.bool, device=keys.device)
    hf, hk = _row_hash(facts), _row_hash(keys)
    ok = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    for j in range(hashes):
        bits[_positions(hf, j, nbits)] = True
    for j in range(hashes):
        ok &= bits[_positions(hk, j, nbits)]
    return ok
