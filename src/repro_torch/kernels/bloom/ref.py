"""Pure-loop oracle for the bloom kernels.

Bit positions come from the same hashing as ops.py; build and probe are
naive python loops over numpy copies of the torch inputs — the ground
truth for both the kernels and their plain torch versions.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.bloom import ops


def build(keys, sigs, mask, bits: int) -> np.ndarray:
    pos = ops.positions(keys, sigs, bits).cpu().numpy()
    mask = mask.cpu().numpy()
    nw = ops.n_words(bits)
    flat = np.zeros((nw * ops.LANES,), np.int32)
    for i in range(pos.shape[0]):
        if bool(mask[i]):
            for j in range(pos.shape[1]):
                flat[pos[i, j]] = 1
    return flat.reshape(nw, ops.LANES)


def probe(filt, keys, sigs, bits: int) -> np.ndarray:
    pos = ops.positions(keys, sigs, bits).cpu().numpy()
    flat = filt.cpu().numpy().reshape(-1)
    out = np.zeros((pos.shape[0],), bool)
    for i in range(pos.shape[0]):
        out[i] = all(flat[pos[i, j]] > 0 for j in range(pos.shape[1]))
    return out
