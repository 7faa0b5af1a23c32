"""Error-feedback top-k gradient compression.

The counterpart of ``repro.train.grad_compress``: before the optimizer sees
a gradient leaf, only its top ``k_frac`` entries by magnitude survive; the
residual is carried into the next step's gradient (error feedback).  The
threshold is the k-th largest ``|g + e|`` and the mask is ``>=`` it, so
ties keep more than k.  The modeled bytes of a sparse exchange (values and
indices) are reported beside the dense bytes; numerically the filter is
exact on any device.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import model
from repro_torch.train.optimizer import leaves, zeros_like


def init(params: nn.Module) -> nn.Module:
    return zeros_like(params)


@torch.no_grad()
def compress(grads, err: nn.Module, k_frac: float):
    """Returns (sparse grads as a list in ``grads``' order, err, stats);
    ``err`` (a float32 module) is updated in place.  As in the reference,
    k and the threshold are taken per leaf of its pytree, whose stacked
    leaves hold every layer's parameter (``model.leaf_paths``)."""
    gs, es = leaves(grads), leaves(err)
    groups: dict = {}
    for i, path in enumerate(model.leaf_paths(err)):
        groups.setdefault(path, []).append(i)
    sparse = [None] * len(es)
    dense_bytes = sparse_bytes = 0
    for idx in groups.values():
        full = [gs[i].to(torch.float32) + es[i] for i in idx]
        n = sum(g.numel() for g in full)
        k = max(1, int(n * k_frac))
        mags = torch.cat([g.abs().reshape(-1) for g in full])
        thresh = torch.kthvalue(mags, n - k + 1).values  # the k-th largest
        del mags
        for i, g in zip(idx, full):
            sparse[i] = torch.where(g.abs() >= thresh, g, 0.0)
            es[i].copy_(g - sparse[i])
        dense_bytes += n * 4
        sparse_bytes += k * 8  # value + index
    return sparse, err, {"dense_bytes": dense_bytes, "sparse_bytes": sparse_bytes}
