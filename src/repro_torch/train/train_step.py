"""Train-step factory: loss + grad + (optional) microbatch accumulation +
(optional) error-feedback gradient compression + AdamW.

The counterpart of ``repro.train.train_step``.  The state is a plain dict
as in the reference: ``params`` (the model, float32 master weights, which
the forward casts to ``cfg.dtype`` at each use), ``opt`` = {``mu``, ``nu``,
``step``} and, with compression, ``err``.  ``make_train_step`` returns an
eager function ``(state, batch) -> (state, metrics)`` that updates the
state's tensors in place.  The reference's ``state_specs`` (its GSPMD
shardings) waits for the multi-card port (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models import model
from repro_torch.train import grad_compress, optimizer


def init_state(cfg, seed: int, opt_cfg: optimizer.OptConfig, *, compress_frac: float = 0.0,
               device=None) -> dict:
    """Parameters drawn from ``seed`` on ``device`` (the card unless
    ``device="cpu"``) and kept in float32, zero moments."""
    params = model.init_params(cfg, seed, device=device, dtype=torch.float32)
    params.requires_grad_(True)
    state = {"params": params, "opt": optimizer.init(params)}
    if compress_frac > 0:
        state["err"] = grad_compress.init(params)
    return state


def make_train_step(cfg, opt_cfg: optimizer.OptConfig, *, microbatches: int = 1,
                    compress_frac: float = 0.0):
    def train_step(state, batch):
        params = state["params"]
        # split the global batch into microbatches along its leading axis;
        # autograd sums their float32 gradients in the parameters' .grad
        parts = zip(*(torch.chunk(v, microbatches) for v in batch.values()))
        loss = 0
        for part in parts:
            mb = dict(zip(batch, part))
            l_mb = model.loss_fn(cfg, params, mb)
            l_mb.backward()
            loss = loss + l_mb.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.parameters()]
        params.zero_grad(set_to_none=True)
        if microbatches > 1:
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]

        metrics = {"loss": loss}
        new_state = dict(state)
        if compress_frac > 0:
            grads, new_state["err"], cstats = grad_compress.compress(
                grads, state["err"], compress_frac)
            metrics["compress_ratio"] = cstats["sparse_bytes"] / max(cstats["dense_bytes"], 1)
        params, opt, ometrics = optimizer.apply(params, state["opt"], grads, opt_cfg)
        new_state["params"] = params
        new_state["opt"] = opt
        metrics.update(ometrics)
        return new_state, metrics

    return train_step
