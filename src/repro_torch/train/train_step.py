"""Train-step factory: loss + grad + (optional) microbatch accumulation +
(optional) error-feedback gradient compression + AdamW.

The counterpart of ``repro.train.train_step``.  The state is a plain dict
as in the reference: ``params`` (the model, float32 master weights, which
the forward casts to ``cfg.dtype`` at each use), ``opt`` = {``mu``, ``nu``,
``step``} and, with compression, ``err``.  ``make_train_step`` returns an
eager function ``(state, batch) -> (state, metrics)`` that updates the
state's tensors in place.

A sharded state (``elastic.reshard_state`` with :func:`state_specs`) holds
DTensors, each rank the shards the reference's per-chip arguments hold.
The step then runs FSDP-style data parallelism: every parameter is
gathered to its full value (``launch.mesh.gathered_module``), the rank
runs the forward and backward of the unsharded step on its batch shard
(the batch is the global batch, every rank the same, or DTensors sharded
over the batch axes), and each full gradient, a ``Partial`` sum over the
batch axes, is reduce-scattered into its parameter's placement and divided
by the number of batch shards.  Every row has the same number of targets
and every shard the same number of rows, so the mean of the shards' mean
losses is the global mean.  A global batch whose microbatches do not split
evenly over the batch axes is not sharded: every rank runs all of it, as
the reference's ``batch_specs`` then replicates it.  The same function
runs both states.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.launch import mesh as mesh_lib
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


def _loss_and_grads(cfg, params, batch: dict, microbatches: int):
    """Mean loss and float32 gradients (a list in ``parameters()`` order)
    of ``batch`` split into ``microbatches`` along its leading axis;
    autograd sums their gradients in the parameters' ``.grad``."""
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
    return loss, grads


def _local_batch(batch: dict, mesh, microbatches: int) -> tuple[dict, int, int]:
    """This rank's part of ``batch``, the number of batch shards and of the
    rank's microbatches: a DTensor's local rows, or of a plain (global)
    tensor, the rank's share of each microbatch along the batch axes, so
    that its microbatches are the reference's, sharded.  Shares must be
    equal (see the module doc): a plain batch that does not split so is
    run whole by every rank (one shard).  A DTensor batch must split
    evenly over the shards; where a shard holds fewer rows than
    ``microbatches`` (the reference's microbatch is then less than a row
    per shard), the rank runs each of its rows as one microbatch, which
    gives the same mean."""
    n, r = model.batch_shard(mesh)
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"a batch of {rows} rows does not split into "
                         f"{microbatches} microbatches")
    if any(isinstance(v, DTensor) for v in batch.values()):
        if rows % n or (rows // n) % microbatches and microbatches % (rows // n):
            raise ValueError(f"a DTensor batch of {rows} rows does not split evenly into "
                             f"{microbatches} microbatches on each of {n} batch shards")
        return ({k: v.to_local() for k, v in batch.items()}, n,
                min(microbatches, rows // n))
    if rows % (n * microbatches):
        return batch, 1, microbatches
    return ({k: torch.cat([torch.chunk(mb, n)[r] for mb in torch.chunk(v, microbatches)])
             for k, v in batch.items()}, n, microbatches)


def _sharded_loss_and_grads(cfg, params, batch: dict, microbatches: int):
    """The global mean loss and each parameter's gradient, a DTensor in its
    placement, of a module of DTensor parameters (see the module doc)."""
    mesh = next(params.parameters()).device_mesh
    axes = model.batch_axes(mesh)
    mine, n, microbatches = _local_batch(batch, mesh, microbatches)
    work = mesh_lib.gathered_module(params)
    loss, full = _loss_and_grads(cfg, work, mine, microbatches)
    del work
    # each rank's value is its batch shard's part of a sum over the batch
    # axes, or with one shard the whole value
    summed = [Partial() if a in axes and n > 1 else Replicate() for a in mesh.mesh_dim_names]
    grads = []
    for p in params.parameters():
        g = full.pop(0)  # each full gradient is freed once it is redistributed
        g = DTensor.from_local(g, mesh, summed, run_check=False).redistribute(
            mesh, p.placements)
        if n > 1:  # on the local shard: no DTensor op in the step
            g = DTensor.from_local(g.to_local() / n, mesh, g.placements, run_check=False,
                                   shape=g.shape, stride=g.stride())
        grads.append(g)
    loss = DTensor.from_local(loss, mesh, summed, run_check=False).full_tensor()
    return (loss / n if n > 1 else loss), grads


def loss_and_grads(cfg, params, batch: dict, microbatches: int = 1):
    """(mean loss, gradients in ``parameters()`` order) of one step, for a
    plain module or one of DTensor parameters (gradients then DTensors in
    the parameters' placements)."""
    if isinstance(next(params.parameters()), DTensor):
        return _sharded_loss_and_grads(cfg, params, batch, microbatches)
    return _loss_and_grads(cfg, params, batch, microbatches)


def make_train_step(cfg, opt_cfg: optimizer.OptConfig, *, microbatches: int = 1,
                    compress_frac: float = 0.0):
    def train_step(state, batch):
        params = state["params"]
        loss, grads = loss_and_grads(cfg, params, batch, microbatches)

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


def state_specs(cfg, state: dict, mesh) -> dict:
    """Specs for the full train state: the parameters' for the parameters,
    the moments and ``err``; ``opt.step`` replicated."""
    pspecs = model.partition_specs(cfg, state["params"], mesh)
    specs = {"params": pspecs, "opt": {"mu": pspecs, "nu": pspecs, "step": ()}}
    if "err" in state:
        specs["err"] = pspecs
    return specs
