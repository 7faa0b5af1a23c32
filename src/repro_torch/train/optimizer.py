"""AdamW with decoupled weight decay and a linear-warmup cosine schedule.

The counterpart of ``repro.train.optimizer``.  A tree here is a model
module (its ``parameters()`` in order) or a list of tensors in that order;
the moments ``mu`` and ``nu`` are float32 modules of the model's own class,
so they carry across to and from the reference's pytree with
``model.params_to_numpy`` / ``params_from_numpy`` as the parameters do.
``step + 1``, the clipping scale and the bias corrections are float32, as
in the reference.  The update is written into the parameters and moments
in place (the reference returns new trees); with float32 parameters, the
master weights of training, it gives the reference's numbers.

A sharded state's leaves are DTensors whose gradients share their
placements: the update runs on the local shards, and :func:`global_norm`
sums each leaf's local squares over the mesh dims that shard it, one
all-reduce per placement pattern, so the clip scale is the whole
gradient's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.mesh import local


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def leaves(tree) -> list:
    """A module's parameters in order, or the tensors of a list."""
    return list(tree.parameters()) if isinstance(tree, nn.Module) else list(tree)


def zeros_like(params: nn.Module) -> nn.Module:
    """A float32 module of ``params``' class and shapes, all zeros (the
    families' constructors make zeros), on ``params``' device."""
    return type(params)(params.cfg, device=params.device, dtype=torch.float32)


def init(params: nn.Module) -> dict:
    return {"mu": zeros_like(params), "nu": zeros_like(params),
            "step": torch.zeros((), dtype=torch.int32, device=params.device)}


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def _sum_over_shards(sq: list, xs: list) -> list:
    """Each DTensor leaf's local sum ``sq[i]`` summed over the mesh dims
    that shard it (one all-reduce per placement pattern)."""
    groups: dict = {}
    for i, x in enumerate(xs):
        if isinstance(x, DTensor) and any(isinstance(p, Shard) for p in x.placements):
            groups.setdefault((x.device_mesh, tuple(isinstance(p, Shard) for p in x.placements)),
                              []).append(i)
    sq = list(sq)
    for (mesh, sharded), idx in groups.items():
        pl = [Partial() if s else Replicate() for s in sharded]
        total = DTensor.from_local(torch.stack([sq[i] for i in idx]), mesh, pl,
                                   run_check=False).full_tensor()
        for j, i in enumerate(idx):
            sq[i] = total[j]
    return sq


def global_norm(tree) -> torch.Tensor:
    xs = leaves(tree)
    sq = [torch.sum(torch.square(local(x).to(torch.float32))) for x in xs]
    return torch.sqrt(sum(_sum_over_shards(sq, xs)))


@torch.no_grad()
def apply(params, opt_state: dict, grads, cfg: OptConfig):
    """One AdamW update of ``params`` (a module, updated in place) from
    ``grads`` (a module or a list in ``params``' order); returns
    (params, opt_state', metrics), the moments updated in place."""
    step = local(opt_state["step"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(opt_state["mu"]),
                            leaves(opt_state["nu"]), strict=True):
        p, g, mu, nu = local(p), local(g), local(mu), local(nu)
        g = g.to(torch.float32) * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    if isinstance(opt_state["step"], DTensor):
        old = opt_state["step"]
        step = DTensor.from_local(step, old.device_mesh, old.placements, run_check=False)
    return params, {**opt_state, "step": step}, {"grad_norm": gnorm, "lr": lr}
