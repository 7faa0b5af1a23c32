"""Device meshes over ``torch.distributed``, and the DTensor helpers that
place a model's state on one.

The counterpart of ``repro.launch.mesh``.  :func:`make_host_mesh` puts
every rank of the process group on a ``(data, model)``
``DeviceMesh`` of shape ``(world_size, 1)``: batch and FSDP shard over
``data``, tensor parallelism would go over ``model``.  Without a process
group, and outside ``torchrun``, it starts a one-rank group (NCCL on the
card, gloo with ``device="cpu"``), so the same path runs without a
launcher.  :func:`make_production_mesh` builds the reference's production
meshes, ``(data=16, model=16)`` (256 ranks) and ``(pod=2, data=16,
model=16)`` (512 ranks), on the default group it finds; the dry-run
(:mod:`repro_torch.launch.dryrun`) first starts one with
:func:`make_fake_group`, torch's ``"fake"`` backend, whose collectives move
nothing, so that one process traces rank 0 of the production mesh.

The helpers read a mesh's axis names and sizes only, from a
``DeviceMesh`` or from a plain ``{axis: size}`` dict (the sharding rules of
:mod:`repro_torch.models.model` take either):

* :func:`full_value` gathers a DTensor's full tensor with the list form of
  ``all_gather`` on each sharded mesh dim.  (DTensor's own gather crashes
  gloo's process group on card tensors, PERF.md §6; the list form and
  every other collective used here work there.)
* :func:`place` puts a full tensor on a mesh by its placements, each rank
  keeping its slice; :func:`place_module` does so for every parameter of a
  model module, giving a new module of DTensor parameters.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Shard, distribute_tensor

from repro_torch.core.relation import resolve_device

AXES = ("data", "model")
PRODUCTION = {False: ((16, 16), AXES), True: ((2, 16, 16), ("pod",) + AXES)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(device=None) -> DeviceMesh:
    """Every rank as a ``(data=world_size, model=1)`` mesh on ``device``'s
    type (the card unless ``device="cpu"``; raises without a card)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "TORCHELASTIC_RUN_ID" in os.environ:  # torchrun sets the rendezvous
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                    world_size=1, rank=0)
    return init_device_mesh(dev.type, (dist.get_world_size(), 1), mesh_dim_names=AXES)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """The reference's production mesh on the default process group:
    ``(data=16, model=16)``, or with ``multi_pod`` ``(pod=2, data=16,
    model=16)``, on ``device``'s type (the card unless ``device="cpu"``).
    Batch and FSDP shard over ``pod`` and ``data``, tensor parallelism over
    ``model``.  The group must already hold 256 or 512 ranks (a
    :func:`make_fake_group` for a trace); none is started here."""
    shape, axes = PRODUCTION[multi_pod]
    world = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != world:
        have = dist.get_world_size() if dist.is_initialized() else "no"
        raise RuntimeError(f"the production mesh {shape} needs a process group of {world} "
                           f"ranks, found {have}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_fake_group(world: int) -> None:
    """Start the default process group as rank 0 of ``world`` on torch's
    ``"fake"`` backend: collectives return at once and move nothing, so one
    process can run rank 0's part of a ``world``-rank program (under fake
    tensors, its trace).  Call it before anything else starts a group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` or of such a dict, in mesh order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local(x):
    """A DTensor's local shard (a view: writing it writes the DTensor), or
    ``x`` itself."""
    return x.to_local() if isinstance(x, DTensor) else x


@torch.no_grad()
def full_value(x, over=None):
    """The full tensor of a DTensor (a collective over the mesh dims that
    shard it; the last mesh dim is gathered first, so a tensor dim sharded
    over several mesh dims comes back major to minor); any other tensor as
    it is.  With ``over`` (mesh dim names), only those mesh dims are
    gathered: the result is this rank's part along the others.  Partial
    placements are refused: they are not values yet."""
    if not isinstance(x, DTensor):
        return x
    t = x.to_local().detach()
    mesh = x.device_mesh
    for dim in reversed(range(mesh.ndim)):
        pl = x.placements[dim]
        if isinstance(pl, Partial):
            raise ValueError("full_value of a Partial DTensor: reduce it first")
        n = mesh.size(dim)
        if over is not None and mesh.mesh_dim_names[dim] not in over:
            continue
        if isinstance(pl, Shard) and n > 1:
            if x.shape[pl.dim] % math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                                          if isinstance(p, Shard) and p.dim == pl.dim):
                raise ValueError(f"dim {pl.dim} of {tuple(x.shape)} does not shard evenly")
            # bool has no gloo type: its bytes travel as uint8
            src = t.contiguous()
            src = src.view(torch.uint8) if src.dtype == torch.bool else src
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=mesh.get_group(dim))
            t = torch.cat(parts, dim=pl.dim)
            t = t.view(torch.bool) if x.dtype == torch.bool else t
    return t


def place(x, mesh: DeviceMesh, placements) -> DTensor:
    """``x`` (a full tensor, a numpy array, or a DTensor on any mesh) as a
    DTensor on ``mesh``: each rank slices its own shard out of the full
    value, so nothing is scattered."""
    full = full_value(x) if isinstance(x, DTensor) else torch.as_tensor(x)
    full = full.detach().to(mesh_device(mesh))
    return distribute_tensor(full, mesh, list(placements), src_data_rank=None)


def module_with(module: nn.Module, tensors: dict, requires_grad: bool) -> nn.Module:
    """A module of ``module``'s class and config (built on ``meta``) whose
    parameters are ``tensors``, by parameter name (no copies)."""
    shell = type(module)(module.cfg, device="meta")
    names = [n for n, _ in shell.named_parameters()]
    if sorted(names) != sorted(tensors):
        raise KeyError(f"parameters differ: {sorted(set(names) ^ set(tensors))}")
    for name in names:
        owner, _, leaf = name.rpartition(".")
        setattr(shell.get_submodule(owner), leaf,
                nn.Parameter(tensors[name], requires_grad=requires_grad))
    return shell


def place_module(module: nn.Module, placements: dict, mesh: DeviceMesh) -> nn.Module:
    """A new module whose parameters are ``module``'s (full or DTensors on
    another mesh) placed on ``mesh``, each by ``placements[name]``."""
    p0 = next(module.parameters())
    return module_with(
        module,
        {name: place(p, mesh, placements[name]) for name, p in module.named_parameters()},
        p0.requires_grad)


def gathered_module(module: nn.Module, requires_grad: bool = True) -> nn.Module:
    """A module of ``module``'s full parameters, each a new leaf that
    records gradients unless ``requires_grad`` is false (the forward and
    backward of a sharded state run on it; a mesh dim of size 1 gathers
    nothing, so on one rank the parameters share the DTensors' storage)."""
    return module_with(module, {n: full_value(p) for n, p in module.named_parameters()},
                       requires_grad=requires_grad)
