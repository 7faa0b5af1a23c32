"""Checkpointing with atomic commit, in the reference's on-disk layout.

The counterpart of ``repro.ckpt.checkpoint``.  Layout:
``<dir>/step_<n>/`` holding one ``.npy`` per pytree leaf, named by the
leaf's path joined with ``"__"``, plus ``manifest.json`` (step, mesh,
each leaf's shape and dtype).  Writes go to ``step_<n>.tmp`` and are
``os.rename``d into place, so a crash mid-write never corrupts the latest
complete checkpoint, and ``latest_step`` only ever sees committed ones.

A tree is a dict of trees, tensors, numpy arrays or model modules.  A
module is written as the reference's parameter pytree
(``model.params_to_numpy``: layers stacked on leading axes) and read back
with ``model.params_from_numpy``, so a checkpoint written by either
package loads into the other.

Reshard-on-load (elastic scaling): leaves are stored as full logical
arrays.  ``save(..., mesh=)`` gathers each DTensor leaf's full value once
(a collective: every rank of the mesh calls it), the mesh's first rank
writes, and the manifest records the mesh; ``load(..., mesh=, specs=)``
places each leaf on the *target* mesh by its spec, so a checkpoint written
on ``(2, 2)`` restores onto ``(1, 1)`` or ``(4, 1)``.  Without ``specs``, a
leaf that is a DTensor in ``like`` (or a module of them) takes its
placements, on ``mesh`` or on its own mesh.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.core.relation import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model

_SEP = "__"


def _flatten(tree, prefix: str = "") -> dict:
    """Leaf name -> numpy array, modules expanded into their pytrees."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, nn.Module):
            v = model.params_to_numpy(v)
        if isinstance(v, dict):
            out.update(_flatten(v, name + _SEP))
        elif isinstance(v, torch.Tensor):
            out[name] = mesh_lib.full_value(v).detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def save(ckpt_dir: str, step: int, tree, *, mesh=None) -> str:
    """Atomically write one checkpoint; returns the committed path.  With
    ``mesh`` every rank of it must call: the leaves are gathered, the
    mesh's first rank writes, and a mesh spanning every rank waits for
    the commit before returning."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _flatten(tree)
    if mesh is None or int(mesh.mesh.flatten()[0]) == dist.get_rank():
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {},
                    "mesh": None if mesh is None else list(mesh_lib.axis_sizes(mesh).items())}
        for name, arr in flat.items():
            np.save(os.path.join(tmp, name + ".npy"), arr)
            manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if mesh is not None and mesh.size() == dist.get_world_size():
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _read(path: str, name: str, shape) -> np.ndarray:
    arr = np.load(os.path.join(path, name + ".npy"))
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: checkpoint shape {arr.shape} != expected {tuple(shape)}")
    return arr


def _target(like_leaf, spec, mesh):
    """(mesh, placements) a leaf is loaded onto, or None for a plain one."""
    if spec is not None and mesh is not None:
        return mesh, model.placements(spec, mesh)
    if isinstance(like_leaf, DTensor):
        return mesh or like_leaf.device_mesh, like_leaf.placements
    return None


def _load(path: str, like, prefix: str, device, mesh, specs):
    out = {}
    for k, v in like.items():
        name = f"{prefix}{k}"
        spec = specs.get(k) if specs is not None else None
        if isinstance(v, nn.Module):
            tree: dict = {}
            for leaf, shape in model.leaf_shapes(v).items():
                node = tree
                *dirs, last = leaf.split(".")
                for d in dirs:
                    node = node.setdefault(d, {})
                node[last] = _read(path, _SEP.join([name, *dirs, last]), shape)
            p0 = next(v.parameters())
            pspecs = model.param_specs(v, spec) if spec is not None else {}
            targets = {n: _target(p, pspecs.get(n), mesh) for n, p in v.named_parameters()}
            dev = device
            if any(targets.values()):
                dev = mesh_lib.mesh_device(next(t for t in targets.values() if t)[0])
            m = model.params_from_numpy(v.cfg, tree, device=dev, dtype=p0.dtype)
            if any(targets.values()):
                m = mesh_lib.module_with(m, {
                    n: mesh_lib.place(p, *targets[n]) if targets[n] else p
                    for n, p in m.named_parameters()}, p0.requires_grad)
            out[k] = m.requires_grad_(p0.requires_grad)
        elif isinstance(v, dict):
            out[k] = _load(path, v, name + _SEP, device, mesh, spec)
        else:
            shape = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
            dtype = v.dtype if isinstance(v, torch.Tensor) else None
            arr = torch.as_tensor(_read(path, name, shape), dtype=dtype)
            target = _target(v, spec, mesh)
            out[k] = mesh_lib.place(arr, *target) if target else arr.to(device)
    return out


def load(ckpt_dir: str, step: int, like, *, mesh=None, specs=None, device=None):
    """Load into the structure of ``like`` on ``device`` (the card unless
    ``device="cpu"``).  A module leaf of ``like`` gives a new module of its
    class, config, dtype and ``requires_grad``; a tensor leaf a tensor of
    its dtype; shapes must match the checkpoint's.  With ``mesh`` and
    ``specs`` (a tree of specs matching ``like``: for a module the
    ``model.partition_specs`` dict of its leaf paths) every leaf is placed
    on ``mesh`` by its spec, each rank keeping its shards; a DTensor leaf of
    ``like`` without a spec keeps its placements."""
    device = mesh_lib.mesh_device(mesh) if device is None and mesh is not None \
        else resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "manifest.json")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    return _load(path, like, "", device, mesh, specs)
