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
package loads into the other.  Loading is single-card: the reference's
``mesh`` and ``specs`` (reshard-on-load) wait for the multi-card port
(ROADMAP Queue 1); ``load`` takes a ``device`` instead.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from torch import nn

from repro_torch.core.relation import resolve_device
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
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def save(ckpt_dir: str, step: int, tree) -> str:
    """Atomically write one checkpoint; returns the committed path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "mesh": None, "leaves": {}}
    for name, arr in _flatten(tree).items():
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
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


def _load(path: str, like, prefix: str, device):
    out = {}
    for k, v in like.items():
        name = f"{prefix}{k}"
        if isinstance(v, nn.Module):
            tree: dict = {}
            for leaf, shape in model.leaf_shapes(v).items():
                node = tree
                *dirs, last = leaf.split(".")
                for d in dirs:
                    node = node.setdefault(d, {})
                node[last] = _read(path, _SEP.join([name, *dirs, last]), shape)
            p0 = next(v.parameters())
            out[k] = model.params_from_numpy(v.cfg, tree, device=device, dtype=p0.dtype)
            out[k].requires_grad_(p0.requires_grad)
        elif isinstance(v, dict):
            out[k] = _load(path, v, name + _SEP, device)
        else:
            shape = tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
            dtype = v.dtype if isinstance(v, torch.Tensor) else None
            out[k] = torch.as_tensor(_read(path, name, shape), device=device, dtype=dtype)
    return out


def load(ckpt_dir: str, step: int, like, *, device=None):
    """Load into the structure of ``like`` on ``device`` (the card unless
    ``device="cpu"``).  A module leaf of ``like`` gives a new module of its
    class, config, dtype and ``requires_grad``; a tensor leaf a tensor of
    its dtype; shapes must match the checkpoint's."""
    device = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "manifest.json")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    return _load(path, like, "", device)
