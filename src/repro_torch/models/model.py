"""Family dispatcher, and the reference's parameters carried across.

The counterpart of ``repro.models.model``'s public functions:

* ``init_params(cfg, seed, device=None)``
* ``prefill(cfg, params, batch, max_len)``   — serve: prompt -> cache
* ``decode_step(cfg, params, cache, tok)``   — serve: one token
* ``init_cache(cfg, batch, max_len, device=None)``

Only the dense family is ported; every other family raises
``NotImplementedError`` naming its ROADMAP item.  The reference's GSPMD
rules (``partition_specs``, ``cache_specs``, ``batch_specs``,
``input_specs``) wait for the multi-card port (ROADMAP Queue 1 item 8).

:func:`params_from_numpy` loads the reference's parameter pytree (numpy
arrays, layer-stacked ``(L, ...)`` leaves, ``(d_in, d_out)`` matrices) into
the port's modules; :func:`params_to_numpy` is its inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.relation import resolve_device
from repro_torch.models import transformer

#: the ROADMAP item that ports each family still missing
NOT_PORTED = {
    "moe": transformer.MOE_ITEM,
    "ssm": "ROADMAP Queue 1 item 6b (SSM: models/ssm.py, models/ssm_model.py)",
    "hybrid": "ROADMAP Queue 1 item 6c (hybrid: models/hybrid.py)",
    "vlm": "ROADMAP Queue 1 item 6d (vlm: the stub vision frontend)",
    "audio": "ROADMAP Queue 1 item 6e (enc-dec: models/encdec.py)",
}


def _mod(cfg):
    if cfg.family == "dense":
        return transformer
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: {NOT_PORTED[cfg.family]}"
        )
    raise ValueError(cfg.family)


def init_params(cfg, seed: int = 0, *, device=None, dtype=None):
    return _mod(cfg).init_params(cfg, seed, device=device, dtype=dtype)


def loss_fn(cfg, params, batch):
    return _mod(cfg).loss_fn(cfg, params, batch)


def prefill(cfg, params, batch, max_len: int):
    return _mod(cfg).prefill(cfg, params, batch, max_len)


def decode_step(cfg, params, cache, tokens):
    return _mod(cfg).decode_step(cfg, params, cache, tokens)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    return _mod(cfg).init_cache(cfg, batch, max_len, device=device)


# --------------------------------------------------------------------------
# The reference's parameter pytree <-> the port's modules
# --------------------------------------------------------------------------


def _flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _tree_name(name: str) -> tuple[str, int | None]:
    """A module parameter's name -> (the reference's leaf path, layer index):
    ``layers.3.attn.wq`` -> (``layers.attn.wq``, 3)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ".".join([parts[0], *parts[2:]]), int(parts[1])
    return name, None


def params_from_numpy(cfg, tree: dict, device=None, dtype=None):
    """Load the reference's parameter pytree into the port's modules on
    ``device`` (the card unless ``device="cpu"``), stored in ``dtype``
    (default ``cfg.dtype``: cast once here, which gives the values the
    reference's cast at each use gives).  Leaves are anything
    ``np.asarray`` takes; every leaf must be used and every parameter
    given, at its exact shape."""
    device = resolve_device(device)
    mod = _mod(cfg)
    params = mod.Transformer(cfg, device=device, dtype=dtype or mod.compute_dtype(cfg))
    flat = _flatten(tree)
    used = set()
    with torch.no_grad():
        for name, p in params.named_parameters():
            path, layer = _tree_name(name)
            if path not in flat:
                raise KeyError(f"the parameter tree has no leaf {path!r} for {name}")
            a = np.asarray(flat[path], dtype=np.float32)
            if layer is not None:
                if a.shape[0] != cfg.n_layers:
                    raise ValueError(f"{path}: {a.shape[0]} layers stacked, config has "
                                     f"{cfg.n_layers}")
                a = a[layer]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a)))
            used.add(path)
    if set(flat) - used:
        raise KeyError(f"leaves the {cfg.name} model has no parameter for: "
                       f"{sorted(set(flat) - used)}")
    return params


def params_to_numpy(params) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's pytree of
    float32 numpy arrays, layers stacked on the leading axis."""
    flat: dict = {}
    stacks: dict = {}
    for name, p in params.named_parameters():
        path, layer = _tree_name(name)
        a = p.detach().to("cpu", torch.float32).numpy()
        if layer is None:
            flat[path] = a
        else:
            stacks.setdefault(path, {})[layer] = a
    for path, per_layer in stacks.items():
        flat[path] = np.stack([per_layer[i] for i in range(len(per_layer))])
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *dirs, leaf = path.split(".")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = a
    return tree
