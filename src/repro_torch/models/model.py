"""Family dispatcher, and the reference's parameters carried across.

The counterpart of ``repro.models.model``'s public functions:

* ``init_params(cfg, seed, device=None)``
* ``loss_fn(cfg, params, batch)``            — train forward + CE
* ``prefill(cfg, params, batch, max_len)``   — serve: prompt -> cache
* ``decode_step(cfg, params, cache, tok)``   — serve: one token
* ``init_cache(cfg, batch, max_len, device=None)``

Every family is ported: dense, MoE and VLM (:mod:`transformer`), SSM
(:mod:`ssm_model`), hybrid (:mod:`hybrid`) and enc-dec (:mod:`encdec`).
The reference's GSPMD rules (``partition_specs``, ``cache_specs``,
``batch_specs``, ``input_specs``) wait for the multi-card port (ROADMAP
Queue 1).

:func:`params_from_numpy` loads the reference's parameter pytree (numpy
arrays, ``(d_in, d_out)`` matrices, layers stacked on leading axes: ``(L,
...)`` for ``layers``, ``tail``, ``enc_layers`` and ``dec_layers``, ``(g,
per, ...)`` for the hybrid's ``groups``) into the port's modules;
:func:`params_to_numpy` is its inverse.  The same mapping carries any
module-shaped tree, such as the optimizer's moments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.relation import resolve_device
from repro_torch.models import encdec, hybrid, ssm_model, transformer

#: each family's module and the module class holding its parameters
_FAMILIES = {
    "dense": (transformer, transformer.Transformer),
    "moe": (transformer, transformer.Transformer),
    "vlm": (transformer, transformer.Transformer),
    "ssm": (ssm_model, ssm_model.SSMModel),
    "hybrid": (hybrid, hybrid.Hybrid),
    "audio": (encdec, encdec.EncDec),
}


def _mod(cfg):
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family][0]
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
    m = _mod(cfg)
    if cfg.family == "audio":  # 3/4 self positions, 1/4 cross positions
        return m.init_cache(cfg, batch, (max_len * 3) // 4, max_len // 4, device=device)
    return m.init_cache(cfg, batch, max_len, device=device)


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


def _tree_name(name: str) -> tuple[str, tuple[int, ...]]:
    """A module parameter's name -> (the reference's leaf path, its index
    on the leaf's stacked axes): ``layers.3.attn.wq`` -> (``layers.attn.wq``,
    (3,)); ``groups.2.5.mamba.D`` -> (``groups.mamba.D``, (2, 5));
    ``shared.down`` -> (``shared.down``, ())."""
    parts = name.split(".")
    return (".".join(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def _stacks(params) -> dict:
    """Each leaf path -> the shape of its stacked axes, from the modules'
    indices (``(L,)`` for ``layers``, ``(g, per)`` for ``groups``)."""
    shapes: dict = {}
    for name, _ in params.named_parameters():
        path, index = _tree_name(name)
        top = shapes.get(path, (0,) * len(index))
        shapes[path] = tuple(max(t, i + 1) for t, i in zip(top, index))
    return shapes


def leaf_paths(params) -> list[str]:
    """The reference's leaf path of each parameter, in ``parameters()``
    order: the layers of one stacked leaf share a path."""
    return [_tree_name(name)[0] for name, _ in params.named_parameters()]


def leaf_shapes(params) -> dict:
    """Each leaf path of the reference's pytree (``layers.attn.wq``) -> its
    shape there, stacked axes first, without copying anything."""
    stacks = _stacks(params)
    return {path: stacks[path] + tuple(p.shape) for path, p in
            ((_tree_name(name)[0], p) for name, p in params.named_parameters())}


def params_from_numpy(cfg, tree: dict, device=None, dtype=None):
    """Load the reference's parameter pytree into the port's modules on
    ``device`` (the card unless ``device="cpu"``), stored in ``dtype``
    (default ``cfg.dtype``: cast once here, which gives the values the
    reference's cast at each use gives; the SSM's ``A_log`` and ``dt_bias``,
    which the reference uses uncast, stay float32).  Leaves are anything
    ``np.asarray`` takes; every leaf must be used and every parameter
    given, at its exact shape."""
    device = resolve_device(device)
    _mod(cfg)
    params = _FAMILIES[cfg.family][1](cfg, device=device,
                                      dtype=dtype or transformer.compute_dtype(cfg))
    stacks = _stacks(params)
    flat = _flatten(tree)
    used = set()
    with torch.no_grad():
        for name, p in params.named_parameters():
            path, index = _tree_name(name)
            if path not in flat:
                raise KeyError(f"the parameter tree has no leaf {path!r} for {name}")
            a = np.asarray(flat[path], dtype=np.float32)
            if index:
                if a.shape[:len(index)] != stacks[path]:
                    raise ValueError(f"{path}: {a.shape[:len(index)]} layers stacked, the "
                                     f"model has {stacks[path]}")
                a = a[index]
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
    float32 numpy arrays, layers stacked on the leading axes."""
    flat: dict = {}
    stacked: dict = {}
    for name, p in params.named_parameters():
        path, index = _tree_name(name)
        a = p.detach().to("cpu", torch.float32).numpy()
        if index:
            stacked.setdefault(path, {})[index] = a
        else:
            flat[path] = a
    for path, shape in _stacks(params).items():
        if shape:
            parts = stacked[path]
            flat[path] = np.stack([parts[i] for i in np.ndindex(*shape)]).reshape(
                shape + parts[(0,) * len(shape)].shape)
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *dirs, leaf = path.split(".")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = a
    return tree
