"""Family dispatcher, and the reference's parameters carried across.

The counterpart of ``repro.models.model``'s public functions:

* ``init_params(cfg, seed, device=None)``
* ``loss_fn(cfg, params, batch)``            — train forward + CE
* ``prefill(cfg, params, batch, max_len)``   — serve: prompt -> cache
* ``decode_step(cfg, params, cache, tok)``   — serve: one token
* ``init_cache(cfg, batch, max_len, device=None)``
* ``partition_specs(cfg, params, mesh)``     — a spec per parameter
* ``input_specs(cfg, shape)``                — ``meta`` tensor stand-ins

Every family is ported: dense, MoE and VLM (:mod:`transformer`), SSM
(:mod:`ssm_model`), hybrid (:mod:`hybrid`) and enc-dec (:mod:`encdec`).

Sharding follows the reference's rules (Megatron + ZeRO-3: column-parallel
weights shard their output dim over ``model``, row-parallel their input
dim, and the other dim over the flattened data axes; an axis that does not
divide a dim is dropped for that dim).  A spec is a tuple with one entry
per tensor dim: an axis name, a tuple of names, or ``None``.  The rules
read only the mesh's axis names and sizes, from a ``DeviceMesh`` or a
plain ``{axis: size}`` dict; :func:`placements` turns a spec into DTensor
placements.  Specs are keyed by the reference's leaf paths
(:func:`leaf_paths`) and resolved on the stacked shapes
(:func:`leaf_shapes`), so they equal the reference's; the port's per-layer
parameter takes its leaf's spec without the layer axes
(:func:`param_specs`).

:func:`params_from_numpy` loads the reference's parameter pytree (numpy
arrays, ``(d_in, d_out)`` matrices, layers stacked on leading axes: ``(L,
...)`` for ``layers``, ``tail``, ``enc_layers`` and ``dec_layers``, ``(g,
per, ...)`` for the hybrid's ``groups``) into the port's modules;
:func:`params_to_numpy` is its inverse.  The same mapping carries any
module-shaped tree, such as the optimizer's moments.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.relation import resolve_device
from repro_torch.launch.mesh import axis_sizes, full_value
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
    """(cache, last-token logits) of a prompt batch; sharded (see
    :func:`_sharded_serve`) when the parameters are DTensors."""
    if _is_sharded(params):
        return _sharded_serve(cfg, params, batch, None,
                              lambda b, _: _mod(cfg).prefill(cfg, params, b, max_len),
                              max_len=max_len)
    return _mod(cfg).prefill(cfg, params, batch, max_len)


def decode_step(cfg, params, cache, tokens):
    """(cache', logits) of one token per slot; sharded (see
    :func:`_sharded_serve`) when the parameters are DTensors."""
    if _is_sharded(params):
        return _sharded_serve(cfg, params, {"tokens": tokens}, cache,
                              lambda b, c: _mod(cfg).decode_step(cfg, params, c, b["tokens"]))
    return _mod(cfg).decode_step(cfg, params, cache, tokens)


def _is_sharded(params) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(next(params.parameters()), DTensor)


def batch_shard(mesh) -> tuple[int, int]:
    """(number of batch shards, this rank's index among them): the
    flattened batch axes of ``mesh``, major to minor."""
    sizes = axis_sizes(mesh)
    n, r = 1, 0
    for a in batch_axes(mesh):
        n, r = n * sizes[a], r * sizes[a] + mesh.get_local_rank(a)
    return n, r


def _sharded_serve(cfg, params, batch: dict, cache, fn, max_len=None):
    """Serving on a module of DTensor parameters: ``fn(batch, cache)``, the
    family's call on ``params``, runs on this rank's batch rows inside a
    :class:`~repro_torch.models.parallel.Shards` context, so that each
    layer's weights are gathered as the layer runs (over the FSDP axes,
    tensor-parallel over ``model`` in the transformer families) and each
    cache leaf stays in :func:`cache_specs`' placement: the rank's rows and
    its slice of the ``model``-sharded dim, one layer gathered at a time
    where a family computes every head.  A rank's rows are its shard of
    the batch axes when the batch splits evenly over them (as
    :func:`batch_specs` and :func:`cache_specs` then shard it), else all
    rows.  Inputs are DTensors placed by those specs (their local shards
    are used as they are) or global tensors (the rank's part is cut out).
    Returns the new cache placed by :func:`cache_specs` (``len``,
    replicated there, gathered over the batch axes) and the logits sharded
    on their batch dim.  The cache's local tensors are the ones written in
    place."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import parallel

    mesh = next(params.parameters()).device_mesh
    names = mesh.mesh_dim_names
    n, r = batch_shard(mesh)
    B = batch["tokens"].shape[0]
    split = B % n == 0 and n > 1
    axes = batch_axes(mesh)
    nm = axis_sizes(mesh).get("model", 1)
    like = cache if cache is not None else init_cache(cfg, B, max_len, device="meta")
    specs = cache_specs(cfg, {k: SimpleNamespace(shape=v.shape) for k, v in like.items()}, mesh)
    dims = {k: spec.index("model") - len(spec) for k, spec in specs.items()
            if "model" in spec and nm > 1}

    def layout(ndim, bdim, mdim) -> list:
        """This rank's part: its rows on ``bdim``, its slice of ``mdim``."""
        return [Shard(bdim) if a in axes and split else
                Shard(ndim + mdim) if a == "model" and mdim is not None else Replicate()
                for a in names]

    def local(v, bdim, mdim=None):
        pl = layout(v.ndim, bdim, mdim)
        if isinstance(v, DTensor):
            if all(a == b or mesh.size(i) == 1
                   for i, (a, b) in enumerate(zip(v.placements, pl))):
                return v.to_local()
            v = full_value(v)  # in another placement: this rank's part is cut out
        if split:
            v = torch.chunk(v, n, dim=bdim)[r]
        if mdim is not None:
            v = torch.chunk(v, nm, dim=mdim)[mesh.get_local_rank("model")]
        return v

    mine = {k: local(v, 0) for k, v in batch.items()}
    local_cache = None if cache is None else {
        k: local(v, cache_batch_dim(k, v.shape), dims.get(k)) for k, v in cache.items()}
    with parallel.sharded(parallel.Shards(mesh, split=split, cache_dims=dims)):
        new_cache, logits = fn(mine, local_cache)

    row_pl = [Shard(0) if a in axes and split else Replicate() for a in names]
    out = {}
    for k, v in new_cache.items():
        if k == "len" and split:
            v = full_value(DTensor.from_local(v, mesh, row_pl, run_check=False))
        out[k] = DTensor.from_local(v, mesh, placements(specs[k], mesh), run_check=False)
    return out, DTensor.from_local(logits, mesh, row_pl, run_check=False)


def init_cache(cfg, batch: int, max_len: int, *, device=None):
    m = _mod(cfg)
    if cfg.family == "audio":  # 3/4 self positions, 1/4 cross positions
        return m.init_cache(cfg, batch, (max_len * 3) // 4, max_len // 4, device=device)
    return m.init_cache(cfg, batch, max_len, device=device)


# --------------------------------------------------------------------------
# Sharding rules
# --------------------------------------------------------------------------

# last-n-dims templates per leaf name; "tp" = model axis, "dp" = fsdp axes
_COL = ("dp", "tp")  # (d_in, d_out): output column-parallel
_ROW = ("tp", "dp")
_RULES: dict[str, tuple] = {
    "embed": ("tp", "dp"),
    "lm_head": _COL,
    "wq": _COL, "wk": _COL, "wv": _COL,
    "w1": _COL, "w3": _COL,
    "in_proj": _COL, "x_proj": _COL, "dt_proj": _COL,
    "wo": _ROW, "w2": _ROW, "out_proj": _ROW, "down": _ROW,
    "router": (None, None),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "conv_w": ("tp", None), "conv_b": ("tp",),
    "A_log": ("tp", None), "D": ("tp",), "dt_bias": ("tp",), "norm_w": ("tp",),
    "ln1": (None,), "ln2": (None,), "lnx": (None,), "ln": (None,),
    "final_norm": (None,), "enc_norm": (None,),
    "q_norm": (None,), "k_norm": (None,),
}
# MoE expert stacks (ndim 3 before layer stacking): (E, in, out)
_MOE_RULES = {
    "w1": (None, "dp", "tp"), "w3": (None, "dp", "tp"), "w2": (None, "tp", "dp"),
}
_MOE_EP_RULES = {
    "w1": ("tp", "dp", None), "w3": ("tp", "dp", None), "w2": ("tp", None, "dp"),
}


def fsdp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a != "model")


def _entry(axes: tuple):
    """A spec entry for ``axes``: one name alone, as ``PartitionSpec``
    writes it."""
    return axes[0] if len(axes) == 1 else axes


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _resolve(template, shape, mesh) -> tuple:
    """Template ("dp"/"tp"/None per trailing dim) -> spec, with None for
    the stacked leading dims and each axis that does not divide its dim
    dropped."""
    dp = fsdp_axes(mesh)
    lead = len(shape) - len(template)
    spec: list = [None] * lead
    for dim, t in zip(shape[lead:], template):
        if t == "tp":
            ax = "model" if dim % _axis_size(mesh, "model") == 0 else None
        elif t == "dp":
            ax = _entry(dp) if dim % _axis_size(mesh, dp) == 0 else None
        else:
            ax = None
        spec.append(ax)
    return tuple(spec)


def _leaf_rule(cfg, path: str, shape, mesh) -> tuple:
    """The spec of the reference's leaf at dotted ``path`` (``layers.attn.wq``)
    and stacked ``shape``: the reference's ``partition_specs`` rule."""
    parts = path.split(".")
    name = parts[-1]
    if "moe" in parts and name in _MOE_RULES:
        tmpl = (_MOE_EP_RULES if cfg.expert_parallel else _MOE_RULES)[name]
        return _resolve(tmpl, shape, mesh)
    tmpl = _RULES.get(name)
    if tmpl is None or len(tmpl) > len(shape):
        return (None,) * len(shape)
    return _resolve(tmpl, shape, mesh)


def partition_specs(cfg, params, mesh) -> dict:
    """``{leaf path: spec}`` for a model module (real or on ``meta``): the
    reference's ``partition_specs`` pytree, flattened to its dotted paths
    (``layers.attn.wq``), each spec over the stacked leaf."""
    return {path: _leaf_rule(cfg, path, shape, mesh)
            for path, shape in leaf_shapes(params).items()}


def param_specs(params, specs: dict) -> dict:
    """``{parameter name: spec}``: each parameter, one layer of its stacked
    leaf, takes the leaf's spec without the layer axes.  Where the
    reference's rule shards a layer axis (the Mamba-2 ``A_log`` ``(H,)``
    meets the 2-d template meant for Mamba-1's ``(d_inner, N)``), each
    layer's parameter is held whole."""
    out = {}
    for name, _ in params.named_parameters():
        path, index = _tree_name(name)
        out[name] = tuple(specs[path][len(index):])
    return out


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim that
    shards tensor dim ``d``, ``Replicate()`` elsewhere.  A dim over several
    axes (``("pod", "data")``) must name them in mesh order: DTensor then
    shards it major to minor, as JAX does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"axes {axes} are not in mesh order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def batch_axes(mesh) -> tuple[str, ...]:
    return fsdp_axes(mesh)


def batch_specs(cfg, batch: dict, mesh) -> dict:
    """Shard every batch leaf on its leading (global-batch) dim."""
    ba = batch_axes(mesh)

    def rule(leaf):
        if leaf.shape and leaf.shape[0] % _axis_size(mesh, ba) == 0:
            return (_entry(ba),) + (None,) * (len(leaf.shape) - 1)
        return (None,) * len(leaf.shape)

    return {k: rule(v) for k, v in batch.items()}


def cache_specs(cfg, cache: dict, mesh) -> dict:
    """Decode caches: the batch dim over the data axes and the last dim
    over ``model`` when it divides (else the one before it).  Caches put
    the batch right after the stacked layer axes: dim 1, or dim 2 for the
    hybrid's grouped ``conv``/``ssm`` state."""
    ba = batch_axes(mesh)
    nb = _axis_size(mesh, ba)
    nm = _axis_size(mesh, "model")

    def rule(name, leaf):
        if name == "len" or not leaf.shape:
            return (None,) * len(leaf.shape)
        spec: list = [None] * len(leaf.shape)
        bdim = cache_batch_dim(name, leaf.shape)
        if len(leaf.shape) > bdim and leaf.shape[bdim] % nb == 0:
            spec[bdim] = _entry(ba)
        if leaf.shape[-1] % nm == 0:
            spec[-1] = "model"
        elif len(leaf.shape) >= 2 and leaf.shape[-2] % nm == 0:
            spec[-2] = "model"
        return tuple(spec)

    return {k: rule(k, v) for k, v in cache.items()}


def cache_batch_dim(name: str, shape) -> int:
    """The batch dim of cache leaf ``name``: 0 for ``len``, 2 for the
    hybrid's grouped ``conv``/``ssm`` state, else 1 (after the layer axis)."""
    if name == "len":
        return 0
    return 2 if len(shape) >= 5 and name in ("conv", "ssm") else 1


def input_specs(cfg, shape) -> dict:
    """Global-batch ``meta`` tensors for the model inputs of one
    :class:`~repro_torch.configs.base.ShapeSpec` (nothing is allocated).
    For decode shapes: the ``(batch, 1)`` token and the cache of the
    stated context length, built on ``meta`` by :func:`init_cache`."""
    B, S = shape.global_batch, shape.seq_len
    dt = transformer.compute_dtype(cfg)

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            return {"tokens": sds((B, S - cfg.frontend_tokens), torch.int32),
                    "embeds": sds((B, cfg.frontend_tokens, cfg.d_model), dt)}
        if cfg.family == "audio":
            return {"tokens": sds((B, (S * 3) // 4), torch.int32),
                    "embeds": sds((B, S // 4, cfg.d_model), dt)}
        return {"tokens": sds((B, S), torch.int32)}
    return {"tokens": sds((B, 1), torch.int32), "cache": init_cache(cfg, B, S, device="meta")}


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
    float32 numpy arrays, layers stacked on the leading axes (DTensor
    parameters gathered to their full values: a collective).  The arrays
    are copies, never views of the parameters."""
    flat: dict = {}
    stacked: dict = {}
    for name, p in params.named_parameters():
        path, index = _tree_name(name)
        a = full_value(p).detach().to("cpu", torch.float32, copy=True).numpy()
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
