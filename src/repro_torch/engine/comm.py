"""Communication runners: the same per-shard stage functions execute either

* **SimComm** — stacked ``(P, ...)`` tensors on one device; each stage
  runs once per shard in a Python loop and the per-shard results are
  stacked again; ``all_to_all`` is a swap of the two leading axes.  This
  lets one card (or the CPU, in tests) run any shard count, bit-identical
  to a run with one shard per device.
* **MeshComm** — one shard per rank of a ``torch.distributed``
  ``DeviceMesh`` axis (or several, flattened major to minor);
  ``all_to_all`` is ``all_to_all_single`` over that axis's process group.
  :func:`mesh_pipeline` gathers the ranks' results into the stacked form.

Stage functions are written against shard-local views and a ``shard_id``;
the runner stitches them together, keeping the paper's map / shuffle /
reduce structure explicit.  The MSJ operator, the executor and the
service run on SimComm; nothing in the reference runs them under MeshComm
either (ROADMAP).

The reference maps stages over the shard axis with ``jax.vmap``.  Here the
loop is explicit: the stages call data-dependent index operations and the
probe kernel through ``ctypes``, neither of which ``torch.func.vmap`` can
batch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.relation import Relation
from repro_torch.obs.tracer import host_span


@dataclass(frozen=True)
class SimComm:
    """Stacked-tensor simulation of a P-shard mesh."""

    P: int

    def shard_ids(self) -> range:
        return range(self.P)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x: (P, P, ...) stacked [src, dest, ...] -> [dest, src, ...]."""
        return x.transpose(0, 1).contiguous()

    def exchange(self, sends: list) -> torch.Tensor:
        """:meth:`all_to_all` of the stack of per-source ``(P, ...)``
        buffers, without materializing the stack: each source's buffer is
        copied into its column of the result and released (the list is
        consumed), so the peak is the received buffer plus the sends, not
        twice the sends plus their stack."""
        first = sends[0]
        out = torch.empty((first.shape[0], len(sends)) + tuple(first.shape[1:]),
                          dtype=first.dtype, device=first.device)
        for p in range(len(sends)):
            out[:, p] = sends[p]
            sends[p] = None
        return out


@dataclass(frozen=True)
class MeshComm:
    """One shard per rank over one axis of a ``DeviceMesh``, or a tuple of
    axes in mesh order, flattened major to minor (every rank must then
    build the MeshComm: it creates the flattened axis's process groups)."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis: str | tuple[str, ...]
    group: object = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        axes = self.axes
        names = list(self.mesh.mesh_dim_names)
        if len(axes) == 1:
            group = self.mesh.get_group(axes[0])
        else:
            if list(axes) != sorted(axes, key=names.index):
                raise ValueError(f"axes {axes} are not in mesh order {names}")
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(len(names)) if d not in dims]
            ranks = self.mesh.mesh.permute(*rest, *dims).reshape(-1, self.P)
            group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        object.__setattr__(self, "group", group)

    @property
    def axes(self) -> tuple[str, ...]:
        return (self.axis,) if isinstance(self.axis, str) else tuple(self.axis)

    @property
    def P(self) -> int:
        n = 1
        for a in self.axes:
            n *= self.mesh.size(list(self.mesh.mesh_dim_names).index(a))
        return n

    def shard_id(self) -> int:
        idx = 0
        for a in self.axes:
            idx = idx * self.mesh.size(list(self.mesh.mesh_dim_names).index(a)) \
                + self.mesh.get_local_rank(a)
        return idx

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x local: (P, ...) send row j to shard j; receive likewise."""
        src = _wire(x.contiguous())
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return _unwire(out, x.dtype)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x local -> (P, ...), row j shard j's."""
        src = _wire(x.contiguous())
        parts = [torch.empty_like(src) for _ in range(self.P)]
        dist.all_gather(parts, src, group=self.group)
        return _unwire(torch.stack(parts), x.dtype)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y

    def all_reduce_or(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(torch.int32) if x.dtype == torch.bool else x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y.to(torch.bool) if x.dtype == torch.bool else y


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bool has no gloo type: its bytes travel as uint8."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(torch.bool) if dtype == torch.bool else t


Comm = SimComm | MeshComm


# --------------------------------------------------------------------------
# Trees of per-shard values: tuples, lists, dicts, Relations, tensors, None
# --------------------------------------------------------------------------


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf, keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Relation):
        return Relation(tree.name, fn(tree.data), fn(tree.valid))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"unsupported pipeline value {type(tree).__name__}")


def tree_leaves(tree) -> list[torch.Tensor]:
    leaves = []
    tree_map(lambda t: leaves.append(t) or t, tree)
    return leaves


def tree_unflatten(template, leaves: list[torch.Tensor]):
    """Rebuild ``template``'s structure with ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def tree_index(tree, p: int):
    """Shard ``p`` of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[p], tree)


def _stack(leaves: list[torch.Tensor]) -> torch.Tensor:
    """Stack per-shard tensors; shard views of one untouched stacked tensor
    (a relation a stage passed through) give that tensor back uncopied."""
    base = leaves[0]._base
    if (
        base is not None
        and base.shape[0] == len(leaves)
        and all(
            t._base is base
            and t.shape == base.shape[1:]
            and t.stride() == base.stride()[1:]
            and t.data_ptr() == base.data_ptr() + p * base.stride(0) * base.element_size()
            for p, t in enumerate(leaves)
        )
    ):
        return base
    return torch.stack(leaves)


def tree_stack(trees: list):
    """Inverse of :func:`tree_index`: a list of P per-shard trees -> one
    tree of stacked ``(P, ...)`` tensors."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return _stack(trees)
    if isinstance(first, Relation):
        return Relation(
            first.name, _stack([t.data for t in trees]), _stack([t.valid for t in trees])
        )
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_stack(list(vs)) for vs in zip(*trees))
    raise TypeError(f"unsupported pipeline value {type(first).__name__}")


def _sync(tree) -> None:
    """Wait for the device work behind a tree's tensors (CUDA only)."""
    if any(t.is_cuda for t in tree_leaves(tree)):
        torch.cuda.synchronize()


def run_pipeline(
    comm: Comm,
    stages: Sequence[Callable],
    stacked_args,
    *,
    tracer=None,
    names: Sequence[str] | None = None,
):
    """Run ``stages`` alternating per-shard compute with all_to_all.

    Each stage has signature ``stage(shard_id, carry) -> (send, carry)`` where
    ``send`` is either None (no shuffle after this stage) or a tree of
    ``(P, ...)`` buffers to exchange; the exchanged buffers are passed as
    ``carry`` input (tuple ``(recv, carry)``) to the next stage.
    ``stacked_args`` carries a leading P axis.  Under SimComm the result
    is stacked too; under MeshComm each rank runs every stage once on its
    own shard, ``tree_index(stacked_args, rank)``, exchanges each send
    leaf with ``all_to_all`` and returns its shard's result.

    ``tracer`` (a :class:`repro_torch.obs.tracer.Tracer`, DESIGN.md §14)
    records one phase span per stage (named by ``names``, falling back to
    the stage function's name).  Tracing must not perturb the work it
    measures: spans bracket the *launch* of each stage and nothing waits
    for the device between stages — the identical instruction stream to
    the untraced path, so traced and untraced runs are bit-identical.  Per
    stage *device*-time attribution needs a barrier after every stage; opt
    in via ``Tracer(trace_sync=True)`` (a measurement mode, never the
    default).  Under SimComm each stage also gets two host spans: the
    P-shard loop with the carry's stack (``sim.shards``) and the
    leaf-by-leaf exchange (``sim.exchange``).
    """
    trace_sync = tracer is not None and tracer.trace_sync

    def mesh_stage(stage, carry):
        send, carry = stage(comm.shard_id(), carry)
        if send is None:
            return carry
        return (tree_map(comm.all_to_all, send), carry)

    def sim_stage(stage, carry):
        with host_span(tracer, "sim.shards"):
            outs = [stage(p, tree_index(carry, p)) for p in comm.shard_ids()]
            sends = [tree_leaves(o[0]) for o in outs]
            template = outs[0][0]
            carry = tree_stack([o[1] for o in outs])
            del outs
        if template is None:
            return carry
        # exchange leaf by leaf: each per-source buffer is released as soon
        # as it has been copied into the received buffer
        recv = []
        with host_span(tracer, "sim.exchange"):
            for i in range(len(sends[0])):
                column = [s[i] for s in sends]
                for s in sends:
                    s[i] = None
                recv.append(comm.exchange(column))
        return (tree_unflatten(template, recv), carry)

    if isinstance(comm, MeshComm):
        one_stage, carry = mesh_stage, tree_index(stacked_args, comm.shard_id())
    else:
        one_stage, carry = sim_stage, stacked_args
    for i, stage in enumerate(stages):
        if tracer is not None:
            label = names[i] if names and i < len(names) else getattr(
                stage, "__name__", f"stage{i}"
            )
            with tracer.span(label):
                carry = one_stage(stage, carry)
                if trace_sync:
                    _sync(carry)
        else:
            carry = one_stage(stage, carry)
    return carry


def mesh_pipeline(mesh, axis, stages: Sequence[Callable]) -> Callable:
    """``stacked_args -> result``: :func:`run_pipeline` under
    ``MeshComm(mesh, axis)``, each rank's result gathered into the stacked
    ``(P, ...)`` form on every rank (the reference's ``shard_map`` with the
    outputs sharded over ``axis``)."""
    comm = MeshComm(mesh, axis)

    def run(stacked_args, **kw):
        return tree_map(comm.all_gather, run_pipeline(comm, stages, stacked_args, **kw))

    return run
