"""Communication runner: per-shard stage functions over stacked tensors.

* **SimComm** — stacked ``(P, ...)`` tensors on one device; each stage
  runs once per shard in a Python loop and the per-shard results are
  stacked again; ``all_to_all`` is a swap of the two leading axes.  This
  lets one card (or the CPU, in tests) run any shard count, bit-identical
  to a run with one shard per device.

Stage functions are written against shard-local views and a ``shard_id``;
the runner stitches them together, keeping the paper's map / shuffle /
reduce structure explicit.  (A ``torch.distributed`` runner with one shard
per card is later work; ``Comm`` names the runners that exist.)

The reference maps stages over the shard axis with ``jax.vmap``.  Here the
loop is explicit: the stages call data-dependent index operations and the
probe kernel through ``ctypes``, neither of which ``torch.func.vmap`` can
batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from repro_torch.core.relation import Relation


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


Comm = SimComm


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
    ``stacked_args`` carries a leading P axis.

    ``tracer`` (a :class:`repro_torch.obs.tracer.Tracer`, DESIGN.md §14)
    records one phase span per stage (named by ``names``, falling back to
    the stage function's name).  Tracing must not perturb the work it
    measures: spans bracket the *launch* of each stage and nothing waits
    for the device between stages — the identical instruction stream to
    the untraced path, so traced and untraced runs are bit-identical.  Per
    stage *device*-time attribution needs a barrier after every stage; opt
    in via ``Tracer(trace_sync=True)`` (a measurement mode, never the
    default).
    """
    traced = tracer is not None and getattr(tracer, "enabled", False)
    trace_sync = traced and getattr(tracer, "trace_sync", False)

    def one_stage(stage, carry):
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
        for i in range(len(sends[0])):
            column = [s[i] for s in sends]
            for s in sends:
                s[i] = None
            recv.append(comm.exchange(column))
        return (tree_unflatten(template, recv), carry)

    carry = stacked_args
    for i, stage in enumerate(stages):
        if traced:
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
