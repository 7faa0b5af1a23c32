"""Op-level cost analyser: FLOPs, bytes, collective bytes and peak memory of
one step, counted op by op while the step runs on fake tensors.

The counterpart of ``repro.launch.hlo``.  The port has no compiled module
to read: :class:`OpCounter`, a ``TorchDispatchMode``, sees every aten op
that one rank runs (under ``FakeTensorMode`` nothing is computed or
allocated) and prices it.  Shapes are the rank's local ones, so the totals
are per rank, as the reference's post-SPMD module gives per-chip totals.

Cost model per op (the reference's rules where they carry over):

* matmuls and convolutions (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``convolution`` and every op of ``torch.utils.flop_counter``'s
  registry) — its formulas: 2·|out|·Π(contracting dims), the reference's
  ``dot`` rule; ``matmul_flops`` keeps them apart.  An op outside the
  registry is first decomposed where it can be, as ``FlopCounterMode``
  does, so the two count the same matmuls;
* elementwise — 1 FLOP per output element, for the aten ops named by the
  reference's ``_ELEMENTWISE`` set (:data:`ELEMENTWISE`, HLO name to aten
  names); reductions (:data:`REDUCTIONS`) — operand bytes / 4;
* bytes — eager PyTorch fuses nothing, so every op that launches work
  moves its operands and its results: the tensors it reads plus the
  tensors it writes.  Views and allocations (:data:`FREE`, and every op
  whose schema says it returns a view) move nothing.  An op that writes
  only some rows of its destination (:data:`PARTIAL_WRITES`: ``index_put_``
  and the scatters) counts as written the bytes of its source, not the
  whole destination;
* collectives — the ring model on the op's own group of n ranks:
  all-gather ``|out|−|in|``, reduce-scatter ``|in|−|out|``, all-reduce
  ``2·|in|·(n−1)/n``, all-to-all ``|in|·(n−1)/n``, permute ``|in|``; both
  the ``_c10d_functional`` ops of DTensor's ``redistribute`` and the
  ``c10d`` list forms (``launch.mesh.full_value``'s ``all_gather``).

Python loops unroll as they run, so there are no trip counts: an
80-layer model is 80 layers of ops, and a trace costs time in proportion
to the ops a rank runs (about 10⁵–10⁶ per full-size step).

Peak memory: each op's new output storages are live from the op until
the storage dies (``weakref.finalize``), so the temporaries' peak is that
of the caching allocator's requests, each rounded up to its 512-byte
granularity.  Tensors that exist before the step (the arguments: state,
batch, cache) are registered by :meth:`OpCounter.add_args` and counted
apart.  An op on DTensors is handed back to DTensor (``NotImplemented``),
which runs it as local ops that are counted; ``dtensor_ops`` counts them
(DTensor's sharding propagation would also run the op at its global shape,
so a step that the counts must trust keeps it at 0).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

ALLOC_GRANULE = 512  # bytes: the CUDA caching allocator rounds each request up to this

#: the reference's ``_ELEMENTWISE`` HLO opcodes, each with its aten ops
ELEMENTWISE = {
    "add": ("add",), "subtract": ("sub", "rsub"), "multiply": ("mul",),
    "divide": ("div", "reciprocal"), "maximum": ("maximum",), "minimum": ("minimum",),
    "abs": ("abs",), "negate": ("neg",), "exponential": ("exp",),
    "exponential-minus-one": ("expm1",), "log": ("log",), "log-plus-one": ("log1p",),
    "tanh": ("tanh",), "rsqrt": ("rsqrt",), "sqrt": ("sqrt",), "power": ("pow",),
    "compare": ("eq", "ne", "lt", "le", "gt", "ge"), "select": ("where",),
    "and": ("logical_and", "bitwise_and"), "or": ("logical_or", "bitwise_or"),
    "xor": ("logical_xor", "bitwise_xor"), "not": ("logical_not", "bitwise_not"),
    "sine": ("sin",), "cosine": ("cos",), "atan2": ("atan2",), "floor": ("floor",),
    "ceil": ("ceil",), "round-nearest-afz": ("round",), "remainder": ("remainder", "fmod"),
    "sign": ("sign",), "logistic": ("sigmoid",), "cbrt": (), "erf": ("erf",),
    "clamp": ("clamp", "clamp_min", "clamp_max"),
}
_ELEMENTWISE_ATEN = frozenset(n for names in ELEMENTWISE.values() for n in names)
#: the ops XLA lowers to a ``reduce``
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "any", "all",
    "logsumexp", "linalg_vector_norm", "norm", "var", "var_mean", "std", "cumsum",
    "cumprod", "_softmax", "_log_softmax",
})
#: ops that move no bytes: views, metadata, allocations without a fill
FREE = frozenset({
    "view", "_unsafe_view", "expand", "permute", "transpose", "t", "slice", "select",
    "unsqueeze", "squeeze", "alias", "detach", "as_strided", "split", "split_with_sizes",
    "unbind", "chunk", "diagonal", "unfold", "view_as_real", "view_as_complex", "lift_fresh",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "device",
    "size", "sym_size", "stride", "sym_stride", "numel", "sym_numel", "dim", "is_contiguous",
    "storage_offset", "sym_storage_offset", "wait_tensor", "barrier", "monitored_barrier",
})
#: in-place ops that write only the rows their source names
PARTIAL_WRITES = frozenset({
    "index_put", "_index_put_impl", "index_add", "index_copy", "scatter", "scatter_add",
    "scatter_reduce", "masked_scatter",
})
_GATHERS = ("all_gather_into_tensor", "allgather_", "_allgather_base_")
_SCATTERS = ("reduce_scatter_tensor", "reduce_scatter_", "_reduce_scatter_base_")
_REDUCES = ("all_reduce", "allreduce_")
_ALL_TO_ALL = ("all_to_all_single", "alltoall_", "alltoall_base_")
_PERMUTES = ("broadcast", "broadcast_")
_COLLECTIVE_NS = ("_c10d_functional", "c10d")


@dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0  # HBM traffic: the operands and results of every op
    coll_bytes: float = 0.0  # per-rank link bytes, ring model
    coll_counts: dict = field(default_factory=dict)
    coll_by_kind_bytes: dict = field(default_factory=dict)

    def add(self, other: "Costs", times: float = 1.0):
        self.flops += other.flops * times
        self.bytes += other.bytes * times
        self.coll_bytes += other.coll_bytes * times
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v * times
        for k, v in other.coll_by_kind_bytes.items():
            self.coll_by_kind_bytes[k] = self.coll_by_kind_bytes.get(k, 0) + v * times


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    """The tensors of a pytree whose leaves may be modules (their
    parameters)."""
    out = []
    for t in tree_leaves(x):
        if isinstance(t, torch.nn.Module):
            out.extend(t.parameters())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _group_size(func, args, kwargs) -> int:
    """n of a collective: its ``group_size`` argument, or the size of its
    process group (a ``ProcessGroup`` or a group name)."""
    schema = func._schema
    vals = dict(zip((a.name for a in schema.arguments), args))
    vals.update(kwargs)
    if "group_size" in vals:
        return int(vals["group_size"])
    pg = vals.get("process_group", vals.get("group_name"))
    if isinstance(pg, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        pg = _resolve_process_group(pg)
    elif isinstance(pg, torch.ScriptObject):  # how a c10d op receives its group
        pg = torch.distributed.ProcessGroup.unbox(pg)
    return int(pg.size())


_DECOMPOSES: dict = {}
_WRITTEN: dict = {}


def _decomposes(func) -> bool:
    """Whether ``func`` has a ``CompositeImplicitAutograd`` kernel (then
    ``FlopCounterMode`` counts its decomposition)."""
    if func not in _DECOMPOSES:
        _DECOMPOSES[func] = func is not torch.ops.prim.device.default and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return _DECOMPOSES[func]


def _written(func) -> tuple:
    """(positions, names) of the arguments ``func`` writes."""
    if func not in _WRITTEN:
        written = [(i, a.name) for i, a in enumerate(func._schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        _WRITTEN[func] = (tuple(i for i, _ in written), frozenset(n for _, n in written))
    return _WRITTEN[func]


def _ceil(n: int) -> int:
    return -(-n // ALLOC_GRANULE) * ALLOC_GRANULE


class OpCounter(TorchDispatchMode):
    """Counts one rank's ops into :attr:`costs` (see the module doc).

    ``matmul_flops`` are the registry ops' FLOPs alone, ``n_ops`` the ops
    seen, ``arg_bytes`` the registered arguments' storage bytes,
    ``temp_peak_bytes`` the peak of the other storages' live bytes (each
    rounded to :data:`ALLOC_GRANULE`)."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.matmul_flops = 0.0
        self.n_ops = 0
        self.dtensor_ops = 0
        self.arg_bytes = 0
        self.temp_peak_bytes = 0
        self._live = 0
        self._storages: set = set()

    def add_args(self, tensors) -> int:
        """Register the storages of ``tensors`` (any pytree; DTensors by
        their local shards) as arguments; returns their bytes."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(tensors):
            t = t.to_local() if isinstance(t, DTensor) else t
            st = t.untyped_storage()
            if st._cdata not in self._storages:
                self._storages.add(st._cdata)
                self.arg_bytes += st.nbytes()
                weakref.finalize(st, self._storages.discard, st._cdata)
        return self.arg_bytes

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = _ceil(st.nbytes())
            self._storages.add(key)
            self._live += n
            self.temp_peak_bytes = max(self.temp_peak_bytes, self._live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self._storages.discard(key)
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self.dtensor_ops += 1
            return NotImplemented  # DTensor runs it as local ops, which come back here
        packet = func._overloadpacket
        if packet not in flop_registry and _decomposes(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if any(t.device.type == "meta" for t in _tensors(out)):
            return out  # shapes only (a fake tensor claims its fake device)
        self.n_ops += 1
        self._count(func, packet, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, packet, args, kwargs, out) -> None:
        c = self.costs
        name = packet.__name__
        base = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        if base in FREE or func.is_view:
            return
        if func.namespace in _COLLECTIVE_NS:
            self._collective(func, name, args, kwargs, out)
            return
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops += f
            self.matmul_flops += f
        elif base in _ELEMENTWISE_ATEN:
            c.flops += sum(t.numel() for t in _tensors(out))
        elif base in REDUCTIONS:
            c.flops += sum(_nbytes(t) for t in _tensors(args)) / 4.0
        c.bytes += self._op_bytes(func, base, args, kwargs, out)

    @staticmethod
    def _op_bytes(func, base, args, kwargs, out) -> float:
        """Bytes read plus bytes written: the tensors an op reads, and its
        outputs; an in-place op reads its destination only if it computes
        from it (elementwise or partial writes), and a partial write writes
        its source's bytes."""
        pos, names = _written(func)
        if not pos:
            return sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        written = {id(t): t for i in pos if i < len(args) for t in _tensors(args[i])}
        written.update((id(t), t) for k in names & kwargs.keys() for t in _tensors(kwargs[k]))
        reads = [t for t in _tensors((args, kwargs)) if id(t) not in written]
        read = sum(_nbytes(t) for t in reads)
        if base in PARTIAL_WRITES:
            src = [t for t in reads if t.is_floating_point() or t.dtype == torch.bool] or reads
            return read + max((_nbytes(t) for t in src), default=0)
        dest = sum(_nbytes(t) for t in written.values())
        return read + dest * (2 if base in _ELEMENTWISE_ATEN else 1)

    def _collective(self, func, name, args, kwargs, out) -> None:
        """Ring-model link bytes of one collective.  The functional ops
        take their input first and return their output; the ``c10d`` ops
        write outputs given first (``output_tensors``, ``output``) from
        inputs given second, or work in place on the tensors given first."""
        if func.namespace == "_c10d_functional":
            ins, outs = args[0], out
        elif func._schema.arguments[0].name.startswith("output"):
            ins, outs = args[1], args[0]
        else:
            ins = outs = args[0]
        in_b = sum(_nbytes(t) for t in _tensors(ins))
        out_b = sum(_nbytes(t) for t in _tensors(outs))
        n = _group_size(func, args, kwargs)
        if name in _GATHERS:
            kind, link = "all-gather", max(out_b - in_b, 0)
        elif name in _SCATTERS:
            kind, link = "reduce-scatter", max(in_b - out_b, 0)
        elif name in _REDUCES:
            kind, link = "all-reduce", 2.0 * in_b * (n - 1) / max(n, 1)
        elif name in _ALL_TO_ALL:
            kind, link = "all-to-all", in_b * (n - 1) / max(n, 1)
        elif name in _PERMUTES:
            kind, link = "collective-permute", in_b
        else:
            raise NotImplementedError(f"collective {func} has no cost rule")
        c = self.costs
        c.coll_bytes += link
        c.coll_counts[kind] = c.coll_counts.get(kind, 0) + 1
        c.coll_by_kind_bytes[kind] = c.coll_by_kind_bytes.get(kind, 0) + link
        c.bytes += in_b + out_b
