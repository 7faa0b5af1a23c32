"""Fixed-capacity relation storage.

A :class:`Relation` holds facts as a dense ``(P, cap, arity)`` int32 tensor
plus a ``(P, cap)`` bool validity mask, where ``P`` is the number of row
shards (the engine's "reducer count"). ``P == 1`` is the local/unsharded
case.

Hadoop relations are unbounded files; here every relation has a static
capacity and a validity mask, and *overflow is detected exactly* (counts
are computed with integer reductions) and surfaced to the fault
supervisor.

Device placement: every constructor takes ``device``; ``None`` means the
CUDA card and raises when there is none (the engine never falls back to
the CPU on its own — callers that want the CPU say ``device="cpu"``).
Derived relations follow the device of the tensors they are built from.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.engine import hashing


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass(frozen=True)
class Relation:
    name: str
    data: torch.Tensor  # (P, cap, arity) int32
    valid: torch.Tensor  # (P, cap) bool

    # -- shape accessors ---------------------------------------------------
    # Shapes are read from the trailing dims so the same accessors work on
    # the stacked (P, cap, arity) form and on shard-local (cap, arity) views
    # inside the per-shard stage functions.
    @property
    def P(self) -> int:
        return self.data.shape[0] if self.data.ndim == 3 else 1

    @property
    def cap(self) -> int:
        return self.data.shape[-2]

    @property
    def arity(self) -> int:
        return self.data.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_numpy(
        cls,
        name: str,
        rows: np.ndarray,
        *,
        P: int = 1,
        cap: int | None = None,
        partition: str = "block",
        device=None,
    ) -> "Relation":
        """Build a sharded relation from an ``(n, arity)`` numpy array.

        ``partition='block'`` round-robins rows over shards; ``'hash'``
        routes by a hash of the full tuple (used to co-partition for EVAL).
        Within a shard rows keep their source order (a stable placement).
        """
        dev = resolve_device(device)
        rows = np.asarray(rows, dtype=np.int32)
        if rows.ndim == 1:
            rows = rows[:, None]
        n, arity = rows.shape
        if partition == "block":
            dest = np.arange(n) % P
            pos = np.arange(n) // P
        elif partition == "hash":
            h = hashing.hash_cols(torch.from_numpy(rows)).numpy()
            dest = h % P
            order = np.argsort(dest, kind="stable")
            starts = np.concatenate([[0], np.cumsum(np.bincount(dest, minlength=P))[:-1]])
            pos = np.empty(n, np.int64)
            pos[order] = np.arange(n) - starts[dest[order]]
        else:
            raise ValueError(partition)
        per = np.bincount(dest, minlength=P)
        if cap is None:
            cap = max(1, int(per.max()) if n else 1)
        if int(per.max() if n else 0) > cap:
            raise ValueError(f"capacity {cap} overflows shard load {per.max()}")
        data = np.zeros((P, cap, arity), np.int32)
        valid = np.zeros((P, cap), bool)
        data[dest, pos] = rows
        valid[dest, pos] = True
        return cls(name, torch.from_numpy(data).to(dev), torch.from_numpy(valid).to(dev))

    @classmethod
    def from_reference(
        cls, name: str, data: np.ndarray, valid: np.ndarray, *, device=None
    ) -> "Relation":
        """Take a reference relation's ``data``/``valid`` arrays (as numpy)
        with their placement unchanged — how two engines are given the
        same sharded state."""
        dev = resolve_device(device)
        # a writable copy: the tensors must not alias the reference's arrays
        data = np.array(data, dtype=np.int32, order="C", copy=True)
        valid = np.array(valid, dtype=bool, order="C", copy=True)
        return cls(name, torch.from_numpy(data).to(dev), torch.from_numpy(valid).to(dev))

    @classmethod
    def from_tuples(cls, name: str, tuples: Iterable[Sequence[int]], **kw) -> "Relation":
        rows = np.asarray([tuple(t) for t in tuples], dtype=np.int32)
        if rows.size == 0:
            rows = rows.reshape(0, 1)
        return cls.from_numpy(name, rows, **kw)

    @classmethod
    def empty(
        cls, name: str, arity: int, *, P: int = 1, cap: int = 1, device=None
    ) -> "Relation":
        dev = resolve_device(device)
        return cls(
            name,
            torch.zeros((P, cap, arity), dtype=torch.int32, device=dev),
            torch.zeros((P, cap), dtype=torch.bool, device=dev),
        )

    # -- conversion (host side; tests/debug) --------------------------------
    def to_set(self) -> set[tuple[int, ...]]:
        data = self.data.reshape(-1, self.arity).cpu().numpy()
        valid = self.valid.reshape(-1).cpu().numpy()
        return {tuple(int(v) for v in row) for row in data[valid]}

    def rename(self, name: str) -> "Relation":
        return replace(self, name=name)

    def with_mask(self, mask: torch.Tensor, name: str | None = None) -> "Relation":
        """Restrict validity (e.g. materializing a semi-join result)."""
        return Relation(name or self.name, self.data, self.valid & mask)

    def local(self, p: int) -> "Relation":
        """Shard-local view (what a per-shard stage function sees)."""
        return Relation(self.name, self.data[p], self.valid[p])

    def compacted(self, cap: int | None = None) -> "Relation":
        """Pack valid rows to the front of each shard and shrink capacity.

        The target capacity is host-chosen (executor jobs are separate
        dispatches, so the sync is free); rows never move across shards.
        Keeps intermediate relations from inflating downstream shuffle
        buffers (Hadoop's "data size reduced after each step", adapted).
        """
        data = self.data if self.data.ndim == 3 else self.data[None]
        valid = self.valid if self.valid.ndim == 2 else self.valid[None]
        if cap is None:
            per_shard = int(valid.sum(dim=1).max()) if valid.numel() else 0
            cap = max(1, int(2 ** np.ceil(np.log2(max(per_shard, 1)))))
        # sorting a bool tensor is not supported on CUDA: sort its 0/1 bytes
        order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :cap]
        new_data = torch.take_along_dim(data, order[:, :, None], dim=1)
        new_valid = torch.take_along_dim(valid, order, dim=1)
        # Zero the tail beyond the packed rows: invalid slots otherwise carry
        # whatever the producing job left there, which would make otherwise
        # identical outputs differ bit-wise across job compositions
        # (failure-narrowed jobs must reproduce the fault-free arrays).
        new_data = torch.where(new_valid[:, :, None], new_data, 0)
        return Relation(self.name, new_data, new_valid)


Database = dict  # name -> Relation


def db_from_dict(
    rels: dict[str, np.ndarray | list], *, P: int = 1, cap: int | None = None,
    device=None,
) -> Database:
    dev = resolve_device(device)
    out = {}
    for name, rows in rels.items():
        if isinstance(rows, np.ndarray):
            out[name] = Relation.from_numpy(name, rows, P=P, cap=cap, device=dev)
        else:
            out[name] = Relation.from_tuples(name, rows, P=P, cap=cap, device=dev)
    return out


def db_from_reference(
    rels: dict[str, tuple[np.ndarray, np.ndarray]], *, device=None
) -> Database:
    """``{name: (data, valid)}`` numpy arrays of a reference database ->
    a :class:`Relation` dict with the identical placement."""
    dev = resolve_device(device)
    return {
        name: Relation.from_reference(name, data, valid, device=dev)
        for name, (data, valid) in rels.items()
    }
