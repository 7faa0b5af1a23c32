"""Elastic rescaling and shard-loss recovery for engine relations.

* **Engine relations** — :func:`repartition_relation` re-partitions an
  SGF relation's rows over a new shard count (P changes with cluster
  size); row placement is hash/block-based so results are identical.
* **Shard loss + lineage recovery** (DESIGN.md §13) —
  :func:`lose_shard` simulates losing one partition of an in-memory
  relation (what a :class:`repro_torch.core.executor.ShardLoss` injector
  does before raising); :func:`recover_shard` re-materializes that
  partition bit-identically from a durable lineage source (the catalog's
  resident rows in the service).

Every function returns *new* tensors and never writes into its inputs: the
tensors of one relation are shared by the catalog, the executor's
environment and its lineage, so an in-place ``data[shard] = 0`` would
damage the durable source and recovery would restore zeros.  Results stay
on the device of the relation they are built from.

The model-state half of the reference module (``reshard_state``) waits for
the port's model zoo.
"""
from __future__ import annotations

import torch

from repro_torch.core.relation import Relation


def repartition_relation(rel: Relation, new_P: int, *, partition: str = "block") -> Relation:
    # Emit rows in round-robin insertion order — (P, cap) transposed to
    # (cap, P) — the inverse of from_numpy's block fill.  A pristine
    # block-partitioned relation therefore repartitions to the *canonical*
    # placement at the new P (same rows land on the same shards as a fresh
    # from_numpy build), which shard-loss lineage recovery relies on.
    rows = rel.data.transpose(0, 1).reshape(-1, rel.arity)
    valid = rel.valid.transpose(0, 1).reshape(-1)
    return Relation.from_numpy(
        rel.name, rows[valid].cpu().numpy(), P=new_P, partition=partition,
        device=rel.data.device,
    )


def repartition_db(db: dict, new_P: int) -> dict:
    return {name: repartition_relation(r, new_P) for name, r in db.items()}


def _with_shard(rel: Relation, shard: int, data: torch.Tensor, valid: torch.Tensor) -> Relation:
    """A copy of ``rel`` whose partition ``shard`` holds ``data``/``valid``
    (the out-of-place ``.at[shard].set`` of the reference)."""
    new_data = rel.data.clone()
    new_valid = rel.valid.clone()
    new_data[shard] = data
    new_valid[shard] = valid
    return Relation(rel.name, new_data, new_valid)


def lose_shard(rel: Relation, shard: int) -> Relation:
    """Simulate losing partition ``shard``: its rows are zeroed and its
    validity mask cleared, exactly what a dead reducer leaves behind in
    cluster memory.  The relation stays well-formed (the engine computes
    on it without error — just silently wrong), which is why
    :class:`~repro_torch.core.executor.ShardLoss` must be *raised* alongside.
    ``rel`` itself is left intact."""
    if not 0 <= shard < rel.P:
        raise ValueError(f"shard {shard} out of range for P={rel.P}")
    return _with_shard(rel, shard, 0, False)


def recover_shard(
    damaged: Relation, source: Relation, shard: int, *, partition: str = "block"
) -> Relation:
    """Re-materialize partition ``shard`` of ``damaged`` from the durable
    ``source`` (MapReduce lineage: re-run the map split, not the job).

    When ``source`` is resident at the same P and cap, the shard is
    spliced back verbatim — bit-identical to the pre-loss copy, gaps in
    the validity mask included.  A source at a different shape (the
    elastic case: lineage kept at old P after a rescale) is first
    re-partitioned to ``damaged.P`` and its valid rows front-packed into
    the shard, which preserves row *content* but not slot layout.
    Neither ``damaged`` nor ``source`` is written."""
    if damaged.arity != source.arity:
        raise ValueError(
            f"arity mismatch: damaged {damaged.arity} vs lineage {source.arity}"
        )
    if not 0 <= shard < damaged.P:
        raise ValueError(f"shard {shard} out of range for P={damaged.P}")
    if source.P != damaged.P:
        source = repartition_relation(source, damaged.P, partition=partition)
    dev = damaged.data.device
    if source.cap == damaged.cap:
        sdata, svalid = source.data[shard].to(dev), source.valid[shard].to(dev)
    else:
        packed = source.data[shard][source.valid[shard]].to(dev)
        if len(packed) > damaged.cap:
            raise ValueError(
                f"recovered shard load {len(packed)} overflows capacity "
                f"{damaged.cap} of {damaged.name!r}"
            )
        sdata = torch.zeros((damaged.cap, damaged.arity), dtype=torch.int32, device=dev)
        svalid = torch.zeros((damaged.cap,), dtype=torch.bool, device=dev)
        sdata[: len(packed)] = packed
        svalid[: len(packed)] = True
    return _with_shard(damaged, shard, sdata, svalid)
