"""Relations of a configuration, drawn on the device from the seed.

The distribution is the paper's selectivity knob (Daenen et al., PVLDB
2016, §5.4): every guard column is uniform over ``[0, domain)`` with
``domain = max(rows // 4, 16)``; a conditional relation's key column (its
first) takes ``round(rows * sel)`` values from ``[0, round(domain * sel))``,
the guard's low range, and the rest from the disjoint ``[domain,
2 * domain)``, in a random order, so about ``sel`` of the guard's values
find a match.  Further columns of a conditional are uniform over
``[0, domain)``.

Every seed gives the program the same rows in another order.  A relation
version's values are drawn from ``(name, version)`` alone; the seed draws
their order, a permutation within each of the ``shards`` shards the program
lays them out in (row ``i`` in shard ``i % shards``), so every shard holds
the same rows whatever the seed and every size the program derives from
them is the same.  Runs whose values were drawn from the seed differed by
several per cent at the same sizes, twice as much as two runs of one
seed.  The same seed gives the same rows on every run, and a relation can
be drawn again without drawing the others.
"""
from __future__ import annotations

import hashlib

import torch


#: the seed of every relation's values (the run's seed orders them)
VALUES_SEED = 0


def key_domain(rows: int) -> int:
    return max(rows // 4, 16)


def sub_seed(seed: int, name: str, version: int = 0) -> int:
    """A 63-bit seed for one relation version, the same in every process."""
    digest = hashlib.sha256(f"{int(seed)}/{name}/{int(version)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def relation_rows(
    name: str, arity: int, role: str, rows: int, sel: float, seed: int,
    version: int = 0, device="cpu", shards: int = 1,
) -> torch.Tensor:
    """The ``(rows, arity)`` int32 rows of one relation version, in the
    seed's order within each of ``shards`` shards."""
    if rows % shards:
        raise ValueError(f"relation {name}: {rows} rows do not split into {shards} shards")
    values = _values(name, arity, role, rows, sel, version, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, name, version))
    position = torch.rand((rows // shards, shards), generator=gen, device=device).argsort(dim=0)
    return values[(position * shards + torch.arange(shards, device=device)).reshape(-1)]


def _values(name: str, arity: int, role: str, rows: int, sel: float, version: int,
            device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(VALUES_SEED, name, version))
    domain = key_domain(rows)
    if role == "guard":
        return torch.randint(0, domain, (rows, arity), generator=gen, device=device,
                             dtype=torch.int32)
    if role != "conditional":
        raise ValueError(f"relation {name}: unknown role {role!r}")
    lo = max(1, int(round(domain * sel)))
    n_match = int(round(rows * sel))
    keys = torch.cat([
        torch.randint(0, lo, (n_match,), generator=gen, device=device, dtype=torch.int32),
        torch.randint(domain, 2 * domain, (rows - n_match,), generator=gen, device=device,
                      dtype=torch.int32),
    ])
    keys = keys[torch.randperm(rows, generator=gen, device=device)]
    if arity == 1:
        return keys[:, None]
    rest = torch.randint(0, domain, (rows, arity - 1), generator=gen, device=device,
                         dtype=torch.int32)
    return torch.cat([keys[:, None], rest], dim=1)


def config_rows(config: dict, seed: int, versions: dict | None = None,
                device="cpu") -> dict[str, torch.Tensor]:
    """Every relation of ``config`` at the given versions (default 0), in
    the seed's order within each of its ``P`` shards."""
    versions = versions or {}
    return {
        name: relation_rows(name, rel["arity"], rel["role"], config["rows"], config["sel"],
                            seed, versions.get(name, 0), device, config["P"])
        for name, rel in sorted(config["relations"].items())
    }
