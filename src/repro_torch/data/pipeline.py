"""SGF-powered corpus filtering — where the paper's engine meets the LM.

The counterpart of ``repro.data.pipeline``.  Corpus curation *is* a
multi-semi-join workload: "keep documents whose fingerprints are not in
the dedup list, whose domain is not blocked, and that pass quality" is the
SGF query

    Keep := SELECT (doc, domain, h1, h2) FROM Docs(doc, domain, h1, h2)
            WHERE NOT Dup(h1) AND NOT Dup(h2)
              AND NOT Blocked(domain) AND Quality(doc);

evaluated with the same MSJ/EVAL plans (PAR / GREEDY / 1-ROUND) the paper
benchmarks, by the port's planner and executor on ``SimComm(P)``.  On the
card each MSJ job's ``probe_backend="auto"`` resolves to the hash-join
kernel (``kernels/msj_probe/csrc/probe_hash.cu``).  The kept document ids
drive the training data loader.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algebra import BSGF, Atom, Not, all_of
from repro_torch.core.costmodel import HADOOP, stats_of_db
from repro_torch.core.executor import execute_plan
from repro_torch.core.planner import plan_greedy, plan_one_round, plan_par
from repro_torch.core.relation import db_from_dict
from repro_torch.engine.comm import SimComm


def keep_query() -> BSGF:
    return BSGF(
        "Keep",
        ("doc", "domain", "h1", "h2"),
        Atom("Docs", "doc", "domain", "h1", "h2"),
        all_of(
            Not(Atom("Dup", "h1")),
            Not(Atom("Dup", "h2")),
            Not(Atom("Blocked", "domain")),
            Atom("Quality", "doc"),
        ),
    )


def plan_for(db, strategy: str):
    q = keep_query()
    if strategy == "par":
        return plan_par([q])
    if strategy == "greedy":
        return plan_greedy([q], stats_of_db(db), HADOOP)
    return plan_one_round([q])


def kept_ids(keep) -> torch.Tensor:
    """The sorted, distinct doc ids of the ``Keep`` relation's valid rows,
    int64, on its device: the reference's ``sorted(to_set())`` doc column."""
    return torch.unique(keep.data[..., 0][keep.valid]).to(torch.int64)


def filter_corpus(
    relations: dict[str, np.ndarray],
    *,
    P: int = 8,
    strategy: str = "one_round",
    device=None,
) -> tuple[torch.Tensor, dict]:
    """Evaluate the keep-query on ``device`` (the card unless
    ``device="cpu"``); returns (kept doc ids, executor summary)."""
    db = db_from_dict(relations, P=P, device=device)
    env, report = execute_plan(db, plan_for(db, strategy), SimComm(P))
    return kept_ids(env["Keep"]), report.summary()
