"""The paper's engine as a production data pipeline: corpus curation as
a multi-semi-join workload, comparing evaluation strategies.

    Keep := SELECT * FROM Docs(doc,domain,h1,h2)
            WHERE NOT Dup(h1) AND NOT Dup(h2)
              AND NOT Blocked(domain) AND Quality(doc)

The relations live on the card unless ``--device cpu``; the kept ids are
an int64 tensor there.

Run:  PYTHONPATH=src python -m repro_torch.examples.data_pipeline [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.relation import resolve_device
from repro_torch.data import pipeline, synthetic

STRATEGIES = ("par", "greedy", "one_round")


def filter_all(rels, *, P: int = 8, strategies=STRATEGIES, device=None) -> list[dict]:
    """The Keep query under each strategy; every strategy must keep the
    same ids.  Returns one dict per strategy: its kept ids, summary and
    wall (host clock; the kept ids' distinct sort waits for the device)."""
    out, baseline = [], None
    for strategy in strategies:
        t0 = time.time()
        kept, summary = pipeline.filter_corpus(rels, P=P, strategy=strategy, device=device)
        dt = time.time() - t0
        if baseline is None:
            baseline = kept
        assert torch.equal(kept, baseline), "strategies disagree!"
        print(f"{strategy:10s}: kept {len(kept):6d} docs  jobs={summary['jobs']}  "
              f"shuffled={summary['bytes_shuffled']:9d}B  wall={dt:5.2f}s")
        out.append({"strategy": strategy, "kept": kept, "summary": summary, "wall": dt})
    print("all strategies agree ✓")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rels = synthetic.corpus_relations(16384, dup_frac=0.25, blocked_frac=0.15, seed=3)
    print(f"corpus: {len(rels['Docs'])} docs, {len(rels['Dup'])} dup hashes, "
          f"{len(rels['Blocked'])} blocked domains")
    runs = filter_all(rels, P=8, device=device)
    return {
        "device": str(device), "docs": len(rels["Docs"]), "dup_hashes": len(rels["Dup"]),
        "blocked_domains": len(rels["Blocked"]),
        "strategies": {r["strategy"]: {"kept": len(r["kept"]), "jobs": r["summary"]["jobs"],
                                       "bytes_shuffled": r["summary"]["bytes_shuffled"],
                                       "wall": r["wall"]} for r in runs},
    }


if __name__ == "__main__":
    main()
