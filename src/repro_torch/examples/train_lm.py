"""End-to-end driver: SGF-filtered data pipeline → LM training.

1. Build a synthetic corpus's metadata relations and filter them with the
   paper's MSJ engine (the Keep query — data/pipeline.py).
2. Train a ~smoke-scale model of the chosen architecture for a few
   hundred steps on the surviving documents, with checkpointing.

On the card unless ``--device cpu``; the train step runs eagerly.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --arch qwen3-0.6b --steps 200 [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.relation import resolve_device
from repro_torch.data import pipeline, synthetic
from repro_torch.ft import supervisor
from repro_torch.train import optimizer, train_step as ts


def curate(n_docs: int = 4096, *, seed: int = 1, P: int = 8, device=None):
    """Stage 1: the Keep query, 1-ROUND, over ``n_docs`` documents; returns
    (kept ids on ``device``, executor summary)."""
    rels = synthetic.corpus_relations(n_docs, seed=seed)
    kept, summary = pipeline.filter_corpus(rels, P=P, strategy="one_round", device=device)
    print(f"[pipeline] kept {len(kept)}/{n_docs} docs "
          f"(jobs={summary['jobs']}, shuffled={summary['bytes_shuffled']}B)")
    return kept, summary


def kept_batch_fn(cfg, kept, batch: int, seq: int, device):
    """Token batches seeded from doc ids drawn from the kept set (one host
    copy of it, made here)."""
    kept = kept.cpu().numpy()

    def batch_fn(step):
        # sample doc ids from the kept set to seed the token stream
        rng = np.random.default_rng(np.random.SeedSequence([7, step]))
        seeds = rng.choice(kept, size=batch)
        return synthetic.token_batch(cfg, "train", batch, seq, step, seed=int(seeds[0]),
                                     device=device)

    return batch_fn


def train(cfg, opt_cfg, state, batch_fn, *, steps: int, log_every: int = 10):
    """Stage 2: ``steps`` eager train steps from ``state`` through the
    checkpointing supervisor (a checkpoint every quarter, in a temporary
    directory); returns (state, [(step, loss)] every ``log_every`` steps,
    seconds)."""
    step_fn = ts.make_train_step(cfg, opt_cfg)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.time()
        state, hist = supervisor.run_train_loop(
            state, step_fn, batch_fn, steps=steps,
            ckpt_dir=ckpt_dir, ckpt_every=max(steps // 4, 1), log_every=log_every,
        )
        dt = time.time() - t0
    return state, hist, dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- stage 1: the paper's engine curates the corpus -------------------
    kept, summary = curate(4096, seed=1, P=8, device=device)

    # --- stage 2: train on the surviving stream ---------------------------
    cfg = get_config(args.arch, smoke=not args.full)
    opt_cfg = optimizer.OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    state = ts.init_state(cfg, 0, opt_cfg, device=device)
    n = sum(p.numel() for p in state["params"].parameters())
    print(f"[train] {cfg.name}: {n/1e6:.2f}M params")
    batch_fn = kept_batch_fn(cfg, kept, args.batch, args.seq, device)
    state, hist, dt = train(cfg, opt_cfg, state, batch_fn, steps=args.steps)
    first, last = hist[0][1], hist[-1][1]
    print(f"[train] loss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({args.steps*args.batch*args.seq/dt:,.0f} tok/s)")
    assert last < first, "loss did not improve"
    print("ok ✓")
    return {"device": str(device), "kept": len(kept), "jobs": summary["jobs"],
            "bytes_shuffled": summary["bytes_shuffled"], "arch": cfg.name, "params": n,
            "steps": args.steps, "losses": hist, "seconds": dt,
            "tokens_per_s": args.steps * args.batch * args.seq / dt}


if __name__ == "__main__":
    main()
