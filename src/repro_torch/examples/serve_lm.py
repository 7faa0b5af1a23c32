"""Serve a small model with continuously-batched requests.

Mixed-length prompts arrive in a queue; the batcher fills decode slots,
prefills each prompt, and steps all active slots together (per-slot
position clocks).  Outputs are verified against unbatched generation.
Float32 SMOKE weights from seed 0, on the card (TF32 off) unless
``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch falcon-mamba-7b [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.relation import resolve_device
from repro_torch.models import model
from repro_torch.serve.batcher import Batcher, Request
from repro_torch.serve.serve_step import greedy_generate

MAX_BATCH, MAX_LEN = 3, 96


def make_requests(cfg, n: int, max_new: int, *, seed: int = 0) -> list[Request]:
    """``n`` prompts of 4–23 tokens drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 24))
        reqs.append(Request(i, rng.integers(0, cfg.vocab, plen).astype(np.int32), max_new))
    return reqs


def serve(cfg, params, reqs, *, verify: bool = True) -> float:
    """Every request through one batcher of ``MAX_BATCH`` slots, each
    checked against unbatched generation; returns the batcher's wall."""
    b = Batcher(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN)
    for r in reqs:
        b.submit(r)
    t0 = time.time()
    b.run()  # each decode wave reads its tokens back to the host
    dt = time.time() - t0
    print(f"served {len(reqs)} requests in {dt:.2f}s")
    for r in reqs:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
        if verify:
            batch = {"tokens": torch.as_tensor(r.prompt[None, :], dtype=torch.int64,
                                               device=params.device)}
            want = greedy_generate(cfg, params, batch, steps=r.max_new, max_len=MAX_LEN)[0]
            assert want.tolist() == r.out, f"req {r.rid} mismatch"
    print("continuous batching matches unbatched generation ✓")
    return dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--verify", action="store_true", default=True)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True, dtype="float32")
    if cfg.family == "vlm" or cfg.family == "audio":
        raise SystemExit(f"{cfg.family} serving needs frontend embeds")
    device = resolve_device(args.device)
    if device.type == "cuda":  # float32 as on the host
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = model.init_params(cfg, 0, device=device)
    reqs = make_requests(cfg, args.requests, args.max_new)
    dt = serve(cfg, params, reqs, verify=args.verify)
    return {"device": str(device), "arch": cfg.name, "requests": len(reqs), "seconds": dt,
            "tokens": [r.out for r in reqs]}


if __name__ == "__main__":
    main()
