"""Serving launcher: continuous-batched greedy decoding over synthetic
requests, on the card unless ``--device cpu``.

    python -m repro_torch.launch.serve --arch qwen3-0.6b
    python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
    python -m repro_torch.launch.serve --arch olmoe-1b-7b        # MoE
    python -m repro_torch.launch.serve --arch falcon-mamba-7b    # SSM
    python -m repro_torch.launch.serve --arch zamba2-7b          # hybrid

The counterpart of ``repro.launch.serve``: every family that serves from
tokens alone (dense, MoE, SSM, hybrid); like the reference it refuses the
VLM and enc-dec families, which need frontend embeddings.  Weights are
random from ``--seed``.
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "vlm" or cfg.family == "audio":
        raise SystemExit(f"{cfg.family} serving needs frontend embeds")
    device = resolve_device(args.device)
    params = model.init_params(cfg, args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    b = Batcher(cfg, params, max_batch=args.max_batch, max_len=args.max_len)
    for i in range(args.requests):
        plen = int(rng.integers(4, args.max_len // 4))
        b.submit(Request(i, rng.integers(0, cfg.vocab, plen).astype(np.int32), args.max_new))
    t0 = time.perf_counter()
    waves = 0
    while b.queue or any(s is not None for s in b.slots):
        b.step()
        waves += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_new = args.requests * args.max_new
    print(f"served {args.requests} requests / {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:,.0f} tok/s, {waves} decode waves) on {device}")


if __name__ == "__main__":
    main()
