"""Training launcher, on the card unless ``--device cpu``:

    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --device cpu --steps 3
    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --ckpt-dir /tmp/ck

The counterpart of ``repro.launch.train``, with its flags plus
``--device``: it builds the train state (float32 parameters and moments,
compute in ``cfg.dtype``) and runs the training loop, under the
checkpointing supervisor when ``--ckpt-dir`` is given.  One card and no
mesh: the reference's ``make_host_mesh`` and
``set_activation_batch_axes`` wait for the multi-card port (ROADMAP Queue
1); the first line names the device where the reference names its mesh.
Weights are random from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core.relation import resolve_device
from repro_torch.data import synthetic
from repro_torch.ft import supervisor
from repro_torch.train import optimizer, train_step as ts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    opt_cfg = optimizer.OptConfig(
        lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1), total_steps=args.steps
    )
    state = ts.init_state(cfg, args.seed, opt_cfg, compress_frac=args.compress, device=device)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device} "
          f"batch={args.batch} seq={args.seq}")

    step_fn = ts.make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                                 compress_frac=args.compress)
    batch_fn = synthetic.make_batch_fn(cfg, args.batch, args.seq, seed=args.seed, device=device)

    if args.ckpt_dir:
        state, hist = supervisor.run_train_loop(
            state, step_fn, batch_fn, steps=args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
        )
        for s, l in hist:
            print(f"step {s:5d} loss {l:.4f}")
    else:
        t0 = time.time()
        for step in range(args.steps):
            state, metrics = step_fn(state, batch_fn(step))
            if (step + 1) % 10 == 0 or step == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                tok_s = (step + 1) * args.batch * args.seq / dt
                print(f"step {step+1:5d} loss {loss:.4f} ({tok_s:,.0f} tok/s)", flush=True)
    print("done")


if __name__ == "__main__":
    main()
