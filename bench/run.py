#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card.

    python3 bench/run.py --workload a3.one_round --seed 7 --seconds 10 --trace 0

Prints the result as one JSON line, the last of standard output, and the
numbers its ``correct`` compared, each with its limit, as the last lines of
standard error.  ``--trace 1`` measures the per-layer metrics instead of
the end-to-end ones.  Exits with 2, printing no result, without a CUDA card
or with fewer cards than the cell asks for, and with 3 if a module of JAX
or of the JAX package (``repro``) was loaded.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches of the build tools, at fixed paths inside the checkout (the port's
# own kernel libraries go to src/repro_torch/kernels/_build/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def process_age() -> float:
    """Seconds since this process started (``/proc``, 10 ms steps), or
    since this file was first executed where ``/proc`` says otherwise."""
    since_start = time.time() - T_START
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return since_start
    return age if since_start - 0.05 <= age <= since_start + 60 else since_start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # set-up's parts, each as the process's age where it ended
    marks = [("interpreter", process_age())]

    import torch

    marks.append(("import torch", process_age()))
    from bench import harness

    cell = harness.cell_parts(harness.load_manifest(ROOT), args.workload, ROOT)["cell"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.cuda.synchronize()  # the CUDA context
    marks.append(("CUDA context", process_age()))
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                              root=ROOT, process_age=process_age, marks=marks)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, n in result["check"].items():
        limit = " ".join(f"{k} {v}" for k, v in n.items() if k != "value")
        print(f"check {name} {n['value']} {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
