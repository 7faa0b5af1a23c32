"""Render dry-run sweep JSONs as a roofline table.

    python -m repro_torch.launch.report dryrun_single_pod.json [--md]

The counterpart of ``repro.launch.report``, without its "TPU GB" column
(the port's dry-run records no bf16-legalization projection).
"""
from __future__ import annotations

import argparse
import json

HEADER = ["arch", "shape", "GB/chip", "t_comp", "t_mem", "t_coll", "bottleneck", "useful",
          "rl_frac"]


def render(rows: list, md: bool = False) -> str:
    lines = []
    hdr = HEADER
    if md:
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    else:
        lines.append(f"{hdr[0]:22s} {hdr[1]:12s} " + " ".join(f"{h:>9s}" for h in hdr[2:]))
    n_ok = n_skip = n_err = 0
    for r in rows:
        if r["status"] == "skip":
            n_skip += 1
            cells = [r["arch"], r["shape"]] + ["—"] * 6 + ["SKIP"]
        elif r["status"] == "error":
            n_err += 1
            cells = [r["arch"], r["shape"]] + ["—"] * 6 + ["ERROR"]
        else:
            n_ok += 1
            rl = r["roofline"]
            cells = [
                r["arch"], r["shape"], f"{r['per_chip_gb']:.2f}",
                f"{rl['t_compute']:.3g}", f"{rl['t_memory']:.3g}",
                f"{rl['t_collective']:.3g}", rl["bottleneck"],
                f"{rl['useful_flop_ratio']:.3f}", f"{rl['roofline_frac']:.4f}",
            ]
        if md:
            lines.append("| " + " | ".join(cells) + " |")
        else:
            lines.append(f"{cells[0]:22s} {cells[1]:12s} "
                         + " ".join(f"{c:>9s}" for c in cells[2:]))
    lines.append(f"\n{n_ok} ok, {n_skip} skip, {n_err} error")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--md", action="store_true", help="markdown output")
    args = ap.parse_args()
    with open(args.path) as f:
        rows = json.load(f)
    print(render(rows, args.md))


if __name__ == "__main__":
    main()
