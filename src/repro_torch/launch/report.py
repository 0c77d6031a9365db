"""Aggregate dry-run JSONs into the roofline table.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun]

Counterpart of ``repro.launch.report``; the default mesh is the port's
production mesh, "32x8" (a node's 8 cards on the model axis).
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(d: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def fmt_table(cells: list[dict], mesh: str = "16x16") -> str:
    rows = []
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "bottleneck | useful ratio | roofline MFU | temp GB/chip |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for c in cells:
        if c.get("mesh") != mesh or "roofline" not in c:
            continue
        r = c["roofline"]
        if "compute_s" not in r:
            continue
        temp = c.get("memory", {}).get("temp_size_in_bytes", 0) / 2 ** 30
        rows.append(
            f"| {c['arch']} | {c.get('shape','-')} "
            f"| {r['compute_s']:.3g} | {r['memory_s']:.3g} "
            f"| {r['collective_s']:.3g} | {r.get('bottleneck','-')} "
            f"| {r.get('useful_flops_ratio',0):.2f} "
            f"| {r.get('roofline_mfu',0):.3f} | {temp:.1f} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="32x8")
    args = ap.parse_args()
    cells = load_cells(args.dir)
    print(fmt_table(cells, args.mesh))


if __name__ == "__main__":
    main()
