#!/usr/bin/env python3
"""Time the port's three kernels of two checkouts on one card, and compare their bits.

    python3 tools/ab_kernels.py --parent DIR [--rounds 2] [--out PATH]

``DIR`` is another checkout of this repository (for example the parent
commit, unpacked with ``git archive``); its kernels are built under the
temporary directory, not in ``DIR``.  Both packages are named
``repro_torch``, so each measurement runs in a process of its own, in the
order parent, change, change, parent, ``--rounds`` times, on the same
seeded inputs, with ``chip_smoke.py``'s timing helpers:

* ``adc_lookup`` at a graph search round's shape (138 x 48 uint8 codes, a
  48 x 256 table), at 200,000 x 48 and at 200,000 x 120, each on the path
  its wrapper picks: the time a call in a loop of calls (CUDA events; the
  wrapper's host rate when the kernel is shorter), the kernel's device
  time from the profiler (divided by the kernels it recorded) and the time
  a call in a CUDA graph of 200;
* ``l2_topk`` at the closure shape (4096 x 214,790 x 96, k = 8) and the
  ground-truth shape (512 x 1,000,000 x 96, k = 10) on normal random data;
* ``l2_distance`` at the centroid probe's shape (512 x 214,790 x 96) on
  normal random data, float32 (timed) and the same data in bfloat16.

Each run also writes a sha256 of every ``l2_topk`` and ``l2_distance``
output.  Prints one JSON line per run, the card's name and power limit, and
a last line with the medians of each side and, per output, whether every
run of both sides gave the same bits.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ADC_SHAPES = {"round": (138, 48), "n200k_m48": (200_000, 48),
              "n200k_m120": (200_000, 120)}


def worker(src: Path) -> dict:
    """Measure the kernels of the package under ``src`` in this process."""
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    from chip_smoke import graph_ms, kernel_device_ms, time_ms
    from repro_torch.kernels import _build, distance, fused_topk, pq_adc

    if src.resolve() != (ROOT / "src").resolve():
        _build.BUILD_DIR = Path(tempfile.gettempdir()) / "repro_ab_kernels_build"
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (N, m) in ADC_SHAPES.items():
        codes = torch.randint(0, 256, (N, m), dtype=torch.uint8,
                              device="cuda", generator=g)
        table = torch.rand((m, 256), device="cuda", generator=g)
        fn = lambda: pq_adc.adc_lookup(codes, table)  # noqa: E731
        out[f"adc_{name}_loop_ms"] = time_ms(fn, 2000 if N < 1000 else 200)
        out[f"adc_{name}_device_ms"], _ = kernel_device_ms(
            fn, lambda key: "adc_" in key and "kernel" in key)
        try:        # an older wrapper may make calls a capture refuses
            out[f"adc_{name}_graph_ms"] = graph_ms(fn, 200)
        except RuntimeError:
            out[f"adc_{name}_graph_ms"] = None
    for name, (Q, N, k, reps) in {"topk_closure": (4096, 214_790, 8, 10),
                                  "topk_ground_truth": (512, 1_000_000, 10, 5)}.items():
        q = torch.randn((Q, 96), device="cuda", generator=g)
        x = torch.randn((N, 96), device="cuda", generator=g)
        out[f"{name}_ms"] = time_ms(lambda: fused_topk.l2_topk(q, x, k), reps)
        vals, ids = fused_topk.l2_topk(q, x, k)
        out[f"sha_{name}"] = sha256(vals, ids)
        del q, x, vals, ids
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((512, 96), device="cuda", generator=g)
    x = torch.randn((214_790, 96), device="cuda", generator=g)
    out["l2_distance_probe_ms"] = time_ms(lambda: distance.l2_distance(q, x), 20)
    out["sha_l2_distance_probe_f32"] = sha256(distance.l2_distance(q, x))
    out["sha_l2_distance_probe_bf16"] = sha256(
        distance.l2_distance(q.bfloat16(), x.bfloat16()))
    return out


def sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker)))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    sides = {"parent": args.parent.resolve() / "src", "change": ROOT / "src"}
    runs = []
    for _ in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                  "--worker", str(sides[side])],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                print(f"ab_kernels: the {side} run failed:\n{res.stderr}",
                      file=sys.stderr)
                return 1
            run = {"side": side, **json.loads(res.stdout.strip().splitlines()[-1])}
            runs.append(run)
            print(json.dumps(run), flush=True)
    keys = [k for k in runs[0] if k != "side" and not k.startswith("sha_")]
    summary = {side: {k: statistics.median(v) if (v := [
        r[k] for r in runs if r["side"] == side and r[k] is not None]) else None
        for k in keys} for side in sides}
    same_bits = {k: len({r.get(k) for r in runs}) == 1
                 for k in runs[0] if k.startswith("sha_")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "runs": runs,
                                        "medians": summary,
                                        "same_bits": same_bits}, indent=1))
    print(json.dumps({"medians": summary, "same_bits": same_bits}))
    return 0 if all(same_bits.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
