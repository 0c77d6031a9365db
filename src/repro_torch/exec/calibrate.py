"""Calibration harness: time the port's kernels on the card, persist the table.

Counterpart of ``repro.exec.calibrate``, on the reference's grid.  Times
:func:`repro_torch.exec.batched.batched_topk` (fused distance + top-k, the
serving scan op: one ``l2_topk`` launch, numpy in and out as a job calls
it) and :func:`repro_torch.kernels.ops.adc_lookup` on device tensors over
(dim, pq_m, batch size) points, converts each point to a ``unit_s``
(seconds per distance computation / per ADC lookup) and persists a
:class:`~repro_torch.exec.table.CalibrationTable` JSON.  Every timed call
ends in ``torch.cuda.synchronize()``, so a time is the work's and not its
enqueue's.

Each dist point is cross-checked against the card's roofline
(:func:`repro_torch.hw.card_peaks`, the FP32 peak: the kernel computes in
f32 on the CUDA cores): achieved FLOP/s above the peak would mean the
timer is lying, so that fails loudly; the achieved fraction is recorded in
the table meta either way.  On ``device="cpu"`` (the plain versions) there
is no card to hold it to: the cross-check is skipped and the meta says so.

CLI::

    python -m repro_torch.exec.calibrate --out calibration.json [--quick]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.exec.batched import batched_topk
from repro_torch.exec.table import CalibEntry, CalibrationTable
from repro_torch.hw import card_peaks, smi_line
from repro_torch.kernels import ops

__all__ = ["measure_table", "main"]

#: (B queries, N candidates) points per dim — the batch axis is B*N pairs.
DIST_POINTS = [(1, 128), (4, 512), (8, 1024), (32, 2048)]
DIST_POINTS_QUICK = [(1, 128), (8, 1024)]
DIMS = [16, 32, 64, 128]
DIMS_QUICK = [32, 64]
#: (n codes, ) points per pq_m — the batch axis is n*m lookups.
ADC_POINTS = [256, 2048, 16384]
ADC_POINTS_QUICK = [256, 2048]
PQ_MS = [8, 16]
PQ_MS_QUICK = [8]
TOPK = 10


def _time(fn, iters: int, warmup: int) -> float:
    """Median wall-clock seconds per call (warmed; ``fn`` syncs itself)."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def measure_table(quick: bool = False, *, iters: int | None = None,
                  seed: int = 0, verbose: bool = False,
                  device: str | torch.device | None = None
                  ) -> CalibrationTable:
    """Run the measurement grid on ``device`` and build a table."""
    dev = resolve_device(device)
    iters = iters or (2 if quick else 5)
    warmup = 1 if quick else 2
    dims = DIMS_QUICK if quick else DIMS
    dist_points = DIST_POINTS_QUICK if quick else DIST_POINTS
    pq_ms = PQ_MS_QUICK if quick else PQ_MS
    adc_points = ADC_POINTS_QUICK if quick else ADC_POINTS
    rng = np.random.default_rng(seed)

    on_card = dev.type == "cuda"
    meta: dict = dict(backend=dev.type, torch=torch.__version__)
    if on_card:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        name = torch.cuda.get_device_name(index)
        peak_flops = card_peaks(name)[0]
        meta.update(device=name, card=smi_line(index), cuda=torch.version.cuda,
                    roofline_check=f"fp32 peak {peak_flops:.3e} FLOP/s")
        sync = torch.cuda.synchronize
    else:
        peak_flops = None
        meta.update(device="cpu",
                    roofline_check="skipped: no card (device=cpu)")

        def sync():
            pass

    entries: list[CalibEntry] = []
    rooflines: list[dict] = []
    for dim in dims:
        for bq, n in dist_points:
            q = rng.standard_normal((bq, dim)).astype(np.float32)
            x = rng.standard_normal((n, dim)).astype(np.float32)
            sec = _time(lambda: batched_topk(q, x, TOPK, device=dev),
                        iters, warmup)
            pairs = bq * n
            achieved = 2.0 * dim * pairs / sec
            entries.append(CalibEntry(
                op="dist", dim=dim, pq_m=0, batch=pairs, dtype="float32",
                unit_s=sec / pairs, us_per_call=sec * 1e6))
            if peak_flops is not None:
                frac = achieved / peak_flops
                if frac > 1.0:
                    raise RuntimeError(
                        f"calibration point dim={dim} pairs={pairs} measured "
                        f"{achieved:.3e} FLOP/s above the card's peak "
                        f"{peak_flops:.3e} — timer is broken")
                rooflines.append(dict(dim=dim, batch=pairs,
                                      achieved_gflops=round(achieved / 1e9, 3),
                                      roofline_frac=round(frac, 9)))
            if verbose:
                print(f"  dist dim={dim:<4} pairs={pairs:<6} "
                      f"{sec * 1e6:9.1f} us/call  "
                      f"{achieved / 1e9:8.3f} GFLOP/s", file=sys.stderr)
    for m in pq_ms:
        for n in adc_points:
            codes = torch.from_numpy(
                rng.integers(0, 256, (n, m), dtype=np.uint8)).to(dev)
            table = torch.from_numpy(
                rng.standard_normal((m, 256)).astype(np.float32)).to(dev)

            def adc():
                ops.adc_lookup(codes, table)
                sync()

            sec = _time(adc, iters, warmup)
            lookups = n * m
            entries.append(CalibEntry(
                op="adc", dim=0, pq_m=m, batch=lookups, dtype="uint8",
                unit_s=sec / lookups, us_per_call=sec * 1e6))
            if verbose:
                print(f"  adc  m={m:<6} codes={n:<6} "
                      f"{sec * 1e6:9.1f} us/call", file=sys.stderr)

    meta.update(quick=bool(quick), iters=iters, topk=TOPK,
                rooflines=rooflines,
                generated_by="python -m repro_torch.exec.calibrate")
    return CalibrationTable(entries, meta=meta)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.exec.calibrate",
        description="Time the port's kernels on the card and write a "
                    "CalibrationTable JSON.")
    ap.add_argument("--out", default="calibration.json",
                    help="output path (default: %(default)s)")
    ap.add_argument("--quick", action="store_true",
                    help="small grid, few iters (smoke)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timing iterations per point")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--summary", action="store_true",
                    help="print the table summary JSON to stdout")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    table = measure_table(quick=args.quick, iters=args.iters,
                          seed=args.seed, verbose=True)
    table.save(args.out)
    print(f"wrote {args.out}: {len(table.entries)} entries in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    if args.summary:
        print(json.dumps(table.describe(), indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
