"""Run one cell of the port's benchmark and print its result line.

    python vsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Needs a CUDA card (and as many as the cell
asks for): without one it exits 1 and prints no result.  Progress and the
numbers compared, each with its limit, go to standard error; the last line
of standard output is the result as one JSON object.
"""
import time

T0 = time.perf_counter()           # the process's start, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)                # vsbench's modules load as vsbench.*
REFUSED = ("jax", "jaxlib", "flax", "repro")
# caches of any compiler the program or torch may use, at fixed paths in
# the checkout, so only a checkout's first run builds (the port's own nvcc
# builds go to src/repro_torch/kernels/build/, also in the checkout)
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("CUDA_CACHE_PATH", "cuda"))


def refused_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark refuses."""
    return sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number >= 0")

    for var, sub in CACHES:
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"vsbench: no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(src)]
    import torch

    from vsbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"vsbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    import repro_torch
    if src not in Path(repro_torch.__file__).resolve().parents:
        print(f"vsbench: repro_torch came from {repro_torch.__file__}, "
              f"not from {src}", file=sys.stderr)
        return 1
    out = harness.run(ROOT, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), cell.kind.program(), T0)
    bad = refused_modules()
    if bad:
        print(f"vsbench: refused modules loaded: {bad}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
