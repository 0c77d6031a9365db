#!/usr/bin/env python3
"""Time design variants of the wide ``l2_distance`` kernel against this checkout's on one card.

    python3 tools/l2_distance_variants.py [--rounds 3] [--out PATH]

Each variant is ``csrc/l2_distance.cu`` with one design choice edited:

* ``streaming_stores``: the epilogue's stores as ``__stcs`` (evict-first)
  instead of plain stores;
* ``depth_32``: 32-deep ring stages instead of 16 (half the barriers, twice
  the ring);
* ``stages_4``: four ring stages instead of three.

Every source is built with the package's ``nvcc`` flags (one ``nvcc`` each,
all at once), loaded in place of the checkout's library and called through
``distance.l2_distance`` at the centroid probe's shape (512 x 214,790 x 96,
normal random float32), in turns: the checkout first, then the variants,
then back in reverse order, ``--rounds`` times.  Each variant must give the
checkout's bits.  Then the checkout's kernel runs in a loop for three
seconds while ``nvidia-smi`` samples the SM clock and the power draw every
100 ms.  Prints the card's name and power limit and, as the last line, the
median time a call of each source and the median clock and power.  Needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (old, new) edits of csrc/l2_distance.cu; each old text must occur
VARIANTS = {
    "streaming_stores": [
        ("*reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);",
         "__stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));"),
        ("*reinterpret_cast<float2*>(p) = make_float2(a, b);",
         "__stcs(reinterpret_cast<float2*>(p), make_float2(a, b));"),
        ("*reinterpret_cast<float2*>(p + 2) = make_float2(c, d);",
         "__stcs(reinterpret_cast<float2*>(p + 2), make_float2(c, d));"),
        ("if (col < hi) p[0] = a;", "if (col < hi) __stcs(p, a);"),
        ("if (col + 1 < hi) p[1] = b;", "if (col + 1 < hi) __stcs(p + 1, b);"),
        ("if (col + 2 < hi) p[2] = c;", "if (col + 2 < hi) __stcs(p + 2, c);"),
        ("if (col + 3 < hi) p[3] = d;", "if (col + 3 < hi) __stcs(p + 3, d);"),
    ],
    "depth_32": [("static constexpr int KC = 16;", "static constexpr int KC = 32;")],
    "stages_4": [("static constexpr int STAGES = 3;", "static constexpr int STAGES = 4;")],
}


def build(src: str, workdir: Path, name: str, nvcc_cmd: list[str]) -> subprocess.Popen:
    cu = workdir / f"{name}.cu"
    cu.write_text(src)
    return subprocess.Popen([*nvcc_cmd, "-o", str(workdir / f"lib{name}.so"), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("l2_distance_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import time_ms
    from repro_torch.hw import smi_line
    from repro_torch.kernels import _build, distance

    base = (_build.CSRC / "l2_distance.cu").read_text()
    sources = {"checkout": base}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"l2_distance_variants: {name}: {old!r} not in the source")
            src = src.replace(old, new)
        sources[name] = src
    workdir = Path(tempfile.mkdtemp(prefix="l2_distance_variants_"))
    nvcc_cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC)]
    jobs = {n: build(s, workdir, n, nvcc_cmd) for n, s in sources.items()}
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        if job.returncode != 0:
            raise SystemExit(f"l2_distance_variants: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(workdir / f"lib{name}.so"))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((512, 96), device="cuda", generator=g)
    x = torch.randn((214_790, 96), device="cuda", generator=g)

    def use(name):
        _build._LIBS["l2_distance"] = libs[name]
        distance._PER_SM.clear()        # the occupancy of this build

    use("checkout")
    want = distance.l2_distance(q, x)
    for name in sources:
        use(name)
        if not torch.equal(distance.l2_distance(q, x), want):
            raise SystemExit(f"l2_distance_variants: {name} gives other bits")
    times = {name: [] for name in sources}
    order = list(sources)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            use(name)
            times[name].append(time_ms(lambda: distance.l2_distance(q, x), 20))
    medians = {name: statistics.median(v) for name, v in times.items()}
    use("checkout")
    clock = under_load(lambda: distance.l2_distance(q, x), torch)
    smi = smi_line(0)
    print(smi)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "times_ms": times,
                                        "medians_ms": medians, "checkout_under_load": clock},
                                       indent=1))
    print(json.dumps({"medians_ms": medians, "checkout_under_load": clock}))
    return 0


def under_load(fn, torch, seconds: float = 3.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    every 100 ms while ``fn`` runs in a loop, the first 300 ms left out."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.strip()][3:]
    return {"samples": len(rows),
            "sm_clock_mhz": statistics.median(float(r[0]) for r in rows) if rows else None,
            "power_w": statistics.median(float(r[1]) for r in rows) if rows else None}


if __name__ == "__main__":
    sys.exit(main())
