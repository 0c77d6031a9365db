#!/usr/bin/env python3
"""Run one benchmark cell with the port's own spans and counters on, and
put the search's device time down to its stages.

    python3 tools/trace_stages.py --workload <cell> --seed <n> --seconds <s>
        [--trace 0|1] [--spans 0|1] [--out PATH]

From the root of a checkout, on one CUDA card.  It runs a cell as
``vsbench/run.py`` does (``vsbench.harness``'s data, build, closed loop
and comparison with the reference), with ``repro_torch.spans`` on from
before the build when ``--spans 1``: the build's spans are taken after the
build, the recorder is reset as the window's first batch is sent, and the
window's spans and counters are read after it.  With ``--trace 1`` the
window runs under the profiler as the harness's traced run does, and
``vsbench.stages`` puts every device operation down to the stage that
launched it.  ``--spans 0 --trace 1`` is the harness's traced run;
``--spans 1 --trace 0`` shows the recorder's host cost without a profiler.

Prints one JSON object: ``correct`` and the compared numbers, queries/s
and recall, ``index_build_s``, the per-layer readings of
``vsbench.stages.readings`` (``None`` where there is nothing to read), the
window's launches a batch of each hand-written kernel that the search runs,
from its ``launches`` counter (``kernel_launches_per_batch``: the
selection kernel's show it engaged on every batch; ``None`` for a kernel
the checkout lacks), the
stages (name -> device s, host s, launches, ranges), the device's busy and
window seconds and idle gaps, and cross-checks: the device time launched
inside ``vsbench.search`` that no stage holds, the five stages against
that time less the recorder's own, the build's spans against
``index_build_s``, and the padded-row share counted from the reference's
probe.  ``--device cpu`` runs the same on the CPU (no device trace).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
# the search's kernels by module and launch counter, as the port names them
KERNELS = {"l2_distance": ("repro_torch.kernels.distance", "l2_distance"),
           "topk_select": ("repro_torch.kernels.topk_select", "topk_smallest")}


def launch_counts() -> dict:
    """Each of :data:`KERNELS`' launches so far, ``None`` where the
    checkout has no such kernel."""
    import importlib
    out = {}
    for name, (mod, fn) in KERNELS.items():
        try:
            out[name] = getattr(importlib.import_module(mod), fn).launches
        except (ImportError, AttributeError):
            out[name] = None
    return out


def cross_checks(stg: dict | None, events: list, read: dict, build_s: float,
                 rf_probed, lengths, slots, batch: int, max_len: int) -> dict:
    """The numbers that hold the readings to what they should add up to."""
    from vsbench import stages

    out = {}
    probed = sum(int(lengths[rf_probed[s:s + batch]].sum()) for s in slots)
    gathered = len(slots) * batch * rf_probed.shape[1] * max_len
    out["padded_row_share_reference"] = 100.0 * (1.0 - probed / gathered)
    parts = [read[f"{p}_s"] for p in stages.BUILD]
    out["build_spans_over_index_build"] = (
        sum(parts) / build_s if None not in parts else None)
    if stg:
        vs = stages.reduce(events, "vsbench.search").get("vsbench.search")
        total = vs.device_s if vs else 0.0
        held = sum(s.device_s for n, s in stg.items()
                   if n.startswith(stages.SEARCH + "."))
        count = stg.get(stages.COUNT, stages.Stage()).device_s
        five = sum(stg.get(f"{stages.SEARCH}.{p}", stages.Stage()).device_s
                   for p in stages.STAGES)
        out["search_device_s"] = total
        out["other_share_of_search"] = (100.0 * (total - held) / total
                                        if total else None)
        out["stages_over_search_less_count"] = (
            five / (total - count) if total > count else None)
        batches = len(slots)
        out["count_device_ms"] = 1e3 * count / batches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout whose BENCHMARK.json and vsbench/ "
                         "name the cell")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from repro_torch import spans
    from vsbench import check, datagen, devtrace, harness, loadgen, stages
    from vsbench.system import Program

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("trace_stages: no CUDA card", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.root, args.workload)
    system = Program()
    system.prepare(dev)
    data, pool = datagen.make(datagen.spec_from_config(cell.config), args.seed)
    gen = loadgen.generator(cell.traffic, len(pool))
    params = harness.index_params(cell.config)
    spans.reset()
    if args.spans:
        spans.enable()
    t = time.perf_counter()
    state = system.build(data, params, dev)
    harness._sync(dev)
    build_s = time.perf_counter() - t
    build = spans.snapshot() if args.spans else None
    events: list = []
    read_trace = devtrace.read

    def keep(prof):
        events.extend(read_trace(prof))
        return events

    at_start: dict = {}

    def on_start(_):
        spans.reset()
        at_start.update(launch_counts())

    with mock.patch.object(devtrace, "read", keep):
        win = harness.serve(system, state, pool, gen, args.seconds, dev,
                            bool(args.trace), on_start)
    launches = {n: (c - at_start[n]) / len(win.slots) if c is not None else None
                for n, c in launch_counts().items()}
    window = spans.snapshot() if args.spans else None
    spans.disable()
    spans.reset()
    shapes = state["shapes"]
    built = system.lists(state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rf = harness.reference(data, pool, built["centroids"], params, gen, dev)
    lists, _ = rf.lists_differ(built)
    verdict = check.judge(win.slots, win.ids, win.dists, pool, data, rf.ids,
                          rf.gt, gen.batch, cell.limits, lists)
    stg = stages.reduce(events) if events else None
    read = stages.readings(stg, window, build)
    out = {"workload": args.workload, "seed": args.seed,
           "trace": args.trace, "spans": args.spans,
           "correct": verdict.correct, "checks": verdict.record(),
           "why_bad": verdict.why_bad,
           "queries_per_s": len(win.slots) * gen.batch / win.seconds,
           "recall_at_10": verdict.recall, "index_build_s": build_s,
           "batches": len(win.slots), "shapes": shapes, "readings": read,
           "kernel_launches_per_batch": launches,
           "checked": cross_checks(stg, events, read, build_s, rf.probed,
                                   rf.lengths, win.slots, gen.batch,
                                   shapes["max_len"]),
           "counters": window["counters"] if window else None}
    if stg is not None:
        out["stages"] = {n: [s.device_s, s.host_s, s.launches, s.ranges]
                         for n, s in sorted(stg.items())}
    if win.trace is not None:
        out["busy_s"] = win.trace.busy_s
        out["window_s"] = win.trace.window_s
        out["device_ops"] = win.trace.device_ops
        out["idle_gaps"] = win.trace.idle_gaps
    if dev.type == "cuda":
        from repro_torch.hw import smi_line
        out["card"] = smi_line(dev.index or 0)
    line = json.dumps(out, allow_nan=False)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
