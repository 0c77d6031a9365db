"""The readings that a cell's limits are set from: the program's numbers
compared over many seeds (the lower readings) and the control's (the upper
readings), in one process.

    python vsbench/control.py --workloads <cell> [<cell> ...] \
        --seeds 1 2 ... --control-seeds 1 2 3 [--seconds 2] [--out r.json]

The control is the plain reference put in the program's place, one
precision below the configuration's float32: every product of its closure,
probe and scan takes TF32 operands, over the centroids of the program's
build on the same seed.  The cells share one configuration: each seed
makes its data and builds the program's index once, and each cell runs a
short window on it through the harness's closed loop (at least one walk of
the pool, every query answered), judged as a benchmark run judges it.  A
control seed that is also a program seed reuses that build.  The cells
are the SPANN kind's.  The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)


class Control:
    """The reference at TF32 as the system under test."""

    def __init__(self, data, centroids, params):
        import torch

        from vsbench.reference import search as ref
        self.data = data
        self.index = ref.build_index(data, torch.from_numpy(centroids).to(
            data.device), params, tf32=True)

    def search(self, state, queries, nprobe, k):
        from vsbench.reference import search as ref
        ids, dists, _ = ref.search(self.index, self.data, queries, nprobe, k,
                                   tf32=True)
        return ids, dists

    def built(self, state):
        from vsbench.reference import search as ref
        ids, lens = ref.padded_lists(self.index)
        return {"centroids": self.index.centroids.cpu().numpy(),
                "list_ids": ids, "list_len": lens}


def readings(root: Path, cell_names: list[str], seeds: list[int],
             control_seeds: list[int], seconds: float, device, program,
             log=print) -> dict:
    """``{"program": {cell: [checks of each seed]}, "control": {...},
    "program_max": {cell: {number: max}}, "control_min": {...}}``."""
    import gc

    import torch

    from vsbench import check, datagen, harness, kinds, loadgen

    cells = [harness.load_cell(root, c) for c in cell_names]
    if len({json.dumps(c.config, sort_keys=True) for c in cells}) != 1:
        raise ValueError("the cells of one readings run share a configuration")
    kind = cells[0].kind
    if kind.name != "spann":
        raise ValueError(f"the TF32 control is SPANN's, not {kind.name!r}'s")
    spann = kinds.load_module(kind.path / "reference.py",
                              "vsbench_kind_spann_reference")
    spec = datagen.spec_from_config(cells[0].config)
    params = kind.params(cells[0].config)
    program.prepare(device)
    out = {"cells": cell_names, "program": {c: [] for c in cell_names},
           "control": {c: [] for c in cell_names}}
    for seed in list(dict.fromkeys(seeds + control_seeds)):
        data, pool = datagen.make(spec, seed)
        t = time.perf_counter()
        state = program.build(data, params, device)
        built = program.built(state)
        log(f"seed {seed}: program index {state['shapes']} in "
            f"{time.perf_counter() - t:.1f} s")
        xd = torch.from_numpy(data).to(device)
        ctl = (Control(xd, built["centroids"], params)
               if seed in control_seeds else None)
        for cell in cells:
            gen = loadgen.generator(cell.traffic, len(pool), kind.knobs)
            rf = spann.over_centroids(data, pool, built["centroids"], params,
                                      gen, device)
            for who, system, secs, lists in (
                    ("program", program, seconds, built),
                    ("control", ctl, 0.0, ctl and ctl.built(None))):
                if system is None or (who == "program" and seed not in seeds):
                    continue
                win = harness.serve(system, state, pool, gen, secs, device,
                                    False)
                v = check.judge(win.slots, win.ids, win.dists, pool, data,
                                rf.ids, rf.gt, gen.batch, cell.limits,
                                {"lists_differ": rf.lists_differ(lists)[0]})
                row = {"seed": seed, "answers": v.answers, "recall": v.recall,
                       "correct": v.correct, **v.values}
                out[who][cell.name].append(row)
                log(json.dumps({who: {cell.name: row}}))
        del state, ctl, xd
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    limits = {c.name: c.limits for c in cells}
    for who, agg in (("program", max), ("control", min)):
        out[f"{who}_{agg.__name__}"] = {
            c: {n: agg(r[n] for r in rows) for n in limits[c]}
            for c, rows in out[who].items() if rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workloads", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from vsbench.system import Program
    if not torch.cuda.is_available():
        print("vsbench control: needs a CUDA card", file=sys.stderr)
        return 1
    out = readings(ROOT, args.workloads, args.seeds, args.control_seeds,
                   args.seconds, torch.device("cuda", 0), Program(),
                   log=lambda s: print(s, file=sys.stderr, flush=True))
    out["card"] = torch.cuda.get_device_name(0)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
