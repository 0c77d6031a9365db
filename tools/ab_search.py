#!/usr/bin/env python3
"""Compare the device search's answers of two checkouts, bit for bit, on one card.

    python3 tools/ab_search.py --parent DIR --workload <cell> --seed <n> [--seed <n> ...]
        [--out PATH]

``DIR`` is another checkout of this repository (for example the parent
commit, unpacked with ``git archive``); its kernels are built under the
temporary directory, not in ``DIR``.  For each seed, each checkout runs in a
process of its own (both packages are named ``repro_torch``): it makes the
cell's data from the seed (this checkout's ``vsbench``), builds the index
(``vsbench.system.Program``) and answers every query of the pool in the
cell's batches with ``device_search_batch``.  Each side reports sha256s of
the index it built and of the answers' ids and distances; one JSON line a
seed says whether the two sides gave the same bits.  Exits 1 if any seed's
answers differ.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(src: Path, workload: str, seed: int) -> dict:
    """One side: build the cell's index from ``seed`` with the package under
    ``src`` and answer the whole pool."""
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    from repro_torch.kernels import _build
    from vsbench import datagen, harness, loadgen
    from vsbench.system import Program

    if src.resolve() != (ROOT / "src").resolve():
        _build.BUILD_DIR = Path(tempfile.gettempdir()) / "repro_ab_search_build"
    dev = torch.device("cuda")
    cell = harness.load_cell(ROOT, workload)
    system = Program()
    system.prepare(dev)
    data, pool = datagen.make(datagen.spec_from_config(cell.config), seed)
    gen = loadgen.generator(cell.traffic, len(pool))
    state = system.build(data, harness.index_params(cell.config), dev)
    ids, dists = [], []
    for b in range(gen.slots):
        q = torch.from_numpy(pool[gen.rows(b)]).to(dev)
        i, d = system.search(state, q, gen.nprobe, gen.k)
        ids.append(i.cpu())
        dists.append(d.cpu())
    a = state["arrs"]
    return {"sha_index": sha256(a["centroids"], a["list_vecs"], a["list_ids"]),
            "sha_ids": sha256(torch.cat(ids)), "sha_dists": sha256(torch.cat(dists)),
            "answers": int(sum(t.shape[0] for t in ids))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker, args.workload, args.seed[0])))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    sides = {"parent": args.parent.resolve() / "src", "change": ROOT / "src"}
    lines, same = [], True
    for seed in args.seed:
        got = {}
        for side, src in sides.items():
            res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                  "--worker", str(src), "--workload", args.workload,
                                  "--seed", str(seed)], capture_output=True, text=True)
            if res.returncode != 0:
                print(f"ab_search: the {side} run failed:\n{res.stderr}", file=sys.stderr)
                return 1
            got[side] = json.loads(res.stdout.strip().splitlines()[-1])
        line = {"seed": seed, **got,
                "same_index": got["parent"]["sha_index"] == got["change"]["sha_index"],
                "same_answers": all(got["parent"][k] == got["change"][k]
                                    for k in ("sha_ids", "sha_dists"))}
        same = same and line["same_answers"]
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
