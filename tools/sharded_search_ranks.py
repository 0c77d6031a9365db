#!/usr/bin/env python3
"""The sharded search step on several ranks: the selection kernel against the stable sort.

    python3 tools/sharded_search_ranks.py [--world 4] [--device cuda]
        [--lists 214790] [--max-len 16] [--dim 96] [--queries 512]
        [--nprobe 16] [--k 10] [--steps 20] [--seed 0] [--out PATH]

Starts ``--world`` processes that join one group over a ``tcp://localhost``
store: NCCL with one card a rank (``--device cuda``), or gloo on the CPU
(``--device cpu``).  Each rank makes its share of a synthetic cluster index
on its device (``--lists`` lists in all, split into equal contiguous
ranges, each list up to ``--max-len`` rows of ``--dim`` float32 about its
centroid, padded with id ``-1``); the queries are the same on every rank.
Each rank runs ``core/distributed.py``'s ``sharded_search_step`` on them
twice: as the port runs it (``topk_smallest`` is ``ops.topk_smallest``, the
selection kernel on the card) and with ``topk_smallest`` the plain stable
sort (``kernels/ref.py::stable_topk_smallest``).  Checked: both give the
same ids and distances, bit for bit, on every rank; every rank holds the
same merged answer; on the card the kernel launches three times a step (the
local probe's select, the local top-k, the merge) and the sort none, and
each launches ``l2_distance`` once a step.  Each rank times both
variants over ``--steps`` steps.  Rank 0 prints one JSON line (and writes it
to ``--out``); exits 1 if a check failed on any rank.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def shard(args, rank: int, dev):
    """This rank's lists (centroids, vectors, ids, squared norms) and the
    queries, made on ``dev`` from ``--seed``: the centroids of every list
    and the queries (each near a list's centroid) from the seed alone, so
    the same on every rank; the rank's rows from the seed and the rank."""
    import torch

    lo = rank * args.lists // args.world
    L = (rank + 1) * args.lists // args.world - lo
    M, D = args.max_len, args.dim
    g = torch.Generator(device=dev).manual_seed(args.seed)
    every = 10 * torch.rand((args.lists, D), device=dev, generator=g) - 5
    near = torch.randint(0, args.lists, (args.queries,), device=dev, generator=g)
    q = every[near] + torch.randn((args.queries, D), device=dev, generator=g)
    cents = every[lo:lo + L].clone()
    g.manual_seed(args.seed + 1 + rank)
    vecs = cents[:, None, :] + torch.randn((L, M, D), device=dev, generator=g)
    lens = torch.randint(1, M + 1, (L, 1), device=dev, generator=g)
    pad = torch.arange(M, device=dev)[None, :] >= lens
    ids = (lo * M + torch.arange(L * M, device=dev).reshape(L, M)).to(torch.int32)
    ids = torch.where(pad, -1, ids)
    vecs = torch.where(pad[..., None], 0.0, vecs)
    norms = (vecs * vecs).sum(-1)
    return cents, vecs, ids, norms, q


def run_rank(rank: int, args, port: int) -> None:
    sys.path[:0] = [str(ROOT / "src")]
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed
    from repro_torch.kernels import distance, ref, topk_select

    cuda = args.device == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=args.world,
                            **({"device_id": dev} if cuda else {}))
    try:
        arrays = shard(args, rank, dev)
        step = distributed.sharded_search_step(nprobe_local=args.nprobe, k=args.k)
        kernel = distributed.topk_smallest

        def sync():
            if cuda:
                torch.cuda.synchronize()

        def run(select):
            """One step with ``select`` as the top-k, its launches, and the
            mean seconds a step over ``--steps`` more."""
            distributed.topk_smallest = select
            try:
                step(*arrays)                       # warm-up
                sync()
                before = (topk_select.topk_smallest.launches,
                          distance.l2_distance.launches)
                ids, dists = step(*arrays)
                sync()
                launched = (topk_select.topk_smallest.launches - before[0],
                            distance.l2_distance.launches - before[1])
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    step(*arrays)
                sync()
                return ids, dists, launched, (time.perf_counter() - t0) / args.steps
            finally:
                distributed.topk_smallest = kernel

        ki, kd, k_launched, k_s = run(kernel)
        si, sd, s_launched, s_s = run(ref.stable_topk_smallest)
        same = bool(torch.equal(ki, si)
                    and torch.equal(kd.view(torch.int32), sd.view(torch.int32)))
        mine = {"rank": rank, "lists": arrays[0].shape[0], "same_bits": same,
                "kernel_launches": k_launched, "sort_launches": s_launched,
                "kernel_ms": 1e3 * k_s, "sort_ms": 1e3 * s_s,
                "ids": ki.cpu().tolist(), "dists": kd.cpu().view(torch.int32).tolist()}
        ranks = [None] * args.world
        dist.all_gather_object(ranks, mine)
        if rank == 0:
            # (topk_select, l2_distance) a step; the CPU launches neither
            want = ((3, 1), (0, 1)) if cuda else ((0, 0), (0, 0))
            ok = all(r["same_bits"]
                     and (r["kernel_launches"], r["sort_launches"]) == want
                     and (r["ids"], r["dists"]) == (ranks[0]["ids"], ranks[0]["dists"])
                     for r in ranks)
            line = {"ok": ok, "world": args.world, "device": args.device,
                    "card": torch.cuda.get_device_name(dev) if cuda else "cpu",
                    "shape": {k: getattr(args, k) for k in
                              ("lists", "max_len", "dim", "queries", "nprobe", "k")},
                    "ranks": [{k: v for k, v in r.items() if k not in ("ids", "dists")}
                              for r in ranks],
                    "answers_short": sum(int(d == 0x7F800000) for d in
                                         sum(ranks[0]["dists"], []))}
            text = json.dumps(line)
            if args.out is not None:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                args.out.write_text(text + "\n")
            print(text, flush=True)
            if not ok:
                raise SystemExit(1)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--lists", type=int, default=214_790)
    ap.add_argument("--max-len", type=int, default=16)
    ap.add_argument("--dim", type=int, default=96)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    try:
        mp.start_processes(run_rank, args=(args, free_port()), nprocs=args.world,
                           start_method="spawn")
    except mp.ProcessRaisedException as e:
        print(f"sharded_search_ranks: a rank failed: {e}", file=sys.stderr)
        return 1
    except mp.ProcessExitedException as e:
        print(f"sharded_search_ranks: a rank exited: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
