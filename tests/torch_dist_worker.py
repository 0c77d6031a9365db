"""A rank of the multi-process ``repro_torch.core.distributed`` tests.

Started by ``torch.multiprocessing`` (spawn) from
``tests/test_torch_distributed.py``: joins a ``gloo`` group through a
``file://`` store, runs the sharded search and k-means steps on its share
of the arrays in ``inp`` (lists and points split into equal contiguous
ranges, rank order) and saves its results to ``<out>.<rank>.npz``.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import (sharded_kmeans_step,
                                          sharded_search_step)


def _share(a: np.ndarray, rank: int, world: int) -> torch.Tensor:
    n = len(a)
    return torch.from_numpy(a[rank * n // world:(rank + 1) * n // world])


def run(rank: int, world: int, store: str, inp: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        d = np.load(inp)
        step = sharded_search_step(nprobe_local=int(d["nprobe"]),
                                   k=int(d["k"]))
        ids, dists = step(*(_share(d[key], rank, world)
                            for key in ("cents", "vecs", "ids", "norms")),
                          torch.from_numpy(d["queries"]))
        cents = sharded_kmeans_step()(_share(d["x"], rank, world),
                                      torch.from_numpy(d["init"]))
        np.savez(f"{out}.{rank}.npz", ids=ids.numpy(), dists=dists.numpy(),
                 cents=cents.numpy())
    finally:
        dist.destroy_process_group()
