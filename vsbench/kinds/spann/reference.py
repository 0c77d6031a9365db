"""SPANN's plain reference (``vsbench/reference/search.py``): the lists,
probe, scan, dedup and top-k worked out again over the program's
centroids, each batch's work counted from the lists its queries probe
(``work.search_batch_work``), and the program's lists held to the closure
rule (``lists_differ``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vsbench import work
from vsbench.kinds import Answers
from vsbench.reference import search as ref


@dataclasses.dataclass
class Reference:
    """The plain reference's answers to every pool query, over the lists it
    works out from the program's centroids."""
    ids: np.ndarray              # (P, k) its search's answers
    gt: np.ndarray               # (P, k) exact nearest ids
    probed: np.ndarray           # (P, nprobe) lists each query probes
    lengths: np.ndarray          # (L,) unpadded list lengths
    index: ref.Index
    n: int                       # points in the data

    def batch_work(self, slots, batch: int, dim: int, k: int) -> dict:
        """First pool row -> (FLOP, bytes) of that batch's search."""
        return {int(s): work.search_batch_work(
            self.probed[s:s + batch], self.lengths, len(self.lengths), dim, k)
            for s in np.unique(slots)}

    def lists_differ(self, built: dict) -> tuple[float, float]:
        """``(lists_differ, unsure share)`` of the lists ``built``."""
        return ref.lists_differ(self.index, built["list_ids"],
                                built["list_len"], self.n)


def over_centroids(data: np.ndarray, pool: np.ndarray, centroids: np.ndarray,
                   params: dict, gen, device: torch.device) -> Reference:
    """The reference's lists over ``centroids`` and its answers to ``pool``
    at the traffic ``gen``'s ``nprobe`` and ``k``."""
    xd = torch.from_numpy(data).to(device)
    qd = torch.from_numpy(pool).to(device)
    index = ref.build_index(xd, torch.from_numpy(centroids).to(device), params)
    ids, _, probed = ref.search(index, xd, qd, gen.knobs["nprobe"], gen.k)
    return Reference(ids.cpu().numpy(), ref.exact_topk(xd, qd, gen.k),
                     probed.cpu().numpy(), index.lengths.cpu().numpy(), index,
                     len(data))


def reference(data, pool, built, params, gen, device) -> Answers:
    rf = over_centroids(data, pool, built["centroids"], params, gen, device)
    lists, unsure = rf.lists_differ(built)
    slots = [gen.rows(b).start for b in range(gen.slots)]
    return Answers(
        ids=rf.ids, gt=rf.gt,
        work=rf.batch_work(slots, gen.batch, data.shape[1], gen.k),
        numbers={"lists_differ": lists},
        notes={"points on a near-tie of the closure": unsure})
