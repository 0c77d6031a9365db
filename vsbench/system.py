"""The system under test: ``repro_torch``'s SPANN cluster index on its
resident-array serving path.

Set-up builds the index with ``ClusterIndex.build`` (host BKT, closure on
the card through ``l2_topk``) and moves ``device_arrays()`` to the card;
each request is one ``device_search_batch`` call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cluster_index import ClusterIndex, device_search_batch
from repro_torch.core.types import ClusterIndexParams


class Program:
    def prepare(self, device: torch.device) -> None:
        """Build the port's kernels (all at once; a no-op once built)."""
        if device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all()

    def build(self, data: np.ndarray, params: dict, device: torch.device
              ) -> dict:
        index = ClusterIndex.build(data, ClusterIndexParams(**params),
                                   device=device)
        arrs = {key: torch.from_numpy(v).to(device)
                for key, v in index.device_arrays().items()}
        n_lists, max_len, dim = arrs["list_vecs"].shape
        return {"arrs": arrs, "shapes": {
            "n_lists": n_lists, "max_len": max_len, "dim": dim,
            "entries": int(index.meta.list_lengths.sum()),
            "device_bytes": sum(v.numel() * v.element_size()
                                for v in arrs.values())}}

    def lists(self, state: dict) -> dict:
        """The index the search reads, on the host: its centroids and its
        padded lists."""
        a = state["arrs"]
        return {key: a[key].cpu().numpy()
                for key in ("centroids", "list_ids", "list_len")}

    def search(self, state: dict, queries: torch.Tensor, nprobe: int, k: int):
        a = state["arrs"]
        return device_search_batch(a["centroids"], a["list_vecs"],
                                   a["list_ids"], queries, nprobe=nprobe, k=k)
