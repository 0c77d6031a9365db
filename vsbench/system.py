"""The system under test: ``repro_torch``'s SPANN cluster index on its
resident-array serving path (the ``spann`` kind's ``Program``).

Set-up builds the index with ``ClusterIndex.build`` (host BKT, closure on
the card through ``l2_topk``) and moves ``device_arrays()`` to the card;
each request is one ``device_search_batch`` call.

Every kind's ``Program`` (``kinds/<index>/system.py``) offers what the
harness calls, in this order:

``prepare(device)``
    builds the port's kernels; a no-op once built.
``build(data, params, device) -> state``
    the index over ``data`` (n, dim) float32 on the host, with
    ``kind.params``' parameters, resident on ``device``.  ``state`` is a
    dict; its ``"shapes"`` dict of the index's sizes goes to the log and
    to the metric readers (``Record.shapes``).
``search(state, queries, k=k, **knobs) -> (ids, dists)``
    one batch, ``queries`` (batch, dim) on the device: each query's ``k``
    nearest as the index finds them, nearest first, distances squared L2,
    a short answer padded with ``inf``.  The harness passes ``k`` and the
    traffic's knobs by name.
``built(state) -> dict``
    the index the window searched, as host arrays: what the kind's
    reference needs to work out its answers and its own numbers.
``trace(on)`` and ``snapshot() -> dict`` (optional)
    the port's recorder (``repro_torch.spans``): ``trace`` drops what it
    holds and turns it on or off, ``snapshot`` copies what it holds.  The
    harness calls them only in a traced run of a cell with a per-layer
    metric whose source is ``program_span`` or ``program_counter``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
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

    def built(self, state: dict) -> dict:
        """The index the search reads, on the host: its centroids and its
        padded lists."""
        a = state["arrs"]
        return {key: a[key].cpu().numpy()
                for key in ("centroids", "list_ids", "list_len")}

    lists = built                # the name tools/trace_stages.py calls

    def search(self, state: dict, queries: torch.Tensor, nprobe: int, k: int):
        a = state["arrs"]
        return device_search_batch(a["centroids"], a["list_vecs"],
                                   a["list_ids"], queries, nprobe=nprobe, k=k)

    def trace(self, on: bool) -> None:
        spans.reset()
        if on:
            spans.enable()
        else:
            spans.disable()

    def snapshot(self) -> dict:
        return spans.snapshot()
