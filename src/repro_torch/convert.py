"""Carry an index built by the JAX package across to the port.

:func:`cluster_index_from_reference` and :func:`graph_index_from_reference`
read a ``repro`` ``ClusterIndex`` / ``GraphIndex`` through its attributes
and numpy arrays only (duck typing: nothing of ``repro`` is imported) and
return the port's index with the same metadata, parameters and stored
payloads.  The port's search paths can then be held against the
reference's on one index.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import kmeans as km
from repro_torch.core.cluster_index import ClusterIndex, ClusterIndexMeta
from repro_torch.core.graph_index import GraphIndex, GraphIndexMeta
from repro_torch.core.pq import ProductQuantizer
from repro_torch.core.types import ClusterIndexParams, GraphIndexParams
from repro_torch.storage.object_store import ObjectStore


def _copy_store(ref_store, keys) -> ObjectStore:
    store = ObjectStore()
    for key in keys:
        payload = tuple(np.array(a) for a in ref_store.get(key))
        store.put(key, payload, ref_store.nbytes(key))
    return store


def cluster_index_from_reference(ref_index) -> ClusterIndex:
    """The port's copy of a reference cluster index (arrays are copied)."""
    meta = ref_index.meta
    tree = meta.tree
    nodes = [km._Node(center=np.array(nd.center, dtype=np.float32),
                      children=list(nd.children), leaf_id=int(nd.leaf_id))
             for nd in tree.nodes]
    port_tree = km.BKTree(nodes=nodes, root=int(tree.root),
                          centroids=np.array(tree.centroids, dtype=np.float32))
    params = ClusterIndexParams(**{
        f.name: getattr(meta.params, f.name)
        for f in dataclasses.fields(ClusterIndexParams)})
    store = _copy_store(ref_index.store,
                        [("list", li) for li in range(len(meta.list_lengths))])
    port_meta = ClusterIndexMeta(
        tree=port_tree, list_lengths=np.array(meta.list_lengths),
        list_nbytes=np.array(meta.list_nbytes), n_data=int(meta.n_data),
        dim=int(meta.dim), dtype=np.dtype(meta.dtype), params=params)
    return ClusterIndex(port_meta, store, use_bkt=bool(ref_index.use_bkt))


def graph_index_from_reference(
    ref_index, *, device: str | torch.device | None = None) -> GraphIndex:
    """The port's copy of a reference graph index on ``device``: codebooks,
    codes, medoid, parameters and every node block (arrays are copied)."""
    meta = ref_index.meta
    pq = ProductQuantizer(
        codebooks=np.array(meta.pq.codebooks, dtype=np.float32),
        dim=int(meta.pq.dim))
    params = GraphIndexParams(**{
        f.name: getattr(meta.params, f.name)
        for f in dataclasses.fields(GraphIndexParams)})
    store = _copy_store(ref_index.store,
                        [("node", i) for i in range(int(meta.n_data))])
    port_meta = GraphIndexMeta(
        pq=pq, codes=np.array(meta.codes, dtype=np.uint8),
        medoid=int(meta.medoid), n_data=int(meta.n_data), dim=int(meta.dim),
        dtype=np.dtype(meta.dtype), node_nbytes=int(meta.node_nbytes),
        params=params)
    return GraphIndex(port_meta, store, device=device)
