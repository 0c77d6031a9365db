"""Carry an index built by the JAX package across to the port.

:func:`cluster_index_from_reference` reads a ``repro`` ``ClusterIndex``
through its attributes and numpy arrays only (duck typing: nothing of
``repro`` is imported) and returns the port's ``ClusterIndex`` with the
same tree, list lengths and bytes, parameters and posting-list payloads.
The port's search paths can then be held against the reference's on one
index.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import kmeans as km
from repro_torch.core.cluster_index import ClusterIndex, ClusterIndexMeta
from repro_torch.core.types import ClusterIndexParams
from repro_torch.storage.object_store import ObjectStore


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
    store = ObjectStore()
    for li in range(len(meta.list_lengths)):
        key = ("list", li)
        ids, vecs = ref_index.store.get(key)
        store.put(key, (np.array(ids), np.array(vecs)),
                  ref_index.store.nbytes(key))
    port_meta = ClusterIndexMeta(
        tree=port_tree, list_lengths=np.array(meta.list_lengths),
        list_nbytes=np.array(meta.list_nbytes), n_data=int(meta.n_data),
        dim=int(meta.dim), dtype=np.dtype(meta.dtype), params=params)
    return ClusterIndex(port_meta, store, use_bkt=bool(ref_index.use_bkt))
