"""Carry an index or LM parameters of the JAX package across to the port.

:func:`cluster_index_from_reference` and :func:`graph_index_from_reference`
read a ``repro`` ``ClusterIndex`` / ``GraphIndex`` through its attributes
and numpy arrays only (duck typing: nothing of ``repro`` is imported) and
return the port's index with the same metadata, parameters and stored
payloads.  The port's search paths can then be held against the
reference's on one index.  :func:`lm_params_from_reference` turns the
reference LM's parameter tree (nested dicts, tuples and lists of numpy
arrays) into the port's ``LM`` state, so both packages run one set of
weights.
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


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}{key}.", out)
    else:
        out[prefix[:-1]] = torch.from_numpy(
            np.array(tree, dtype=np.float32))


def lm_params_from_reference(cfg, params) -> dict[str, torch.Tensor]:
    """The port's ``LM`` state (``load_state_dict``) of a reference LM's
    parameters.  The reference scans a repeating unit of layers whose
    parameters are stacked along a leading axis: repetition ``r`` of unit
    slot ``j`` becomes layer ``r * len(unit) + j``, and the tail layers
    follow."""
    from repro_torch.models.transformer import unit_structure

    unit, n_rep, tail = unit_structure(cfg)
    blocks = params["blocks"]
    layers = [None] * cfg.n_layers
    for j, stacked in enumerate(blocks["unit"]):
        for r in range(n_rep):
            layers[r * len(unit) + j] = _index_tree(stacked, r)
    for i, block in enumerate(blocks["tail"]):
        layers[n_rep * len(unit) + i] = block
    state: dict[str, torch.Tensor] = {}
    _flatten({key: val for key, val in params.items() if key != "blocks"},
             "", state)
    for i, block in enumerate(layers):
        _flatten(block, f"blocks.{i}.", state)
    return state


def _index_tree(tree, r: int):
    if isinstance(tree, dict):
        return {key: _index_tree(sub, r) for key, sub in tree.items()}
    return np.asarray(tree)[r]
