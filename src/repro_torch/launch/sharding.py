"""Sharding policy: parameter-name rules -> placement (FSDP x TP).

Counterpart of ``repro.launch.sharding``: the same rules, as pure functions
of (the mesh's axis sizes, a tensor's name, its shape).  For each tensor
they give the reference's ``PartitionSpec`` as a tuple with one entry per
dim (``None``, an axis name, or a tuple of axis names), and the DTensor
placements that spec means on a ``DeviceMesh`` (one ``Shard(dim)`` or
``Replicate()`` per mesh axis, in the mesh's axis order; a dim split over
two axes is split by the first, then the second, as in the reference).

Axes:

* ``model``: tensor parallel (vocab, attention heads, d_ff, experts);
* ``data``: batch data parallel AND parameter FSDP;
* ``pod``: cross-pod data parallel (multi-pod mesh only).

A ``mesh`` argument is a ``DeviceMesh`` or a mapping of axis name to size.
The port's layers are a list (``blocks.{i}.…``), not the reference's
stacked units, so the reference's leading layer axis falls away.  Dims
that do not divide their axis stay unsharded.

:func:`distribute_lm` and :func:`distribute_tree` apply the rules: each
rank keeps its own piece of every tensor, as a DTensor.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.parallel import place

Spec = tuple


@dataclasses.dataclass(frozen=True)
class Sharding:
    spec: Spec              # per tensor dim: None, an axis or a tuple of axes
    placements: tuple       # per mesh axis: Shard(dim) or Replicate()


def axis_sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _shard_dim(mesh, size: int, axis: str, allow_uneven=False):
    n = _axis_size(mesh, axis)
    if n == 1:
        return None
    if size % n == 0 or (allow_uneven and size >= n):
        return axis
    return None


def placements(mesh, spec: Spec) -> tuple:
    """The DTensor placements of ``spec``: for each mesh axis, ``Shard(i)``
    if tensor dim ``i`` is split over it, else ``Replicate()``."""
    out = []
    for axis in axis_sizes(mesh):
        dims = [i for i, s in enumerate(spec)
                if s == axis or (isinstance(s, tuple) and axis in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def sharding(mesh, spec: Spec) -> Sharding:
    return Sharding(tuple(spec), placements(mesh, spec))


POLICY = "tp_fsdp"      # "tp_fsdp" (default) | "fsdp" (pure ZeRO-3 DP)


def set_policy(name: str) -> None:
    """Select the global sharding policy.

    tp_fsdp: the model axis does tensor parallelism (heads/d_ff/vocab/
             experts), the data axis batch DP + parameter FSDP.
    fsdp:    no tensor parallelism: every mesh axis is data parallel for
             the batch; parameters and optimizer state fully sharded over
             (data, model) and gathered at use.
    """
    global POLICY
    if name not in ("tp_fsdp", "fsdp"):
        raise ValueError(f"unknown sharding policy {name!r}")
    POLICY = name


def batch_axes(mesh, batch_size: int):
    """Shard the batch over pod x data (+ model under the fsdp policy)."""
    names = (("pod", "data", "model") if POLICY == "fsdp"
             else ("pod", "data"))
    sizes = axis_sizes(mesh)
    total = 1
    used = []
    for a in (a for a in names if a in sizes):
        n = sizes[a]
        if batch_size % (total * n) == 0:
            used.append(a)
            total *= n
    if not used:
        return None
    return tuple(used) if len(used) > 1 else used[0]


def _fsdp_pspec(mesh, shape) -> Spec:
    """Pure-FSDP placement: shard the largest dim that divides the
    combined (data, model) axes; fall back to single axes."""
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for combo in (("data", "model"), ("data",), ("model",)):
        size = 1
        for a in combo:
            size *= _axis_size(mesh, a)
        if size == 1:
            continue
        for i in dims:
            if shape[i] % size == 0 and shape[i] >= size:
                spec = [None] * len(shape)
                spec[i] = combo if len(combo) > 1 else combo[0]
                return tuple(spec)
    return (None,) * len(shape)


def param_pspec(mesh, path: str, shape) -> Spec:
    """The spec of the parameter called ``path`` (a state-dict name)."""
    shape = tuple(shape)
    if POLICY == "fsdp":
        return _fsdp_pspec(mesh, shape)
    nd = len(shape)
    m = lambda size: _shard_dim(mesh, size, "model")   # noqa: E731
    d = lambda size: _shard_dim(mesh, size, "data")    # noqa: E731

    if "embed" in path:                       # (V, D)
        return (m(shape[0]), d(shape[1]))
    if "lm_head" in path:                     # (D, V)
        return (d(shape[0]), m(shape[1]))
    if path.endswith("scale") or "norm" in path:
        return (None,) * nd
    # attention: head dims that do not divide the model axis stay
    # unsharded (kv heads below the TP degree are replicated)
    if path.endswith(("wq", "wk", "wv")):     # (D, H, hd)
        return (d(shape[0]), m(shape[1]), None)
    if path.endswith("wo") and nd == 3:       # (H, hd, D)
        return (m(shape[0]), None, d(shape[2]))
    # moe
    if "router" in path:                      # (D, E)
        return (d(shape[0]), None)
    if nd == 3 and ("wi" in path or "wg" in path):   # (E, D, F)
        return (m(shape[0]), d(shape[1]), None)
    if nd == 3 and "wo" in path:              # (E, F, D)
        return (m(shape[0]), None, d(shape[2]))
    # dense mlp
    if nd == 2 and ("wi" in path or "wg" in path):   # (D, F)
        return (d(shape[0]), m(shape[1]))
    if nd == 2 and "wo" in path:              # (F, D)
        return (m(shape[0]), d(shape[1]))
    # ssm / rglru projections
    if nd == 2 and any(k in path for k in
                       ("in_x", "in_z", "in_rec", "in_gate", "w_a", "w_x",
                        "in_B", "in_C", "in_dt")):
        return (d(shape[0]), m(shape[1]))
    if nd == 2 and path.endswith("out"):      # (din|W, D)
        return (m(shape[0]), d(shape[1]))
    if nd == 2 and "conv_w" in path:          # (K, C)
        return (None, m(shape[1]))
    if nd == 1:                               # per-channel vectors
        return (m(shape[0]),)
    return (None,) * nd


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tuple(tree.shape))


def params_shardings(mesh, params: Mapping) -> dict[str, Sharding]:
    """``{name: Sharding}`` of a parameter (or optimizer ``m``/``v``)
    dict; ``params`` values need only a ``shape``."""
    return {name: sharding(mesh, param_pspec(mesh, name, leaf.shape)
                           if len(leaf.shape) else ())
            for name, leaf in params.items()}


def opt_state_shardings(mesh, psharding: Mapping) -> dict:
    """``m``/``v`` mirror the parameters; ``step`` is replicated."""
    return {"m": psharding, "v": psharding, "step": sharding(mesh, ())}


def batch_shardings(mesh, batch: Any) -> Any:
    """Inputs: the leading (batch) dim over pod x data."""
    def one(shape):
        if not shape:
            return sharding(mesh, ())
        return sharding(mesh, (batch_axes(mesh, shape[0]),)
                        + (None,) * (len(shape) - 1))
    return _map(batch, one)


def cache_shardings(mesh, caches: Any, batch_size: int) -> Any:
    """KV caches / recurrent state: the batch dim (the first of size
    ``batch_size``) over data, and the last other dim that divides the
    model axis over model."""
    msize = _axis_size(mesh, "model")

    def one(shape):
        axes: list = [None] * len(shape)
        for i, s in enumerate(shape):
            if s == batch_size:
                axes[i] = batch_axes(mesh, batch_size)
                break
        if msize > 1:
            for i in range(len(shape) - 1, 0, -1):
                if axes[i] is None and shape[i] % msize == 0 \
                        and shape[i] >= msize:
                    axes[i] = "model"
                    break
        return sharding(mesh, tuple(axes))
    return _map(caches, one)


def distribute_lm(lm, mesh) -> None:
    """Replace ``lm``'s parameters, in place, by DTensors on ``mesh`` under
    :func:`params_shardings`, and set ``lm.tp_axis``: the model axis does
    tensor parallelism under the ``tp_fsdp`` policy, none under ``fsdp``."""
    params = dict(lm.named_parameters())
    shardings = params_shardings(mesh, params)
    for name, p in params.items():
        mod, _, leaf = name.rpartition(".")
        owner = lm.get_submodule(mod) if mod else lm
        setattr(owner, leaf, nn.Parameter(
            place(p.detach(), mesh, shardings[name].placements)))
    lm.tp_axis = "model" if POLICY == "tp_fsdp" else None


def distribute_tree(tree, mesh, shardings):
    """``tree`` (dicts, lists, tuples of tensors) placed leaf by leaf by the
    matching ``Sharding`` tree (:func:`batch_shardings` or
    :func:`cache_shardings`)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, mesh, s)
                          for v, s in zip(tree, shardings))
    return place(tree, mesh, shardings.placements)
