"""Device meshes for the training launcher (``launch/train.py``).

Counterpart of ``repro.launch.mesh``.  Functions, not module constants, so
importing this module creates no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names: ``("data", "model")``, or ``("pod", "data", "model")`` across pods.
Both functions run over the default process group and create a one-rank
group (gloo on the CPU, NCCL on the card, an in-memory store) when none
exists (a caller that wants it gone destroys it:
``torch.distributed.destroy_process_group()``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

#: cards a node joins all to all (NVLink): the widest tensor-parallel axis
NODE_CARDS = 8
#: pods of a multi-pod mesh (the reference's two)
PODS = 2


def _ensure_group(device: torch.device) -> None:
    if dist.is_initialized():
        return
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **kw)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The world as ``(world // model, model)``, or ``(PODS, world //
    (PODS * model), model)`` when ``multi_pod``; the tensor-parallel axis
    ``model`` is the largest divisor of the world up to ``NODE_CARDS``."""
    device = resolve_device(device)
    _ensure_group(device)
    world = dist.get_world_size()
    model = math.gcd(world, NODE_CARDS)
    if multi_pod:
        shape = (PODS, world // (PODS * model), model)
        axes = ("pod", "data", "model")
    else:
        shape, axes = (world // model, model), ("data", "model")
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} does not cover the world of {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """Degenerate 1x1 mesh with the same axis names, over rank 0 of a
    one-rank group: every sharded program also runs on one device."""
    device = resolve_device(device)
    _ensure_group(device)
    return DeviceMesh(device.type, [[0]], mesh_dim_names=("data", "model"))

