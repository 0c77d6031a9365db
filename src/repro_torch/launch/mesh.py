"""Device meshes for the training launcher (``launch/train.py``).

Counterpart of ``repro.launch.mesh``.  Functions, not module constants, so
importing this module creates no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names: ``("data", "model")``, or ``("pod", "data", "model")`` across pods.
Both functions run over the default process group.  When none exists they
create one: from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) when it is there, else a one-rank group
with an in-memory store; gloo on the CPU, NCCL on the card (a caller that
wants it gone destroys it: ``torch.distributed.destroy_process_group()``).

On 256 ranks the production mesh is (32, 8) (``mesh_tag`` "32x8"), on 512
with ``multi_pod`` (2, 32, 8): a node's 8 cards form the model axis, where
the reference's TPU pod is a 16x16 torus ("16x16", "2x16x16").
"""
from __future__ import annotations

import math
import os

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
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    launched = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if device.type == "cuda":
        if launched:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    if launched:                   # torchrun: env:// rendezvous
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)


def mesh_tag(mesh: DeviceMesh) -> str:
    """``"32x8"``: the mesh's axis sizes."""
    return "x".join(str(n) for n in mesh.shape)


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

