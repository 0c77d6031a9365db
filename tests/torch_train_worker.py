"""A rank of ``tests/test_torch_train_multirank.py``'s sharded training.

Started by ``torch.multiprocessing`` (spawn): joins a ``gloo`` group
through a ``file://`` store and, for each case of ``CASES`` (arch, policy,
mesh shape), builds the smoke config on that mesh from the parameters in
``<inp>/<arch>.pt`` (DTensors placed by ``launch/sharding.py``), trains
three steps through ``repro_torch.launch.train``, and saves (rank 0) the
losses, every parameter's full tensor, each rank's local shard shapes
against the ones its placements give, and whether the one-rank checkpoint
in ``<inp>/<arch>_ckpt`` restored onto the mesh bit for bit.  Every rank
then saves the trained state as a checkpoint under ``<out>/<case>_ckpt``,
counting the leaves that the save copies to its host and the most of them
alive at once; rank 0 keeps every rank's counts.
"""
import contextlib
import io
import os
import weakref

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.launch import sharding as sh
from repro_torch.launch import train as port_train
from repro_torch.train import checkpoint as ckpt

CASES = [("gemma-2b", "tp_fsdp", (2, 2)), ("gemma-2b", "fsdp", (1, 4)),
         ("dbrx-132b", "tp_fsdp", (2, 2)), ("dbrx-132b", "fsdp", (1, 4)),
         ("mamba2-1.3b", "tp_fsdp", (2, 2))]
STEPS, BATCH, SEQ = 3, 8, 16


def case_name(arch: str, policy: str, shape) -> str:
    return f"{arch}_{policy}_{'x'.join(map(str, shape))}"


def args_for(arch: str, policy: str, ckpt_dir: str):
    return port_train.build_parser().parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--policy", policy,
         "--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
         "--ckpt", ckpt_dir])


@contextlib.contextmanager
def host_copies():
    """Count ``checkpoint.save``'s copies of a leaf to the host
    (``copies``), and the most of them alive at once (``most``)."""
    seen = {"copies": 0, "live": 0, "most": 0}
    host = ckpt._host

    def drop():
        seen["live"] -= 1

    def counted(leaf):
        arr = host(leaf)
        seen["copies"] += 1
        seen["live"] += 1
        seen["most"] = max(seen["most"], seen["live"])
        weakref.finalize(arr, drop)
        return arr
    ckpt._host = counted
    try:
        yield seen
    finally:
        ckpt._host = host


def run(rank: int, world: int, store: str, inp: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        for arch, policy, shape in CASES:
            name = case_name(arch, policy, shape)
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            params = torch.load(os.path.join(inp, arch + ".pt"))
            args = args_for(arch, policy, os.path.join(out, name + "_run"))
            with contextlib.redirect_stdout(io.StringIO()) as text:
                lm = port_train.build(args, params, mesh=mesh)
                shapes_ok = all(
                    tuple(p.to_local().shape) == tuple(
                        compute_local_shape_and_global_offset(
                            p.shape, mesh, sh.sharding(
                                mesh, sh.param_pspec(mesh, n, p.shape))
                            .placements)[0])
                    for n, p in lm.named_parameters())
                target = {"params": lm.state_dict()}
                back = ckpt.restore(os.path.join(inp, arch + "_ckpt"), 0,
                                    target)["params"]
                restored_ok = all(
                    torch.equal(back[n].full_tensor(), params[n])
                    for n in params)
                lm, opt_state, report = port_train.train(lm, args)
            full = {n: p.full_tensor() for n, p in lm.named_parameters()}
            with host_copies() as seen:
                ckpt.save(os.path.join(out, name + "_ckpt"), STEPS,
                          {"params": lm.state_dict(), "opt": opt_state})
            every = [None] * world
            dist.all_gather_object(every, (seen["copies"], seen["most"]))
            if rank == 0:
                torch.save({"losses": report.losses, "params": full,
                            "shapes_ok": shapes_ok,
                            "restored_ok": restored_ok,
                            "host_copies": every,
                            "stdout": text.getvalue()},
                           os.path.join(out, name + ".pt"))
    finally:
        dist.destroy_process_group()
