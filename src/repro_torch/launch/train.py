"""Training launcher: mesh, sharding policy and the fault-tolerant runner.

Counterpart of ``repro.launch.train``.  ``--smoke`` trains the arch's
``smoke()`` config; without it the full-size config.  On one rank the
model is plain tensors (the smoke on the 1x1 host mesh, the full size on
the production mesh over the one rank).  Under ``torchrun`` with several
ranks the model is sharded over the production mesh of the world
(:func:`repro_torch.launch.mesh.make_production_mesh`): the parameters and
the optimizer state are DTensors placed by ``launch/sharding.py``'s rules
(``--policy``), and each rank holds its rows of every batch
(:mod:`repro_torch.models.parallel`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --steps 20 [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --steps 20 [--device cpu]

The model runs on the card unless ``--device cpu`` is given (without a
card and without it, this raises); several ranks talk over NCCL on cards,
over gloo with ``--device cpu``.  Its weights are drawn on the CPU from
seed 0 (on every rank) and moved.  For the ``audio`` and ``vlm`` families
the frame and image embeddings of step ``s`` are drawn from a
``torch.Generator`` seeded with ``s`` (the reference draws
``jax.random.normal(PRNGKey(s))``).  :func:`build` and :func:`train` are
the launcher's two halves, for callers that run it in-process.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs.archs import ARCHS, smoke as smoke_cfg
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import parallel
from repro_torch.models.model import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.runner import RunnerConfig, RunReport, run
from repro_torch.train.train_step import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (on the 1-device host mesh when "
                         "there is one rank)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--policy", default="tp_fsdp",
                    choices=["tp_fsdp", "fsdp"])
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_launch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: cuda; raises "
                         "without a card)")
    return ap


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def build(args, params: dict | None = None, mesh=None) -> LM:
    """The model of ``args`` on its device: drawn from seed 0, or loaded
    from the state dict ``params``.  On a world of one rank it is plain
    tensors; on more, or when a ``mesh`` is given, its parameters are
    DTensors on that mesh (default: the production mesh of the world).
    Prints the reference's first line (rank 0)."""
    device = resolve_device(args.device)
    sh.set_policy(args.policy)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_cfg(cfg)
    sharded = mesh is not None
    if mesh is None:
        mesh = (make_host_mesh(device) if args.smoke
                and not _launched() else make_production_mesh(device=device))
        sharded = mesh.size() > 1
    if params is None:
        lm = LM(cfg, seed=0, device=device)
    else:
        lm = LM(cfg, seed=None, device=device)
        lm.load_state_dict(params)
    if sharded:
        sh.distribute_lm(lm, mesh)
    if _rank0():
        print(f"{cfg.name}: {cfg.n_params()/1e6:.1f}M params on "
              f"{mesh.size()} devices ({args.policy})")
    return lm


def _launched() -> bool:
    """Several ranks: torchrun's environment, or a group already made."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def batch_fn(cfg: ModelConfig, args, device, mesh=None):
    """``next_batch(step)``: the pipeline's tokens and labels of ``step``
    on ``device``, with the audio frames or VLM image embeddings drawn
    from a ``torch.Generator`` seeded with ``step``; placed on ``mesh`` by
    the batch rules when one is given."""
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch))

    def next_batch(s):
        b = {k: torch.from_numpy(v).to(device, torch.long)
             for k, v in pipe.batch(s).items()}
        gen = torch.Generator().manual_seed(s)
        if cfg.family == "audio":
            b = {"frames": torch.randn((args.batch, args.seq, cfg.d_model),
                                       generator=gen).to(device),
                 "labels": b["labels"]}
        elif cfg.family == "vlm":
            b["image_embeds"] = torch.randn(
                (args.batch, cfg.n_frontend_tokens, cfg.d_model),
                generator=gen).to(device)
        if mesh is not None:       # this rank's rows of the global batch
            b = sh.distribute_tree(b, mesh, sh.batch_shardings(mesh, b))
        return b

    return next_batch


def train(lm: LM, args) -> tuple[LM, dict, RunReport]:
    """Train ``lm`` for ``args.steps`` steps (resuming from ``args.ckpt``)
    and print the reference's last line; returns ``(lm, opt_state,
    report)``."""
    ocfg = opt.OptimizerConfig(total_steps=args.steps)
    opt_state = opt.init_state(dict(lm.named_parameters()))
    step_fn = make_train_step(lm, ocfg, microbatches=args.microbatches)
    rcfg = RunnerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=max(10, args.steps // 3))
    mesh = lm.embed.device_mesh if parallel.is_sharded(lm) else None
    log = print if _rank0() else (lambda msg: None)
    lm, opt_state, report = run(rcfg, step_fn, lm, opt_state,
                                batch_fn(lm.cfg, args, lm.device, mesh),
                                log=log)
    log(f"done: {report.steps_run} steps, "
        f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}")
    return lm, opt_state, report


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    created = not dist.is_initialized()
    try:
        train(build(args), args)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
