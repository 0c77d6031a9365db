"""Training launcher: mesh, sharding policy and the fault-tolerant runner.

Counterpart of ``repro.launch.train``, on one rank: ``--smoke`` trains the
arch's ``smoke()`` config on the 1x1 host mesh; without it the full-size
config on the production mesh over the world, which must be one rank for
now (training on a mesh of several ranks, with DTensor placements, is not
ported yet, and a world of more than one rank raises).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --steps 20 [--device cpu]

The model runs on the card unless ``--device cpu`` is given (without a
card and without it, this raises).  Its weights are drawn on the CPU from
seed 0 and moved.  For the ``audio`` and ``vlm`` families the frame and
image embeddings of step ``s`` are drawn from a ``torch.Generator`` seeded
with ``s`` (the reference draws ``jax.random.normal(PRNGKey(s))``).
:func:`build` and :func:`train` are the launcher's two halves, for callers
that run it in-process.
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
from repro_torch.models.model import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.runner import RunnerConfig, RunReport, run
from repro_torch.train.train_step import make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on the 1-device host mesh")
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


def build(args, params: dict | None = None) -> LM:
    """The model of ``args`` on its device, over a one-rank mesh: drawn
    from seed 0, or loaded from the state dict ``params``.  Prints the
    reference's first line."""
    device = resolve_device(args.device)
    sh.set_policy(args.policy)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_cfg(cfg)
        mesh = make_host_mesh(device)
    else:
        mesh = make_production_mesh(device=device)
    if mesh.size() > 1:
        raise SystemExit(
            f"training on {mesh.size()} ranks is not ported yet: "
            "repro_torch.launch.train runs on one rank")
    if params is None:
        lm = LM(cfg, seed=0, device=device)
    else:
        lm = LM(cfg, seed=None, device=device)
        lm.load_state_dict(params)
    print(f"{cfg.name}: {cfg.n_params()/1e6:.1f}M params on "
          f"{mesh.size()} devices ({args.policy})")
    return lm


def batch_fn(cfg: ModelConfig, args, device):
    """``next_batch(step)``: the pipeline's tokens and labels of ``step``
    on ``device``, with the audio frames or VLM image embeddings drawn
    from a ``torch.Generator`` seeded with ``step``."""
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
    lm, opt_state, report = run(rcfg, step_fn, lm, opt_state,
                                batch_fn(lm.cfg, args, lm.device))
    print(f"done: {report.steps_run} steps, "
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
