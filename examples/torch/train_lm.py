"""End-to-end training example on the PyTorch port: a ~100M-parameter dense
LM on the synthetic bigram language, with checkpointing/resume and the
fault-tolerant runner.

The port's counterpart of ``examples/train_lm.py``, with its flags and its
printed lines.  The model trains on ``--device`` (default: the card;
without one this raises, so pass ``--device cpu`` for the plain PyTorch
path).  The weights are drawn on the CPU from seed 0 by a
``torch.Generator`` and moved; ``main(params=...)`` takes any state dict
instead.  The runner resumes from the newest checkpoint under ``--ckpt``;
the default directory is not the reference example's, whose checkpoints
are in another format.  A run that resumes at ``--steps`` runs no step and
says so (the reference's example fails there on an empty loss list).

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 150] \
        [--quick] [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.runner import RunnerConfig, run
from repro_torch.train.train_step import make_train_step

# ~100M params: 51M embedding+head (vocab 50k x 512) + ~50M blocks
CFG_100M = ModelConfig(
    name="repro-100m", family="dense", n_layers=16, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=2048, vocab=50_000, mlp="swiglu",
    dtype="float32", remat=False)

CFG_QUICK = dataclasses.replace(
    CFG_100M, name="repro-8m", n_layers=4, d_model=128, d_ff=512,
    vocab=4096, n_heads=4, n_kv_heads=2)


def main(argv=None, params: dict | None = None):
    """Train; ``params``: the model's state dict (default: drawn from seed
    0).  Returns ``(lm, opt_state, report)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: cuda; raises "
                         "without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CFG_QUICK if args.quick else CFG_100M
    print(f"model {cfg.name}: {cfg.n_params()/1e6:.1f}M params")
    if params is None:
        lm = LM(cfg, seed=0, device=device)
    else:
        lm = LM(cfg, seed=None, device=device)
        lm.load_state_dict(params)
    ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=20,
                               total_steps=args.steps)
    opt_state = opt.init_state(dict(lm.named_parameters()))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=0))
    step_fn = make_train_step(lm, ocfg)
    rcfg = RunnerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                        ckpt_every=50, log_every=10)

    def nb(s):
        return {k: torch.from_numpy(v).to(device, torch.long)
                for k, v in pipe.batch(s).items()}

    lm, opt_state, report = run(rcfg, step_fn, lm, opt_state, nb)
    if not report.losses:
        print(f"ran 0 steps: {args.ckpt} already holds step "
              f"{report.final_step} of {args.steps}")
        return lm, opt_state, report
    print(f"ran {report.steps_run} steps; "
          f"loss {report.losses[0]:.3f} -> {report.losses[-1]:.3f}; "
          f"stragglers {report.n_stragglers}")
    first, last = np.mean(report.losses[:10]), np.mean(report.losses[-10:])
    if not last < first:
        raise AssertionError("loss did not improve")
    print("OK")
    return lm, opt_state, report


if __name__ == "__main__":
    main()
