"""AdamW + cosine schedule + global-norm clipping.

Counterpart of ``repro.train.optimizer``, with its formula and order of
operations: the clip scale ``min(1, clip_norm / (gnorm + 1e-9))``, bias
corrections from the float32 step, ``delta = mhat / (sqrt(vhat) + eps)``,
weight decay added to ``delta`` for tensors of 2 or more dims only, and
``p - lr * delta`` in float32 cast back to ``p.dtype``.  (``torch.optim
.AdamW`` and ``clip_grad_norm_`` decay in another order and clip with
``1e-6``, so they would not give the reference's numbers.)

Parameters, gradients and the state ``m`` / ``v`` are dicts keyed by the
model's parameter names; the state's ``step`` is an int32 0-dim tensor.
Everything stays on the parameters' device (no host sync), and
:func:`apply_updates` writes the parameters and the state in place.

Sharded parameters (DTensors) work unchanged: ``m``/``v`` take their
placements, every update is elementwise on each rank's shard, and
:func:`global_norm` sums each leaf's squares across its shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * peak (float32)."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_state(params: Params) -> dict:
    """Zero ``m`` and ``v`` shaped like ``params``, and step 0."""
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(x.float()))
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tree: Params) -> torch.Tensor:
    """The L2 norm of every leaf together (a DTensor leaf's squares summed
    across its shards)."""
    leaves = [_sum_sq(x) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: Params, grads: Params,
                  state: dict) -> dict:
    """One AdamW step, in place on ``params`` and ``state``.  Returns the
    stats ``{"lr", "grad_norm", "step"}`` (0-dim tensors)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=step.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=step.device), stepf)
    sharded = any(isinstance(p, DTensor) for p in params.values())
    # the 0-dim scalars above are the same on every rank: replicated
    with implicit_replication() if sharded else contextlib.nullcontext():
        _adamw(cfg, params, grads, state, scale, lr, bc1, bc2)
    state["step"] = step
    return {"lr": lr, "grad_norm": gnorm, "step": step}


def _adamw(cfg, params, grads, state, scale, lr, bc1, bc2) -> None:
    b1, b2 = cfg.b1, cfg.b2
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:                       # decay matrices, not norms
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
