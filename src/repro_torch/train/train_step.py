"""Train step: loss -> grads -> AdamW, with optional microbatch gradient
accumulation.

Counterpart of ``repro.train.train_step``.  The step works on the model
in place: it sets the gradients anew, runs ``lm.loss(batch).backward()``
and then :func:`repro_torch.train.optimizer.apply_updates`.

On a sharded model (DTensor parameters and batch) each rank splits its own
rows of the batch into the microbatches: the mean over all of them is the
global batch's, whichever rows a microbatch holds.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.model import LM
from repro_torch.train import optimizer as opt


def make_train_step(lm: LM, ocfg: opt.OptimizerConfig,
                    microbatches: int = 1):
    """Returns ``train_step(lm, opt_state, batch) -> (lm, opt_state,
    metrics)``; ``batch`` leaves have the global batch as leading dim.
    With ``microbatches > 1`` the batch is split along it and the float32
    gradients of ``loss / microbatches`` accumulate over the pieces (the
    reference's ``lax.scan``).  ``metrics``: ``loss``, ``lr``,
    ``grad_norm`` and ``step`` as 0-dim tensors on the model's device."""

    def train_step(lm, opt_state, batch):
        params = dict(lm.named_parameters())
        for p in params.values():
            p.grad = None
        if microbatches == 1:
            loss = lm.loss(batch)
            loss.backward()
        else:
            loss = torch.zeros((), device=lm.device)
            for piece in _pieces(batch, microbatches):
                mloss = lm.loss(piece)
                (mloss / microbatches).backward()
                loss = loss + _plain(mloss.detach()) / microbatches
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        stats = opt.apply_updates(ocfg, params, grads, opt_state)
        return lm, opt_state, {"loss": _plain(loss.detach()), **stats}

    return train_step


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _pieces(batch: dict, n: int) -> list[dict]:
    """``batch`` cut into ``n`` microbatches along the leading dim (a DTensor
    leaf: its local rows, each piece keeping its placements)."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        local = x.to_local() if isinstance(x, DTensor) else x
        rows = local.reshape(n, local.shape[0] // n, *local.shape[1:])
        for i in range(n):
            out[i][k] = (DTensor.from_local(rows[i], x.device_mesh,
                                            x.placements, run_check=False)
                         if isinstance(x, DTensor) else rows[i])
    return out
