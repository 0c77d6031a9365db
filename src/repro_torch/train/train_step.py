"""Train step: loss -> grads -> AdamW, with optional microbatch gradient
accumulation.

Counterpart of ``repro.train.train_step``.  The step works on the model
in place: it sets the gradients anew, runs ``lm.loss(batch).backward()``
and then :func:`repro_torch.train.optimizer.apply_updates`.
"""
from __future__ import annotations

import torch

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
            pieces = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                                   *x.shape[1:]) for k, x in batch.items()}
            for i in range(microbatches):
                mloss = lm.loss({k: x[i] for k, x in pieces.items()})
                (mloss / microbatches).backward()
                loss = loss + mloss.detach() / microbatches
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        stats = opt.apply_updates(ocfg, params, grads, opt_state)
        return lm, opt_state, {"loss": loss.detach(), **stats}

    return train_step
