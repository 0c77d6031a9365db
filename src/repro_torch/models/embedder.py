"""LM -> vector-search bridge: pooled embeddings from backbone states.

Counterpart of ``repro.models.embedder``: documents are embedded by the LM,
indexed by ``repro_torch.core``, and queried at serving time
(``python -m repro_torch.launch.serve``).  The embedding width is
``d_model`` unless a random projection to ``out_dim`` is asked for; that
projection is drawn from a ``torch.Generator`` seeded with ``seed``, not
from ``jax.random`` as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import full_f32_matmul


@torch.no_grad()
def embed_tokens(lm, batch, out_dim: int | None = None,
                 seed: int = 0) -> np.ndarray:
    """Mean-pooled, L2-normalised embeddings (B, out_dim or d_model)."""
    x = lm._backbone(batch)                    # (B, S, D) final-norm states
    pooled = x.float().mean(dim=1)
    if out_dim is not None and out_dim != pooled.shape[-1]:
        gen = torch.Generator().manual_seed(seed)
        proj = (torch.randn((pooled.shape[-1], out_dim), generator=gen)
                / out_dim ** 0.5).to(pooled.device)
        with full_f32_matmul():
            pooled = pooled @ proj
    norm = pooled.norm(dim=-1, keepdim=True)
    return (pooled / norm.clamp_min(1e-9)).cpu().numpy()
