"""Distance computation — the paper's dominant compute cost (Fig 2).

Counterpart of ``repro.core.distances``.  ``pairwise_sq_l2`` goes through
:func:`repro_torch.kernels.ops.l2_distance`: the hand-written CUDA kernel
for a CUDA tensor, its plain PyTorch version for a CPU tensor.  Products
elsewhere run in full float32 (no TF32), as the reference's f32 path does.

``topk_smallest`` is :func:`repro_torch.kernels.ops.topk_smallest`: the
hand-written selection kernel for a CUDA tensor, the plain stable sort for a
CPU tensor.  It puts the lower index first on ties, as ``jax.lax.top_k``
does in the reference (``torch.topk``'s tie order is unspecified).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import full_f32_matmul

topk_smallest = ops.topk_smallest


def pairwise_sq_l2(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances.  q: (Q, D), x: (N, D) -> (Q, N) float32.

    float32/bfloat16/int8 inputs; int8 is exact (int32 accumulation),
    floats accumulate in f32 and are clamped at 0.  Operands of two float
    dtypes are both widened to f32 first.
    """
    if q.dtype != x.dtype:
        if torch.int8 in (q.dtype, x.dtype):
            raise TypeError(f"int8 operand paired with {q.dtype}/{x.dtype}")
        q, x = q.float(), x.float()
    return ops.l2_distance(q, x)


def pairwise_neg_ip(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Negative inner product (smaller = closer), (Q, D)x(N, D) -> (Q, N)."""
    with full_f32_matmul():
        return -(q.float() @ x.float().T)


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str = "l2"
             ) -> torch.Tensor:
    if metric == "l2":
        return pairwise_sq_l2(q, x)
    if metric == "ip":
        return pairwise_neg_ip(q, x)
    raise ValueError(f"unknown metric {metric!r}")


# ---------------------------------------------------------------------------
# numpy host path (BKT descent and the simulated-cloud posting-list scan),
# a copy of the reference's.
# ---------------------------------------------------------------------------

def np_sq_l2(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """q: (D,) or (Q, D); x: (N, D) -> (N,) or (Q, N), float32."""
    q = np.asarray(q, dtype=np.float32)
    x = np.asarray(x, dtype=np.float32)
    single = q.ndim == 1
    if single:
        q = q[None]
    qn = np.einsum("qd,qd->q", q, q)[:, None]
    xn = np.einsum("nd,nd->n", x, x)[None, :]
    d = qn + xn - 2.0 * (q @ x.T)
    np.maximum(d, 0.0, out=d)
    return d[0] if single else d
