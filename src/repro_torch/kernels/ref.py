"""Plain PyTorch versions of every CUDA kernel in this package.

The CPU path of :mod:`repro_torch.kernels.ops` runs these, the tests hold
them against ``repro``'s oracles, and ``chip_smoke.py`` holds each kernel
against them on the card.  Matrix products run in full float32: TF32 is
switched off explicitly around every product (it keeps ~3 decimal digits,
far outside the kernels' 1e-5 tolerance).

Top-k here is a stable sort: the order is ``(distance, id)``, lower id
first on ties, as ``jax.lax.top_k`` and the Pallas kernel give it.  Bare
``torch.topk`` leaves tie order unspecified and is never used.
"""
from __future__ import annotations

import contextlib

import torch

BIG = 3.4e38       # tail value of l2_topk when k > N (repro fused_topk._BIG)


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products without TF32 on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def l2_distance_ref(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2: q (Q, D), x (N, D) -> (Q, N) float32.

    f32 accumulation for float inputs (bf16 is widened first), clamped at
    0.  int8 is exact: float64 holds every integer sum below 2**53, so the
    result equals the int32 path's, rounded once to float32.
    """
    if q.dtype == torch.int8:
        qd, xd = q.double(), x.double()
        qn = (qd * qd).sum(-1)[:, None]
        xn = (xd * xd).sum(-1)[None, :]
        return (qn + xn - 2.0 * (qd @ xd.T)).float()
    qf, xf = q.float(), x.float()
    qn = (qf * qf).sum(-1)[:, None]
    xn = (xf * xf).sum(-1)[None, :]
    with full_f32_matmul():
        ip = qf @ xf.T
    return torch.clamp_min(qn + xn - 2.0 * ip, 0.0)


def stable_topk_smallest(d: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest along the last axis, lower index first on ties.

    Returns ``(values, indices int64)``; ``k`` must not exceed the axis.
    """
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return d.gather(-1, idx), idx


def adc_lookup_ref(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """PQ asymmetric distance: codes (N, m) int, table (m, 256) -> (N,) f32.

    ``out[n] = sum_j table[j, codes[n, j]]``, summed in float32.
    """
    m = table.shape[0]
    ar = torch.arange(m, device=codes.device)
    return table.float()[ar[None, :], codes.long()].sum(-1)


def l2_topk_ref(q: torch.Tensor, x: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused distance + top-k: returns (dists (Q, k) f32, ids (Q, k) int32).

    Inputs are cast to float32 first, as the kernel does.  When k > N the
    tail is ``(3.4e38, -1)``.
    """
    d = l2_distance_ref(q.float(), x.float())
    kk = min(k, d.shape[1])
    vals, idx = stable_topk_smallest(d, kk)
    idx = idx.to(torch.int32)
    if kk < k:
        pad = (0, k - kk)
        vals = torch.nn.functional.pad(vals, pad, value=BIG)
        idx = torch.nn.functional.pad(idx, pad, value=-1)
    return vals, idx
