"""Exact brute-force search — ground-truth oracle for recall measurement.

Counterpart of ``repro.core.flat``: the same function as ``pairwise_sq_l2``
followed by ``topk_smallest``, computed by the fused
:func:`repro_torch.kernels.ops.l2_topk` so the (Q, N) matrix never reaches
memory.  (int8 data gives the same distances: the kernel's f32 sums of
int8 products are exact below 2**24, i.e. for D up to ~1000.)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def exact_topk(
    x: np.ndarray, queries: np.ndarray, k: int, chunk: int = 512,
    *, device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact k-NN.  Returns (ids (Q, k) int64, dists (Q, k) f32)."""
    dev = resolve_device(device)
    xs = torch.as_tensor(np.ascontiguousarray(x)).to(dev)
    qs_all = torch.as_tensor(np.ascontiguousarray(queries)).to(dev)
    out_ids = []
    out_d = []
    for s in range(0, len(queries), chunk):
        vals, idx = ops.l2_topk(qs_all[s:s + chunk], xs, k)
        out_ids.append(idx.cpu().numpy().astype(np.int64))
        out_d.append(vals.cpu().numpy())
    return np.concatenate(out_ids), np.concatenate(out_d)
