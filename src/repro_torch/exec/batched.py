"""Pad-to-tile batched execution of the fused top-k kernel.

Counterpart of ``repro.exec.batched``: many concurrent scan jobs against
one shard's candidate pool become *one* ``l2_topk`` dispatch.  Queries pad
up to the kernel's query block; candidates need no padding (the kernel
masks its ragged last tile itself); query padding rows are computed and
dropped — pad waste.

Bit-exactness contract: :func:`batched_topk` result *ids* are identical
to the per-query :func:`scan_topk_oracle` built on the plain versions in
:mod:`repro_torch.kernels.ref`, including tie-break order for duplicate
distances, for ragged batch sizes and ``k > n_candidates`` (tail filled
with ``(+inf, -1)``).  Both sides canonicalize each row by
``(distance, id)``.  Distances are bit-identical too whenever the inputs
are integer-valued (sums below 2**24 are exact in f32 in any order).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import fused_topk, ops

__all__ = ["QUERY_TILE", "CAND_TILE", "pad_amount", "batched_topk",
           "scan_topk_oracle", "coalesce_scan"]

#: The CUDA kernel's small-batch tiles (csrc/fused_topk.cu, the narrow
#: variant): one block owns 32 queries and streams candidates 256 rows at a
#: time, so a batch padded to 32 fills whole blocks; the wide variant's
#: 128-query block, taken from 128 queries up, is a multiple of it.  (The
#: reference's 8x128 were the TPU's f32 sublane x lane tile.)
QUERY_TILE = fused_topk.NARROW.block_q
CAND_TILE = fused_topk.NARROW.block_n


def pad_amount(n: int, tile: int) -> int:
    """Rows of padding needed to round ``n`` up to a multiple of ``tile``."""
    return (-int(n)) % tile


def _canonicalize(vals: np.ndarray, ids: np.ndarray) -> None:
    """Sort each row by (distance, id) in place — the tie-break contract."""
    for i in range(vals.shape[0]):
        order = np.lexsort((ids[i], vals[i]))
        vals[i] = vals[i][order]
        ids[i] = ids[i][order]


def batched_topk(qs, x, k: int, *,
                 device: str | torch.device | None = None):
    """Cross-query fused top-k with explicit pad-to-tile.

    ``qs`` is a ragged batch of B queries (B, D); ``x`` the shared
    candidate matrix (N, D).  Queries are zero-padded to a QUERY_TILE
    multiple and dispatched as ONE ``ops.l2_topk`` call on ``device``.
    Returns numpy ``(vals (B, k) f32, ids (B, k) i32)`` with rows sorted
    by (distance, id); when ``k > N`` the tail is ``(+inf, -1)``.
    """
    dev = resolve_device(device)
    qs = np.ascontiguousarray(np.asarray(qs, dtype=np.float32))
    x = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    B = qs.shape[0]
    N = x.shape[0]
    out_vals = np.full((B, k), np.inf, dtype=np.float32)
    out_ids = np.full((B, k), -1, dtype=np.int32)
    if B == 0 or N == 0 or k == 0:
        return out_vals, out_ids
    k_eff = min(k, N)
    padq = pad_amount(B, QUERY_TILE)
    qp = np.pad(qs, ((0, padq), (0, 0))) if padq else qs
    vals, ids = ops.l2_topk(torch.from_numpy(qp).to(dev),
                            torch.from_numpy(x).to(dev), k_eff)
    out_vals[:, :k_eff] = vals.cpu().numpy()[:B]
    out_ids[:, :k_eff] = ids.cpu().numpy()[:B]
    _canonicalize(out_vals, out_ids)
    return out_vals, out_ids


def scan_topk_oracle(qs, x, k: int):
    """Per-query oracle on the kernel-free plain path, on the CPU.

    Same output contract as :func:`batched_topk` (shape, (+inf, -1)
    fill, (distance, id) row order) but computed one query at a time
    from the full plain distance matrix — no batching, no padding.
    """
    qs = np.asarray(qs, dtype=np.float32)
    x = np.asarray(x, dtype=np.float32)
    B = qs.shape[0]
    N = x.shape[0]
    out_vals = np.full((B, k), np.inf, dtype=np.float32)
    out_ids = np.full((B, k), -1, dtype=np.int32)
    if B == 0 or N == 0 or k == 0:
        return out_vals, out_ids
    k_eff = min(k, N)
    row_ids = np.arange(N, dtype=np.int32)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    for i in range(B):
        d = ops.ref.l2_distance_ref(
            torch.from_numpy(np.ascontiguousarray(qs[i:i + 1])), xt)[0].numpy()
        order = np.lexsort((row_ids, d))[:k_eff]
        out_vals[i, :k_eff] = d[order]
        out_ids[i, :k_eff] = row_ids[order]
    _canonicalize(out_vals, out_ids)
    return out_vals, out_ids


def coalesce_scan(queries, x, global_ids, k: int, *,
                  device: str | torch.device | None = None):
    """Execute a coalesced batch and scatter results back per owner.

    ``queries`` is the list of B owning jobs' query vectors; ``x`` the
    shard's candidate rows with ``global_ids`` giving each row's vector
    id.  One batched dispatch, then row ``i`` of the padded result is
    scattered back to job ``i`` as ``(dists, global ids)`` — padding
    rows and the ``k > N`` tail never leak (-1 ids stay -1).
    """
    gid = np.asarray(global_ids, dtype=np.int64)
    vals, idx = batched_topk(queries, x, k, device=device)
    out = []
    for i in range(len(queries)):
        valid = idx[i] >= 0
        mapped = np.where(valid, gid[np.clip(idx[i], 0, None)], -1)
        out.append((vals[i].copy(), mapped.astype(np.int64)))
    return out
