"""Public entry points of the port's kernels, with ``repro.kernels.ops``'s
signatures.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to its
plain PyTorch version in :mod:`repro_torch.kernels.ref`; anything else
raises.  There is no fallback: a kernel that fails on the card raises.
(This replaces the reference's ``_auto_interpret`` switch between the
Pallas interpreter and Mosaic.)

The ``block_*`` keywords of the Pallas kernels are accepted and ignored:
the CUDA kernels have fixed tiles, and in the reference the tile shape
never changes a result either.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import distance as _distance
from repro_torch.kernels import fused_topk as _fused_topk
from repro_torch.kernels import pq_adc as _pq_adc
from repro_torch.kernels import ref as ref  # re-export the plain versions

_BLOCK_KW = {"block_q", "block_n", "block_d"}


def _route(name: str, *tensors: torch.Tensor, kw: dict) -> str:
    if kw and not kw.keys() <= _BLOCK_KW:
        raise TypeError(f"{name}() got unexpected keywords "
                        f"{sorted(set(kw) - _BLOCK_KW)}")
    # cheap attribute checks first: a graph search routes one call a round
    if all(t.is_cuda for t in tensors):
        return "cuda"
    if all(t.device.type == "cpu" for t in tensors):
        return "cpu"
    raise ValueError(f"{name} takes tensors all on CUDA or all on the CPU, "
                     f"got {[str(t.device) for t in tensors]}")


def l2_distance(q: torch.Tensor, x: torch.Tensor, **kw) -> torch.Tensor:
    """Squared-L2 matrix (Q, N) float32; exact for int8 operands."""
    if _route("l2_distance", q, x, kw=kw) == "cuda":
        return _distance.l2_distance(q, x)
    return ref.l2_distance_ref(q, x)


def l2_topk(q: torch.Tensor, x: torch.Tensor, k: int = 10, **kw
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k nearest: ``(dists (Q, k) f32, ids (Q, k) int32)``."""
    if not 1 <= k <= _fused_topk.K_MAX:
        raise ValueError(f"l2_topk takes 1 <= k <= {_fused_topk.K_MAX}, "
                         f"got {k}")
    if _route("l2_topk", q, x, kw=kw) == "cuda":
        return _fused_topk.l2_topk(q, x, k)
    return ref.l2_topk_ref(q, x, k)


def adc_lookup(codes: torch.Tensor, table: torch.Tensor, **kw) -> torch.Tensor:
    """PQ asymmetric distances (N,) float32 of codes (N, m) uint8/int32 and
    a table (m, 256)."""
    if _route("adc_lookup", codes, table, kw=kw) == "cuda":
        return _pq_adc.adc_lookup(codes, table)
    return ref.adc_lookup_ref(codes, table)
