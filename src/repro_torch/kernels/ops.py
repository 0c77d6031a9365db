"""Public entry points of the port's kernels, with ``repro.kernels.ops``'s
signatures.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to its
plain PyTorch version in :mod:`repro_torch.kernels.ref`; anything else
raises.  There is no fallback: a kernel that fails on the card raises.
(This replaces the reference's ``_auto_interpret`` switch between the
Pallas interpreter and Mosaic.)

Each kernel is a ``torch.library`` custom op (``repro_torch::l2_distance``,
``repro_torch::l2_topk``, ``repro_torch::adc_lookup``,
``repro_torch::topk_smallest``) with a fake implementation that gives only
the output's shape and dtype, and, for the three distance kernels, a FLOP
formula for ``FlopCounterMode`` (a selection is no floating-point product).
So a fake tensor (``FakeTensorMode``, the dry-run's) gets its shapes and
is never computed on, and never reaches a kernel launch.  A plain tensor
outside any dispatch mode takes the same implementation without the
dispatcher's round trip (a graph search makes one call a round).

The ``block_*`` keywords of the Pallas kernels are accepted and ignored:
the CUDA kernels have fixed tiles, and in the reference the tile shape
never changes a result either.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.kernels import distance as _distance
from repro_torch.kernels import fused_topk as _fused_topk
from repro_torch.kernels import pq_adc as _pq_adc
from repro_torch.kernels import topk_select as _topk_select
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


# ------------------------------------------------------------ custom ops --

def _l2_distance_impl(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if _route("l2_distance", q, x, kw={}) == "cuda":
        return _distance.l2_distance(q, x)
    return ref.l2_distance_ref(q, x)


_l2_distance_op = torch.library.custom_op(
    "repro_torch::l2_distance", _l2_distance_impl, mutates_args=())


@_l2_distance_op.register_fake
def _(q, x):
    return q.new_empty((q.shape[0], x.shape[0]), dtype=torch.float32)


def _l2_topk_impl(q: torch.Tensor, x: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    if _route("l2_topk", q, x, kw={}) == "cuda":
        return _fused_topk.l2_topk(q, x, k)
    return ref.l2_topk_ref(q, x, k)


_l2_topk_op = torch.library.custom_op(
    "repro_torch::l2_topk", _l2_topk_impl, mutates_args=())


@_l2_topk_op.register_fake
def _(q, x, k):
    return (q.new_empty((q.shape[0], k), dtype=torch.float32),
            q.new_empty((q.shape[0], k), dtype=torch.int32))


def _adc_lookup_impl(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    if _route("adc_lookup", codes, table, kw={}) == "cuda":
        return _pq_adc.adc_lookup(codes, table)
    return ref.adc_lookup_ref(codes, table)


_adc_lookup_op = torch.library.custom_op(
    "repro_torch::adc_lookup", _adc_lookup_impl, mutates_args=())


@_adc_lookup_op.register_fake
def _(codes, table):
    return table.new_empty((codes.shape[0],), dtype=torch.float32)


def _topk_smallest_impl(d: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    if _route("topk_smallest", d, kw={}) == "cuda":
        return _topk_select.topk_smallest(d, k)
    return ref.stable_topk_smallest(d, k)


_topk_smallest_op = torch.library.custom_op(
    "repro_torch::topk_smallest", _topk_smallest_impl, mutates_args=())


@_topk_smallest_op.register_fake
def _(d, k):
    # the plain version's shapes: it keeps d's dtype (float32 on the card)
    # and gives min(k, N) columns on the CPU
    shape = (*d.shape[:-1], min(k, d.shape[-1]))
    return d.new_empty(shape), d.new_empty(shape, dtype=torch.int64)


def _distance_flops(q_shape, x_shape, *args, out_shape=None, **kw) -> int:
    """2·Q·N·D: one multiply and one add per (query, row, dim); the norms
    and the combination are O(Q·N + (Q + N)·D) and not counted, as a
    matmul's formula leaves out its epilogue.  (The top-k selection of
    ``l2_topk`` is not a floating-point product either.)"""
    return 2 * q_shape[0] * x_shape[0] * q_shape[1]


def _adc_flops(codes_shape, table_shape, *args, out_shape=None, **kw) -> int:
    """N·m: one add of a table entry per (code row, sub-space)."""
    return codes_shape[0] * codes_shape[1]


for _op, _formula in ((torch.ops.repro_torch.l2_distance, _distance_flops),
                      (torch.ops.repro_torch.l2_topk, _distance_flops),
                      (torch.ops.repro_torch.adc_lookup, _adc_flops)):
    if _op not in flop_registry:
        register_flop_formula(_op)(_formula)


def _eager(*tensors: torch.Tensor) -> bool:
    """Plain tensors and no dispatch mode (fake, FLOP counter) active."""
    return (_get_current_dispatch_mode() is None
            and all(type(t) is torch.Tensor for t in tensors))


# ---------------------------------------------------------- entry points --

def l2_distance(q: torch.Tensor, x: torch.Tensor, **kw) -> torch.Tensor:
    """Squared-L2 matrix (Q, N) float32; exact for int8 operands."""
    _route("l2_distance", q, x, kw=kw)
    if _eager(q, x):
        return _l2_distance_impl(q, x)
    return torch.ops.repro_torch.l2_distance(q, x)


def l2_topk(q: torch.Tensor, x: torch.Tensor, k: int = 10, **kw
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k nearest: ``(dists (Q, k) f32, ids (Q, k) int32)``."""
    if not 1 <= k <= _fused_topk.K_MAX:
        raise ValueError(f"l2_topk takes 1 <= k <= {_fused_topk.K_MAX}, "
                         f"got {k}")
    _route("l2_topk", q, x, kw=kw)
    if _eager(q, x):
        return _l2_topk_impl(q, x, k)
    return torch.ops.repro_torch.l2_topk(q, x, k)


def adc_lookup(codes: torch.Tensor, table: torch.Tensor, **kw) -> torch.Tensor:
    """PQ asymmetric distances (N,) float32 of codes (N, m) uint8/int32 and
    a table (m, 256)."""
    _route("adc_lookup", codes, table, kw=kw)
    if _eager(codes, table):
        return _adc_lookup_impl(codes, table)
    return torch.ops.repro_torch.adc_lookup(codes, table)


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest along the last axis, ascending, lower index first
    on ties: ``(values, indices int64)``.  A CUDA tensor (float32, ``1 <= k
    <= min(N, 1024)``) goes to the selection kernel, a CPU tensor to
    :func:`repro_torch.kernels.ref.stable_topk_smallest`."""
    if _eager(d):
        if d.is_cuda:               # the search's path: three calls a batch
            return _topk_select.topk_smallest(d, k)
        return _topk_smallest_impl(d, k)
    if _route("topk_smallest", d, kw={}) == "cuda":
        _topk_select.check(d, k)
    return torch.ops.repro_torch.topk_smallest(d, k)
