"""CUDA kernel: tiled squared-L2 distance matrix (``csrc/l2_distance.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/distance.py::l2_distance``.
Bound on the H100 by FP32 operations at the main path's probe shape (512 x
214,790 x 96: 21.49 GFLOP, 0.3207 ms at 67 TFLOP/s, against 522.6 MB,
0.156 ms at 3.35 TB/s); the source's header says how the design meets that.
float32, bfloat16 (widened to float32 here, so the float32 kernel runs the
same chains as on float32 data) and int8 (exact int32 accumulation); float
results are clamped at 0.  The wrapper takes CUDA tensors only:
:mod:`repro_torch.kernels.ops` sends CPU tensors to
:func:`repro_torch.kernels.ref.l2_distance_ref`.

Two instantiations of the kernel (:data:`WIDE`, :data:`SIMPLE`), which give
the same float32 bits; :func:`pick_variant` chooses by ``Q``, ``D`` and the
dtype, and :func:`plan` sizes the wide kernel's row ranges by the occupancy
at the call's shared memory.  One call of :func:`l2_distance` is one launch
in :attr:`l2_distance.launches`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class Variant:
    """One instantiation of the kernel in ``csrc/l2_distance.cu``."""
    index: int           # the ``variant`` argument of l2_distance_f32
    name: str
    block_q: int         # queries per block
    block_n: int         # rows per tile
    max_d: int | None    # largest D it takes (None: any)


# Checked against l2_distance_tiles when the library loads.  Wide: 8x8
# register tiles, the query block resident, row ranges walked through a
# cp.async ring (float32, Q >= 128, D <= 256: the centroid probe).  Simple:
# one 64x64 output tile a block (small batches, large D, int8).
WIDE = Variant(0, "wide", 128, 128, 256)
SIMPLE = Variant(1, "simple", 64, 64, None)
VARIANTS = {v.name: v for v in (WIDE, SIMPLE)}
WIDE_BLOCKS_PER_SM = 2        # its __launch_bounds__ minimum
_MAX_Q = 65535 * SIMPLE.block_q   # the simple grid's y limit x its query rows
_FLOATS = (torch.float32, torch.bfloat16)

_PER_SM: dict[tuple[int, int], int] = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one call launches: the variant and, for the wide one, the row
    ranges (``ranges`` of ``span`` rows; the simple kernel has one)."""
    variant: Variant
    ranges: int
    span: int


def _lib() -> ctypes.CDLL:
    lib = _build.load("l2_distance")
    if lib.l2_distance_f32.argtypes is None:
        lib.l2_distance_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.l2_distance_tiles.restype = ctypes.c_int
        tiles = (ctypes.c_int * 6)()
        lib.l2_distance_tiles(tiles)
        if list(tiles) != [WIDE.block_q, WIDE.block_n, WIDE.max_d,
                           WIDE_BLOCKS_PER_SM, SIMPLE.block_q, SIMPLE.block_n]:
            raise RuntimeError("distance.py constants disagree with "
                               "csrc/l2_distance.cu")
        lib.l2_distance_blocks_per_sm.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.l2_distance_blocks_per_sm.restype = ctypes.c_int
        lib.l2_distance_i8.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                       + [ctypes.c_void_p])
        lib.l2_distance_i8.restype = ctypes.c_int
        lib.l2_distance_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
        lib.l2_distance_f32.restype = ctypes.c_int
    return lib


def takes(v: Variant, D: int, dtype: torch.dtype) -> bool:
    """Whether variant ``v`` computes a call of depth ``D`` and ``dtype``."""
    if v is SIMPLE:
        return True
    return dtype in _FLOATS and 1 <= D <= WIDE.max_d


def pick_variant(Q: int, D: int, dtype: torch.dtype = torch.float32) -> Variant:
    """The wide tile for a full query block of float operands at a depth
    its resident queries hold, else the simple one (a small batch pads less
    in 64-query tiles; it takes any ``D`` and int8)."""
    if Q >= WIDE.block_q and takes(WIDE, D, dtype):
        return WIDE
    return SIMPLE


def split_count(Q: int, N: int, sm_count: int,
                per_sm: int = WIDE_BLOCKS_PER_SM) -> tuple[int, int]:
    """``(ranges, span)`` of the wide kernel: enough row ranges that the
    query blocks times the ranges fill one wave of ``per_sm`` resident
    blocks an SM, never more ranges than row tiles; ``span`` is a whole
    number of tiles and the ranges cover ``[0, N)``."""
    q_blocks = -(-Q // WIDE.block_q)
    tiles = -(-N // WIDE.block_n)
    s = max(1, min(tiles, (per_sm * sm_count) // max(1, q_blocks)))
    span = max(1, -(-tiles // s)) * WIDE.block_n
    return max(1, -(-N // span)), span


def _blocks_per_sm(lib: ctypes.CDLL, D: int, device: int) -> int:
    """Resident wide blocks an SM at the call's shared memory, from the
    CUDA occupancy query (once per D and device); ``device`` is current."""
    key = (D, device)
    n = _PER_SM.get(key)
    if n is None:
        out = ctypes.c_int()
        _build.check(lib, lib.l2_distance_blocks_per_sm(D, device, out),
                     "l2_distance occupancy")
        n = _PER_SM[key] = max(1, out.value)
    return n


def plan(Q: int, N: int, D: int, device: int,
         dtype: torch.dtype = torch.float32, variant: str | None = None) -> Plan:
    """The :class:`Plan` of a call on CUDA ``device``, which must be the
    current device; ``variant`` (a name in :data:`VARIANTS`) forces one."""
    if variant is None:
        v = pick_variant(Q, D, dtype)
    elif variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, "
                         f"got {variant!r}")
    else:
        v = VARIANTS[variant]
        if not takes(v, D, dtype):
            raise ValueError(f"the {v.name} variant takes float operands of "
                             f"1 <= D <= {v.max_d}, got D={D}, {dtype}")
    if v is SIMPLE:
        return Plan(v, 1, N)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return Plan(v, *split_count(Q, N, sms, _blocks_per_sm(_lib(), D, device)))


def l2_distance(q: torch.Tensor, x: torch.Tensor, *,
                variant: str | None = None) -> torch.Tensor:
    """Squared-L2 matrix (Q, N) float32 of q (Q, D) and x (N, D) on the card.

    ``variant`` (``"wide"`` or ``"simple"``) forces an instantiation; by
    default :func:`pick_variant` chooses.
    """
    if q.device.type != "cuda" or x.device != q.device:
        raise ValueError(f"l2_distance kernel needs both operands on one CUDA "
                         f"device, got {q.device} and {x.device}")
    if q.dtype != x.dtype or q.dtype not in (*_FLOATS, torch.int8):
        raise TypeError(f"l2_distance takes float32, bfloat16 or int8 "
                        f"operands of one dtype, got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} and {tuple(x.shape)} are "
                         f"not (Q, D) and (N, D)")
    Q, D = q.shape
    N = x.shape[0]
    dev = q.device
    lib = _lib()
    with torch.cuda.device(dev):
        p = plan(Q, N, D, dev.index, q.dtype, variant)
        if p.variant is SIMPLE and Q > _MAX_Q:
            raise ValueError(f"Q={Q} exceeds the simple kernel's grid ({_MAX_Q})")
        out = torch.empty((Q, N), dtype=torch.float32, device=dev)
        if Q == 0 or N == 0:
            return out
        if q.dtype != torch.int8:
            q, x = q.float(), x.float()
        q, x = q.contiguous(), x.contiguous()   # held until the launch is queued
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.int8:
            err = lib.l2_distance_i8(q.data_ptr(), x.data_ptr(), out.data_ptr(),
                                     Q, N, D, stream)
        else:
            err = lib.l2_distance_f32(q.data_ptr(), x.data_ptr(), out.data_ptr(),
                                      Q, N, D, p.variant.index, p.ranges, p.span,
                                      dev.index, stream)
    _build.check(lib, err, "l2_distance")
    l2_distance.launches += 1
    return out


l2_distance.launches = 0
