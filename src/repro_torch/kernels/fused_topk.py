"""CUDA kernel: fused squared-L2 + running top-k (``csrc/fused_topk.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/fused_topk.py::l2_topk``.
Bound on the H100 by FP32 operations (the closure step's 4096 x ~214k x 96
product is 2.5 ms at 67 TFLOP/s; its input is 25 us of memory traffic).
Each block keeps its queries resident and their top-k in shared memory
while it streams a range of database rows through a ring of ``cp.async``
stages, so the (Q, N) matrix never reaches memory.

Contract (the Pallas kernel's): inputs are cast to float32; the result is
``(vals (Q, k) f32, ids (Q, k) int32)`` in ``(distance, id)`` order, lower
id first on ties; when ``k > N`` the tail is ``(3.4e38, -1)``.  ``k`` runs
from 1 to :data:`K_MAX`; any ``D`` (a block's queries stay in shared memory
at full depth up to its variant's ``max_d``, and stream beside the rows past
it).

Two instantiations of the kernel (:data:`WIDE`, :data:`NARROW`);
:func:`pick_variant` chooses by ``Q``, ``D`` and ``k``.  A small Q leaves
SMs idle, so the rows are split into ``S`` ranges whose per-range top-ks a
merge kernel combines by ``(distance, id)`` (exact).  One call of
:func:`l2_topk` is one launch in :attr:`l2_topk.launches`, whatever kernels
it ran (a row-norm pre-pass, the main kernel, the merge).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class Variant:
    """One instantiation of the kernel in ``csrc/fused_topk.cu``."""
    index: int           # the ``variant`` argument of l2_topk_f32
    block_q: int         # queries per block
    block_n: int         # rows per tile
    k_max: int
    max_d: int           # largest D whose queries stay resident
    blocks_per_sm: int   # the __launch_bounds__ minimum in the source


# Checked against l2_topk_tiles when the library loads.  Wide: 8x8 register
# tiles for Q >= 128, k <= 32, D <= 256 (the closure and the ground truth).
# Narrow: 4x8 tiles for small batches (repro_torch.exec.batched pads to its
# 32 queries), large k and any D.
WIDE = Variant(0, 128, 128, 32, 256, 2)
NARROW = Variant(1, 32, 256, 128, 1024, 2)
VARIANTS = (WIDE, NARROW)
K_MAX = 128
MAX_SPLIT = 64

_PER_SM: dict[tuple[int, int, int, int], int] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_topk")
    if lib.l2_topk_f32.argtypes is None:
        lib.l2_topk_tiles.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.l2_topk_tiles.restype = ctypes.c_int
        for v in VARIANTS:
            tiles = (ctypes.c_int * 5)()
            kmax, max_split = ctypes.c_int(), ctypes.c_int()
            lib.l2_topk_tiles(v.index, tiles, kmax, max_split)
            if (list(tiles) != [v.block_q, v.block_n, v.k_max, v.max_d,
                                v.blocks_per_sm]
                    or [kmax.value, max_split.value] != [K_MAX, MAX_SPLIT]):
                raise RuntimeError("fused_topk.py constants disagree with "
                                   "csrc/fused_topk.cu")
        lib.l2_topk_blocks_per_sm.argtypes = ([ctypes.c_int] * 4
                                              + [ctypes.POINTER(ctypes.c_int)])
        lib.l2_topk_blocks_per_sm.restype = ctypes.c_int
        lib.l2_topk_f32.argtypes = ([ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.l2_topk_f32.restype = ctypes.c_int
    return lib


def _blocks_per_sm(lib: ctypes.CDLL, v: Variant, D: int, k: int,
                   device: int) -> int:
    """Resident blocks an SM at the call's shared memory, from the CUDA
    occupancy query (once per shape class and device); the current device
    must be ``device``."""
    key = (v.index, D, k, device)
    n = _PER_SM.get(key)
    if n is None:
        out = ctypes.c_int()
        _build.check(lib, lib.l2_topk_blocks_per_sm(v.index, D, k, device, out),
                     "l2_topk occupancy")
        n = _PER_SM[key] = max(1, out.value)
    return n


def pick_variant(Q: int, D: int, k: int) -> Variant:
    """The wide tile when a full query block, ``k`` and ``D`` allow it,
    else the narrow one (32-query blocks waste less on a small batch; it
    takes any ``D``)."""
    if Q >= WIDE.block_q and k <= WIDE.k_max and D <= WIDE.max_d:
        return WIDE
    return NARROW


def split_count(Q: int, N: int, sm_count: int, v: Variant,
                per_sm: int | None = None) -> tuple[int, int]:
    """``(S, span)``: how many row ranges, and rows per range.

    Enough ranges that the query blocks times ``S`` fill one wave of
    resident blocks (``per_sm`` a SM: what the call's shared memory allows,
    by default the variant's ``blocks_per_sm``), never more ranges than row
    tiles or :data:`MAX_SPLIT`.
    """
    per_sm = v.blocks_per_sm if per_sm is None else per_sm
    q_blocks = -(-Q // v.block_q)
    tiles = -(-N // v.block_n)
    s = max(1, min(MAX_SPLIT, tiles, (per_sm * sm_count) // max(1, q_blocks)))
    span = max(1, -(-tiles // s)) * v.block_n
    return max(1, -(-N // span)), span


def plan(Q: int, N: int, D: int, k: int, device: int
         ) -> tuple[Variant, int, int]:
    """``(variant, S, span)`` of a call on CUDA ``device``, which must be
    the current device."""
    v = pick_variant(Q, D, k)
    lib = _lib()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return (v, *split_count(Q, N, sms, v, _blocks_per_sm(lib, v, D, k, device)))


def l2_topk(q: torch.Tensor, x: torch.Tensor, k: int = 10
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k nearest on the card: ``(vals (Q, k) f32, ids (Q, k) i32)``."""
    if q.device.type != "cuda" or x.device != q.device:
        raise ValueError(f"l2_topk kernel needs both operands on one CUDA "
                         f"device, got {q.device} and {x.device}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} and {tuple(x.shape)} are "
                         f"not (Q, D) and (N, D)")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"l2_topk kernel takes 1 <= k <= {K_MAX}, got {k}")
    qf = q.to(torch.float32).contiguous()
    xf = x.to(torch.float32).contiguous()
    Q, D = qf.shape
    N = xf.shape[0]
    dev = qf.device
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return vals, ids
    if D == 0:      # every distance is 0: one zero column gives the same
        qf = qf.new_zeros((Q, 1))
        xf = xf.new_zeros((N, 1))
        D = 1
    idx = dev.index
    lib = _lib()
    with torch.cuda.device(dev):
        v, S, span = plan(Q, N, D, k, idx)
        part_v, part_i = vals, ids
        if S > 1:
            part_v = torch.empty((Q, S, k), dtype=torch.float32, device=dev)
            part_i = torch.empty((Q, S, k), dtype=torch.int32, device=dev)
        xnorm = torch.empty((max(N, 1),), dtype=torch.float32, device=dev)
        err = lib.l2_topk_f32(
            qf.data_ptr(), xf.data_ptr(), xnorm.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            Q, N, D, k, v.index, S, span, idx,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "l2_topk")
    l2_topk.launches += 1
    return vals, ids


l2_topk.launches = 0
