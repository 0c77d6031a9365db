"""CUDA kernel: fused squared-L2 + running top-k (``csrc/fused_topk.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/fused_topk.py::l2_topk``.
Bound on the H100 by FP32 operations (the closure step's 4096 x ~214k x 96
product is 2.5 ms at 67 TFLOP/s; its input is 25 us of memory traffic).
Each block keeps its queries' top-k in shared memory while it streams a
range of database rows, so the (Q, N) matrix never reaches memory.

Contract (the Pallas kernel's): inputs are cast to float32; the result is
``(vals (Q, k) f32, ids (Q, k) int32)`` in ``(distance, id)`` order, lower
id first on ties; when ``k > N`` the tail is ``(3.4e38, -1)``.  ``k`` runs
from 1 to :data:`K_MAX`.

A small Q leaves SMs idle, so the rows are split into ``S`` ranges whose
per-range top-ks a second kernel merges by ``(distance, id)`` (exact); one
call of :func:`l2_topk` is one launch in :attr:`l2_topk.launches`, whether
it ran one kernel or two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Tiles and limits of csrc/fused_topk.cu, checked against the library when
# it loads (repro_torch.exec.batched pads to BLOCK_Q).
BLOCK_Q = 32
BLOCK_N = 64
K_MAX = 128
MAX_SPLIT = 64
RESIDENT_BLOCKS_PER_SM = 4    # __launch_bounds__(256, 4) in the source


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_topk")
    if lib.l2_topk_f32.argtypes is None:
        lib.l2_topk_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.l2_topk_tiles.restype = ctypes.c_int
        got = [ctypes.c_int() for _ in range(4)]
        lib.l2_topk_tiles(*got)
        if [g.value for g in got] != [BLOCK_Q, BLOCK_N, K_MAX, MAX_SPLIT]:
            raise RuntimeError("fused_topk.py constants disagree with "
                               "csrc/fused_topk.cu")
        lib.l2_topk_f32.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.l2_topk_f32.restype = ctypes.c_int
    return lib


def split_count(Q: int, N: int, sm_count: int) -> tuple[int, int]:
    """``(S, span)``: how many row ranges, and rows per range.

    Enough ranges that the query blocks times ``S`` fill one wave of
    resident blocks, never more ranges than row tiles or :data:`MAX_SPLIT`.
    """
    q_blocks = -(-Q // BLOCK_Q)
    tiles = -(-N // BLOCK_N)
    s = max(1, min(MAX_SPLIT, tiles,
                   (RESIDENT_BLOCKS_PER_SM * sm_count) // max(1, q_blocks)))
    span = max(1, -(-tiles // s)) * BLOCK_N
    return max(1, -(-N // span)), span


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
    S, span = split_count(
        Q, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_v, part_i = vals, ids
    if S > 1:
        part_v = torch.empty((Q, S, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((Q, S, k), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.l2_topk_f32(
            qf.data_ptr(), xf.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            Q, N, D, k, S, span, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "l2_topk")
    l2_topk.launches += 1
    return vals, ids


l2_topk.launches = 0
