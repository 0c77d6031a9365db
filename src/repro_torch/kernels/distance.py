"""CUDA kernel: tiled squared-L2 distance matrix (``csrc/l2_distance.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/distance.py::l2_distance``.
Bound on the H100 by FP32 operations at the main path's probe shape (512 x
~214k x 96: 0.31 ms of FMA at 67 TFLOP/s against 0.13 ms to write the
output); the source's header says how the design meets that.  float32,
bfloat16 (widened to f32 on load, f32 accumulation) and int8 (exact int32
accumulation); float results are clamped at 0.  The wrapper takes CUDA
tensors only: :mod:`repro_torch.kernels.ops` sends CPU tensors to
:func:`repro_torch.kernels.ref.l2_distance_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ENTRY = {torch.float32: "l2_distance_f32",
          torch.bfloat16: "l2_distance_bf16",
          torch.int8: "l2_distance_i8"}
_MAX_Q = 65535 * 64           # grid.y limit x query rows per block


def _fn(dtype: torch.dtype):
    lib = _build.load("l2_distance")
    fn = getattr(lib, _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def l2_distance(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared-L2 matrix (Q, N) float32 of q (Q, D) and x (N, D) on the card."""
    if q.device.type != "cuda" or x.device != q.device:
        raise ValueError(f"l2_distance kernel needs both operands on one CUDA "
                         f"device, got {q.device} and {x.device}")
    if q.dtype != x.dtype or q.dtype not in _ENTRY:
        raise TypeError(f"l2_distance takes float32, bfloat16 or int8 "
                        f"operands of one dtype, got {q.dtype} and {x.dtype}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} and {tuple(x.shape)} are "
                         f"not (Q, D) and (N, D)")
    Q, D = q.shape
    N = x.shape[0]
    if Q > _MAX_Q:
        raise ValueError(f"Q={Q} exceeds the kernel's grid ({_MAX_Q})")
    q, x = q.contiguous(), x.contiguous()
    out = torch.empty((Q, N), dtype=torch.float32, device=q.device)
    if Q == 0 or N == 0:
        return out
    lib, fn = _fn(q.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), x.data_ptr(), out.data_ptr(), Q, N, D,
                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "l2_distance")
    l2_distance.launches += 1
    return out


l2_distance.launches = 0
