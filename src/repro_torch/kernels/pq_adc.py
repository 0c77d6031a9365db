"""CUDA kernel: PQ asymmetric-distance lookup (``csrc/pq_adc.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/pq_adc.py::adc_lookup``:
``out[n] = sum_j table[j, codes[n, j]]``.  The TPU kernel is a one-hot x
LUT product because the TPU has no fast gather; on Hopper the table sits in
shared memory and each thread sums one code row's lookups, in f32, in order
j = 0 .. m-1.  Bound by bytes (m code bytes in, 4 bytes out per row); at a
graph search round's ~100 rows the launch is the cost.

uint8 codes are native; int32 codes (which the Pallas kernel also takes)
are narrowed to uint8 by a copy here, so their values must lie in
[0, 256).  The wrapper takes CUDA tensors only: :mod:`repro_torch.kernels.
ops` sends CPU tensors to :func:`repro_torch.kernels.ref.adc_lookup_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KSUB = 256
MAX_M = 227        # the (m, 256) f32 table must fit a block's 227 KB


def _lib() -> ctypes.CDLL:
    lib = _build.load("pq_adc")
    if lib.adc_lookup_u8.argtypes is None:
        lib.adc_lookup_u8.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p])
        lib.adc_lookup_u8.restype = ctypes.c_int
    return lib


def adc_lookup(codes: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """ADC distances (N,) float32 of codes (N, m) and table (m, 256) on the card."""
    if codes.device.type != "cuda" or table.device != codes.device:
        raise ValueError(f"adc_lookup kernel needs codes and table on one CUDA "
                         f"device, got {codes.device} and {table.device}")
    if codes.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"adc_lookup takes uint8 or int32 codes, got {codes.dtype}")
    if not table.dtype.is_floating_point:
        raise TypeError(f"adc_lookup takes a float table, got {table.dtype}")
    if codes.dim() != 2 or tuple(table.shape) != (codes.shape[1], KSUB):
        raise ValueError(f"shapes {tuple(codes.shape)} and {tuple(table.shape)} "
                         f"are not (N, m) and (m, {KSUB})")
    N, m = codes.shape
    if not 1 <= m <= MAX_M:
        raise ValueError(f"adc_lookup kernel takes 1 <= m <= {MAX_M}, got {m}")
    codes = codes.to(torch.uint8).contiguous()
    table = table.to(torch.float32).contiguous()
    out = torch.empty((N,), dtype=torch.float32, device=codes.device)
    if N == 0:
        return out
    lib = _lib()
    with torch.cuda.device(codes.device):
        err = lib.adc_lookup_u8(codes.data_ptr(), table.data_ptr(),
                                out.data_ptr(), N, m,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "adc_lookup")
    adc_lookup.launches += 1
    return out


adc_lookup.launches = 0
