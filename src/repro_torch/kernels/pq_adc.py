"""CUDA kernel: PQ asymmetric-distance lookup (``csrc/pq_adc.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/pq_adc.py::adc_lookup``:
``out[n] = sum_j table[j, codes[n, j]]``.  The TPU kernel is a one-hot x
LUT product because the TPU has no fast gather; on Hopper each thread sums
one code row's lookups, in f32, in order j = 0 .. m-1, from a table staged
in shared memory (above :data:`SMALL_N` rows) or read straight from global
memory through the read-only cache (a graph search round's ~140 rows, where
staging 48 KB on one SM costs more than the lookups).  Both paths give the
same bits.  Bound by bytes (m code bytes in, 4 bytes out per row); at a
graph search round's ~100 rows the launch and this wrapper are the cost, so
a call does no more than its checks, one allocation and one ``ctypes``
call (the kernel library caches its launch attributes per device).

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
#: Largest N on the direct path (no staged table).  Set from the device
#: times of both paths on an H100 at m = 48 (chip_smoke.py's adc sweep):
#: direct was faster up to 4,096 rows and slower at 16,384.
SMALL_N = 4096
PATHS = ("staged", "direct")

_LIB: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("pq_adc")
        lib.adc_lookup_u8.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_longlong] + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
        lib.adc_lookup_u8.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def adc_lookup(codes: torch.Tensor, table: torch.Tensor, *,
               path: str | None = None) -> torch.Tensor:
    """ADC distances (N,) float32 of codes (N, m) and table (m, 256) on the
    card; ``path`` forces one of :data:`PATHS` (by default, direct when
    ``N <= SMALL_N``)."""
    dev = codes.device
    if not codes.is_cuda or table.device != dev:
        raise ValueError(f"adc_lookup kernel needs codes and table on one CUDA "
                         f"device, got {dev} and {table.device}")
    if codes.dtype is not torch.uint8 and codes.dtype is not torch.int32:
        raise TypeError(f"adc_lookup takes uint8 or int32 codes, got {codes.dtype}")
    if not table.dtype.is_floating_point:
        raise TypeError(f"adc_lookup takes a float table, got {table.dtype}")
    shape = codes.shape
    if len(shape) != 2 or table.shape != (shape[1], KSUB):
        raise ValueError(f"shapes {tuple(shape)} and {tuple(table.shape)} "
                         f"are not (N, m) and (m, {KSUB})")
    N, m = shape
    if path is None:
        direct = N <= SMALL_N
    elif path in PATHS:
        direct = path == "direct"
    else:
        raise ValueError(f"adc_lookup path is one of {PATHS}, got {path!r}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"adc_lookup kernel takes 1 <= m <= {MAX_M}, got {m}")
    if codes.dtype is not torch.uint8:
        codes = codes.to(torch.uint8)
    if not codes.is_contiguous():
        codes = codes.contiguous()
    if table.dtype is not torch.float32:
        table = table.to(torch.float32)
    if not table.is_contiguous():
        table = table.contiguous()
    out = table.new_empty((N,))
    if N == 0:
        return out
    lib = _LIB or _lib()
    idx = dev.index
    # the raw handle of the current stream, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        err = lib.adc_lookup_u8(codes.data_ptr(), table.data_ptr(),
                                out.data_ptr(), N, m, direct, idx, stream)
    else:
        with torch.cuda.device(dev):
            err = lib.adc_lookup_u8(codes.data_ptr(), table.data_ptr(),
                                    out.data_ptr(), N, m, direct, idx, stream)
    if err:
        _build.check(lib, err, "adc_lookup")
    adc_lookup.launches += 1
    return out


adc_lookup.launches = 0
