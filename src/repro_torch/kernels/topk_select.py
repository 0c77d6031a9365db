"""CUDA kernel: stable top-k selection along the last axis (``csrc/topk_select.cu``).

Replaces no TPU kernel (the reference's top-k is ``jax.lax.top_k``, which XLA
compiles).  On the card it takes the place of
:func:`repro_torch.kernels.ref.stable_topk_smallest`'s full stable sort and
returns the same, bit for bit: the ``k`` smallest values of a float32 tensor
along its last axis, ascending, with their int64 indices, lower index first
on ties; ``-0.0`` ties ``+0.0`` and a NaN sits by its bits (above ``+inf``,
or below ``-inf`` with the sign bit set), as the stable sort orders them on
the card.  Bound by reading the matrix once (the probe's
500 x ~19.7k is 39.4 MB, ~12 us at 3.35 TB/s); the source's header says how
the design meets that.

:func:`plan` sets the launch from ``N`` and ``k`` alone: one block a row of
about :data:`ROW_ELEMS` elements a thread (at least ``k`` threads), the radix
digit's width and the candidate buffer.  The wrapper takes CUDA tensors only:
:mod:`repro_torch.kernels.ops` sends CPU tensors to the plain version.  One
call of :func:`topk_smallest` is one launch in
:attr:`topk_smallest.launches`.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

# The plan's limits.  The kernel takes any plan within CUDA's threads a
# block and its shared memory; these are the wrapper's choices.
K_MAX = 1024           # the largest k: the candidates' ranking is quadratic
MAX_THREADS = 1024     # CUDA's most threads a block
MAX_DIGIT_BITS = 11    # two histogram bins a thread at 1024 threads
CAP_SLACK = 64         # the candidate buffer holds 2k + CAP_SLACK
ROW_ELEMS = 8          # elements a thread the plan aims at


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's launch: ``threads`` a block (one block a row), the radix
    digit's ``digit_bits`` and the candidate buffer ``cap``."""
    threads: int
    digit_bits: int
    cap: int


def plan(N: int, k: int) -> Plan:
    """The launch for rows of ``N`` columns and a top-``k``: a power of two
    of threads from 32 to :data:`MAX_THREADS`, a digit of one bit more than
    the threads' (two bins a thread, at most :data:`MAX_DIGIT_BITS`), and a
    buffer of ``2k +`` :data:`CAP_SLACK` candidates (at most ``N``)."""
    want = max(-(-N // ROW_ELEMS), k)
    threads = min(MAX_THREADS, max(32, 1 << (want - 1).bit_length()))
    return Plan(threads, min(MAX_DIGIT_BITS, threads.bit_length()),
                min(N, 2 * k + CAP_SLACK))


def _lib() -> ctypes.CDLL:
    lib = _build.load("topk_select")
    if lib.topk_select_f32.argtypes is None:
        lib.topk_select_max_staged.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.topk_select_max_staged.restype = ctypes.c_int
        lib.topk_select_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.topk_select_f32.restype = ctypes.c_int
    return lib


def max_staged(N: int, k: int, device: int) -> int:
    """The longest row whose keys stay in shared memory at the plan of
    ``(N, k)`` on CUDA ``device`` (the current device); longer rows are read
    from memory by every pass."""
    p = plan(N, k)
    lib = _lib()
    out = ctypes.c_longlong()
    _build.check(lib, lib.topk_select_max_staged(p.digit_bits, p.cap, device, out),
                 "topk_select shared memory")
    return out.value


def check(d: torch.Tensor, k: int) -> None:
    """Raise on what the kernel does not take: a CUDA float32 tensor of at
    least one axis, and ``1 <= k <= min(N, K_MAX)`` along the last."""
    if d.device.type != "cuda":
        raise ValueError(f"topk_select kernel needs a CUDA tensor, got {d.device}")
    if d.dtype != torch.float32:
        raise TypeError(f"topk_select takes float32, got {d.dtype}")
    if d.dim() < 1:
        raise ValueError("topk_select needs at least one axis")
    N = d.shape[-1]
    if not 1 <= k <= min(N, K_MAX):
        raise ValueError(f"topk_select takes 1 <= k <= min(N, {K_MAX}), "
                         f"got k={k}, N={N}")


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values f32 (..., k), indices int64 (..., k))`` of the ``k``
    smallest along the last axis of ``d``, ascending, lower index first on
    ties; leading axes are flattened for the launch and restored.

    The search calls it three times a batch, so its host path is lean: the
    plan is cached by ``(N, k)`` and the stream is read raw."""
    check(d, k)
    N = d.shape[-1]
    x = (d if d.dim() == 2 else d.reshape(-1, N)).contiguous()  # held until queued
    R = x.shape[0]
    dev = d.device
    vals = torch.empty((R, k), dtype=torch.float32, device=dev)
    idx = torch.empty((R, k), dtype=torch.int64, device=dev)
    if R:
        p = _PLANS.get((N, k))
        if p is None:
            p = _PLANS[N, k] = plan(N, k)
        lib = _lib()
        if dev.index == torch.cuda.current_device():
            err = _launch(lib, x, vals, idx, R, N, k, p, dev.index)
        else:
            with torch.cuda.device(dev):
                err = _launch(lib, x, vals, idx, R, N, k, p, dev.index)
        _build.check(lib, err, "topk_select")
        topk_smallest.launches += 1
    if d.dim() != 2:
        return vals.reshape(*d.shape[:-1], k), idx.reshape(*d.shape[:-1], k)
    return vals, idx


def _launch(lib, x, vals, idx, R, N, k, p, device) -> int:
    return lib.topk_select_f32(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), R, N, k,
                               p.threads, p.digit_bits, p.cap, device,
                               torch._C._cuda_getCurrentRawStream(device))


_PLANS: dict[tuple[int, int], Plan] = {}
topk_smallest.launches = 0
