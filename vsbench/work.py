"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes that the search's work needs, counted from the shapes
and the lists it probes, whatever kernels carry it out.

Peaks are NVIDIA's data-sheet figures for the SXM H100 (dense, no sparsity)
at its 700 W power limit; a run prints the card's own limit beside each
share.  The benchmark keeps its own copy, so that no change to the port can
move the yardstick.
"""
from __future__ import annotations

import numpy as np

# card name (a substring of torch.cuda.get_device_name()) ->
# (FP32 FLOP/s outside the tensor cores, HBM bytes/s)
PEAKS = {"H100 80GB HBM3": (67e12, 3.35e12)}

F32 = 4        # bytes of a float32 element
ID = 4         # bytes of an int32 list entry id


def card_peaks(name: str) -> tuple[float, float]:
    """``(FLOP/s, bytes/s)`` of the card called ``name``."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no data-sheet peak for the card {name!r}")


def least_s(flop: float, nbytes: float, peaks: tuple[float, float]) -> float:
    """The least time the work can take: operations at the FLOP peak or
    bytes at the memory peak, whichever is longer."""
    return max(flop / peaks[0], nbytes / peaks[1])


def l2_distance_work(q: int, n: int, d: int) -> tuple[int, int]:
    """``(FLOP, bytes)`` of a squared-L2 matrix of q x n rows of width d:
    the products (2qnd), the norms (2(q+n)d) and |q|^2 + |x|^2 - 2 q.x
    (3qn); every input read once and the (q, n) float32 output written
    once."""
    flop = 2 * q * n * d + 2 * (q + n) * d + 3 * q * n
    nbytes = F32 * (q + n) * d + F32 * q * n
    return flop, nbytes


def search_batch_work(probe: np.ndarray, list_len: np.ndarray, n_lists: int,
                      d: int, k: int) -> tuple[int, int]:
    """``(FLOP, bytes)`` one batch of a cluster-index search needs.

    ``probe`` (B, nprobe) holds the lists each query probes and
    ``list_len`` the unpadded length of every list.  FLOP: the probe's
    products against every centroid (2·B·L·D) and the scan's against every
    probed entry (2·D·Σ lengths).  Bytes: the centroids and the queries
    read once, the rows and ids of the union of the probed lists read once,
    and the (B, k) ids and distances written once.  Padding is not work.
    """
    b = probe.shape[0]
    scanned = int(list_len[probe].sum())
    union = int(list_len[np.unique(probe)].sum())
    flop = 2 * b * n_lists * d + 2 * d * scanned
    nbytes = (F32 * (n_lists + b) * d + union * (F32 * d + ID)
              + b * k * (ID + F32))
    return flop, nbytes
