"""Product quantization (Jégou et al.) — DiskANN's in-memory compressed
vectors (paper Table 3 "PQ dim.", default ``QD = max(dim/8, 48)``).

Counterpart of ``repro.core.pq``.  Traversal order in DiskANN is driven by
asymmetric-distance computation (ADC) against PQ codes held in compute-node
memory; exact distances come from the full-precision vectors inside fetched
4KB blocks (rerank).

``encode``, ``decode``, ``adc_table`` and ``adc_lookup`` are the
reference's numpy, to the bit.  :meth:`ProductQuantizer.adc_lookup_dev` is
the device form of the lookup: :func:`repro_torch.kernels.ops.adc_lookup`,
the hand-written CUDA kernel on the card (its plain version on the CPU).
Codebooks are trained with the torch :func:`~repro_torch.core.kmeans.
kmeans_batched` on the device.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.kmeans import kmeans_batched
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

KSUB = 256  # codebook entries per subquantizer (uint8 codes)


@dataclasses.dataclass
class ProductQuantizer:
    codebooks: np.ndarray     # (m, 256, dsub) f32
    dim: int                  # original dimensionality (pre-padding)

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def padded_dim(self) -> int:
        return self.m * self.dsub

    # -- encode ------------------------------------------------------------
    def _split(self, x: np.ndarray) -> np.ndarray:
        """(N, dim) -> (N, m, dsub) with zero padding to m*dsub."""
        x = np.asarray(x, dtype=np.float32)
        n = x.shape[0]
        pad = self.padded_dim - self.dim
        if pad:
            x = np.concatenate([x, np.zeros((n, pad), np.float32)], axis=1)
        return x.reshape(n, self.m, self.dsub)

    def encode(self, x: np.ndarray, chunk: int = 8192) -> np.ndarray:
        """(N, dim) -> (N, m) uint8 codes.

        The reference's arithmetic row by row; chunks are independent and
        numpy releases the GIL inside ``einsum``, so they run on a thread
        pool (the codes are the same bits as one thread gives).
        """
        xs = self._split(x)
        out = np.empty((xs.shape[0], self.m), dtype=np.uint8)
        cb = self.codebooks  # (m, 256, dsub)
        cb_norm = np.einsum("mkd,mkd->mk", cb, cb)  # (m, 256)

        def one(s: int) -> None:
            xe = xs[s:s + chunk]  # (c, m, dsub)
            # d = |x|^2 - 2 x.c + |c|^2 ; |x|^2 constant in argmin
            ip = np.einsum("cmd,mkd->cmk", xe, cb)
            d = cb_norm[None] - 2.0 * ip
            out[s:s + chunk] = np.argmin(d, axis=2).astype(np.uint8)

        starts = range(0, xs.shape[0], chunk)
        workers = max(1, min(len(starts), os.cpu_count() or 1))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(one, starts))
        return out

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """(N, m) uint8 -> (N, dim) f32 reconstruction."""
        n = codes.shape[0]
        rec = self.codebooks[np.arange(self.m)[None, :], codes.astype(np.int64)]
        return rec.reshape(n, self.padded_dim)[:, : self.dim]

    # -- ADC ---------------------------------------------------------------
    def adc_table(self, q: np.ndarray) -> np.ndarray:
        """(dim,) query -> (m, 256) table of per-subspace squared distances."""
        qs = self._split(q[None])[0]              # (m, dsub)
        diff = self.codebooks - qs[:, None, :]    # (m, 256, dsub)
        return np.einsum("mkd,mkd->mk", diff, diff).astype(np.float32)

    def adc_lookup(self, codes: np.ndarray, table: np.ndarray) -> np.ndarray:
        """codes (N, m) uint8, table (m, 256) -> (N,) approx sq distances."""
        idx = codes.astype(np.int64)
        return table[np.arange(self.m)[None, :], idx].sum(axis=1)

    def adc_lookup_dev(self, codes: torch.Tensor, table: torch.Tensor
                       ) -> torch.Tensor:
        """:meth:`adc_lookup` on tensors of one device: codes (N, m) uint8,
        table (m, 256) f32 -> (N,) f32, through ``ops.adc_lookup``."""
        return ops.adc_lookup(codes, table)


def train_pq(
    x: np.ndarray,
    m: int,
    iters: int = 10,
    sample: int = 20000,
    seed: int = 0,
    *,
    device: str | torch.device | None = None,
    init_idx=None,
) -> ProductQuantizer:
    """Train an m-subquantizer PQ on (a sample of) x.

    dim is zero-padded up to a multiple of m (DiskANN does the same).  The
    sample is the reference's numpy draw; the codebooks come from
    :func:`kmeans_batched` on ``device``, initialised from ``init_idx``
    (m, min(256, n)) when given, else from the reference's ``jax.random``
    draw for ``seed`` (recomputed in numpy), so a seed gives the
    reference's codebooks up to the f32 rounding of the Lloyd steps.
    """
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    n, dim = x.shape
    rng = np.random.default_rng(seed)
    if n > sample:
        x = x[rng.choice(n, size=sample, replace=False)]
        n = sample
    dsub = -(-dim // m)  # ceil
    pad = m * dsub - dim
    if pad:
        x = np.concatenate([x, np.zeros((n, pad), np.float32)], axis=1)
    xs = torch.from_numpy(
        np.ascontiguousarray(x.reshape(n, m, dsub).transpose(1, 0, 2))).to(dev)
    cb, _ = kmeans_batched(xs, KSUB, iters=iters, init_idx=init_idx,
                           seed=seed)
    cb = cb.cpu().numpy().astype(np.float32)
    if cb.shape[1] < KSUB:  # tiny datasets: pad codebook by repetition
        reps = -(-KSUB // cb.shape[1])
        cb = np.tile(cb, (1, reps, 1))[:, :KSUB]
    return ProductQuantizer(codebooks=cb, dim=dim)


def default_pq_dims(dim: int) -> int:
    """Paper §5.1: QD = max(dim/8, 48) (capped at dim)."""
    return int(min(dim, max(dim // 8, 48)))
