"""Query workload generation.

The paper serves each dataset's query set sequentially from a cold cache
(§5.4); production traces additionally show *commonality and stability*
(long-tailed, stable access patterns — §4.1 [47, 62, 63, 91]), which we
model with Zipf-repeated queries for the extended cache studies.

The port's own copy of ``repro.serving.workload``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import numpy as np


def sequential(queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The paper's workload: each query once, in order."""
    return queries, np.arange(len(queries))


def zipf_repeated(queries: np.ndarray, n_total: int, a: float = 1.2,
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Long-tailed repetition: hot queries recur (agentic-AI style traces).

    Returns (workload queries, original query ids) — ids map results back
    to ground truth.
    """
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(a, size=n_total)
    idx = np.minimum(ranks - 1, len(queries) - 1)
    perm = rng.permutation(len(queries))      # random hot set
    idx = perm[idx]
    return queries[idx], idx


def perturbed_zipf(queries: np.ndarray, n_total: int, noise: float = 0.01,
                   a: float = 1.2, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Zipf repetition with small perturbations: near-duplicate queries hit
    the same index segments without being byte-identical (cache-friendly
    but not degenerate)."""
    base, idx = zipf_repeated(queries, n_total, a=a, seed=seed)
    rng = np.random.default_rng(seed + 1)
    scale = np.abs(base).mean() * noise
    out = base.astype(np.float32) + rng.normal(
        0, scale, size=base.shape).astype(np.float32)
    if queries.dtype == np.int8:
        out = np.clip(np.round(out), -127, 127).astype(np.int8)
    return out, idx
