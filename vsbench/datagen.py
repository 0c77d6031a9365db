"""The benchmark's data: a configuration's dataset, made from a run's seed.

A configuration file names its generator and its parameters.  The one
generator here, ``blobs``, is the model of ann-benchmarks' ``random-*``
datasets (``ann_benchmarks/datasets.py::random_float``): scikit-learn's
``make_blobs`` with its defaults (``centers`` centres drawn uniformly from
the box ``center_box`` in every dimension, an equal share of the
``n_samples`` points about each, isotropic Gaussian spread
``cluster_std``), shuffled, with ``n_queries`` points held out as the
queries.  The draws are numpy's from ``--seed``, so the same seed gives
the same data and queries on any machine; every seed gives the same sizes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

GENERATORS = ("blobs",)


@dataclasses.dataclass(frozen=True)
class Blobs:
    n_samples: int           # points drawn, queries included
    dim: int
    centers: int
    cluster_std: float
    center_box: tuple[float, float]
    n_queries: int           # held out of the n_samples as the queries
    dtype: str               # the type the index serves: "float32"

    @property
    def n(self) -> int:
        """Points in the index."""
        return self.n_samples - self.n_queries


def spec_from_config(cfg: dict) -> Blobs:
    """The dataset a configuration file states; raises on one it cannot
    make."""
    if cfg.get("generator") not in GENERATORS:
        raise ValueError(f"generator {cfg.get('generator')!r} is not one of "
                         f"{GENERATORS}")
    spec = Blobs(cfg["n_samples"], cfg["dim"], cfg["centers"],
                 float(cfg["cluster_std"]),
                 (float(cfg["center_box"][0]), float(cfg["center_box"][1])),
                 cfg["n_queries"], cfg["dtype"])
    if spec.dtype != "float32":
        raise ValueError(f"dtype {spec.dtype!r}: only float32 is made")
    if not 0 < spec.n_queries < spec.n_samples or spec.centers < 1:
        raise ValueError(f"no dataset of {spec}")
    return spec


def make(spec: Blobs, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``(data (n, dim), queries (n_queries, dim))`` float32 from ``seed``
    (any whole number >= 0)."""
    rng = np.random.default_rng(seed)
    lo, hi = spec.center_box
    centres = rng.uniform(lo, hi, size=(spec.centers, spec.dim))
    per = np.full(spec.centers, spec.n_samples // spec.centers)
    per[:spec.n_samples % spec.centers] += 1
    label = np.repeat(np.arange(spec.centers), per)
    x = rng.standard_normal((spec.n_samples, spec.dim))
    x *= spec.cluster_std
    x += centres[label]
    x = x[rng.permutation(spec.n_samples)].astype(np.float32)
    return x[spec.n_queries:], x[:spec.n_queries]
