"""Measured compute pricing: the :class:`CalibrationTable`.

The port's own copy of ``repro.exec.table``.  The analytic cost model
prices shard compute from two hand-set constants — ``dist_flops_per_s``
and ``adc_lookup_s``.  The calibration table replaces those constants with
*measurements*: :mod:`repro_torch.exec.calibrate` times the port's kernels
on the card over a grid of ``(dim, pq_m, batch size, dtype)`` points and
persists one ``unit_s`` — seconds per distance computation (dist ops) or
seconds per table lookup (ADC ops) — per grid point.

Lookups mirror the analytic formula exactly, so a table is a drop-in
pricing source::

    seconds = d_dist * unit_s_dist(dim, batch)
            + d_pq * max(pq_m, 1) * unit_s_adc(pq_m, batch)

The batch axis is what a coalescer buys: larger batches amortize launch
overhead and fill the card, so ``unit_s`` falls with batch size and the
table interpolates (linearly in log batch size, clamped at the measured
ends) between grid points.

Measurements vary per card, so a table measured once on an H100 with the
calibrate CLI is committed as ``calibration_default.json`` (its ``meta``
names the card and its power limit as ``nvidia-smi`` gives them) and
loaded by default — simulations stay deterministic across machines while
still being priced from the card's kernel timings.  The reference's own
default was timed with the Pallas interpreter on a CPU and prices nothing
on a card, so the port does not use it.  Re-measure on the card with::

    python -m repro_torch.exec.calibrate --out calibration.json
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

__all__ = ["CalibEntry", "CalibrationTable", "CALIBRATE_COMMAND",
           "DEFAULT_TABLE_PATH", "load_table"]

#: The committed table, measured once on the card (see module docstring).
DEFAULT_TABLE_PATH = os.path.join(os.path.dirname(__file__),
                                  "calibration_default.json")
CALIBRATE_COMMAND = "python -m repro_torch.exec.calibrate --out calibration.json"


@dataclasses.dataclass(frozen=True)
class CalibEntry:
    """One measured grid point.

    ``op`` is ``"dist"`` (batched L2 distance + fused top-k; ``dim`` set,
    ``pq_m`` 0) or ``"adc"`` (PQ table lookup; ``pq_m`` set, ``dim`` 0).
    ``batch`` is the batch-size axis the coalescer moves along: total
    query·candidate pairs for dist, total codes scanned for adc.
    ``unit_s`` is seconds per distance computation / per single lookup.
    """

    op: str
    dim: int
    pq_m: int
    batch: int
    dtype: str
    unit_s: float
    us_per_call: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _interp_log(points: list[tuple[int, float]], batch: float) -> float:
    """Piecewise-linear interpolation of unit_s over log(batch), clamped
    at the measured ends.  ``points`` is sorted by batch ascending."""
    if batch <= points[0][0]:
        return points[0][1]
    if batch >= points[-1][0]:
        return points[-1][1]
    for (b0, u0), (b1, u1) in zip(points, points[1:]):
        if b0 <= batch <= b1:
            if b1 == b0:
                return u0
            f = (math.log(batch) - math.log(b0)) / \
                (math.log(b1) - math.log(b0))
            return u0 + f * (u1 - u0)
    return points[-1][1]                       # pragma: no cover


class CalibrationTable:
    """Measured ``unit_s`` grid with nearest-bucket + log-interp lookup."""

    def __init__(self, entries: list[CalibEntry], meta: dict | None = None):
        if not any(e.op == "dist" for e in entries):
            raise ValueError("calibration table has no 'dist' entries")
        self.entries = list(entries)
        self.meta = dict(meta or {})
        # op -> key (dim or pq_m) -> [(batch, unit_s)] sorted by batch
        self._grid: dict[str, dict[int, list[tuple[int, float]]]] = {}
        for e in self.entries:
            key = e.dim if e.op == "dist" else e.pq_m
            self._grid.setdefault(e.op, {}).setdefault(key, []).append(
                (e.batch, e.unit_s))
        for buckets in self._grid.values():
            for pts in buckets.values():
                pts.sort()

    # -- lookups ------------------------------------------------------

    def _nearest(self, op: str, key: int) -> list[tuple[int, float]]:
        buckets = self._grid.get(op)
        if not buckets:
            raise KeyError(f"no '{op}' entries in calibration table")
        if key in buckets:
            return buckets[key]
        # nearest bucket by log distance (dims/pq_m are geometric-ish)
        best = min(buckets, key=lambda k: (abs(math.log(max(key, 1))
                                               - math.log(max(k, 1))), k))
        return buckets[best]

    def dist_unit_s(self, dim: int, batch: float = 1.0) -> float:
        """Seconds per query·candidate distance computation."""
        return _interp_log(self._nearest("dist", dim), max(batch, 1.0))

    def adc_unit_s(self, pq_m: int, batch: float = 1.0) -> float:
        """Seconds per single ADC table lookup."""
        if "adc" not in self._grid:
            return 0.0
        return _interp_log(self._nearest("adc", pq_m), max(batch, 1.0))

    def plan_seconds(self, d_dist: int, d_pq: int, dim: int, pq_m: int,
                     *, dist_batch: float | None = None,
                     adc_batch: float | None = None) -> float:
        """Calibrated mirror of the analytic model's
        ``plan_compute_seconds``.

        ``dist_batch`` / ``adc_batch`` let the coalescer price one job's
        work at the *batch's* aggregate operating point (defaults: the
        job's own work — a batch of one).
        """
        s = 0.0
        if d_dist:
            s += d_dist * self.dist_unit_s(
                dim, d_dist if dist_batch is None else dist_batch)
        if d_pq:
            lookups = d_pq * max(pq_m, 1)
            s += lookups * self.adc_unit_s(
                pq_m, lookups if adc_batch is None else adc_batch)
        return s

    def dist_flops_per_s(self, dim: int, batch: float = 1.0) -> float:
        """Equivalent of the analytic ``dist_flops_per_s`` constant at
        one operating point (2·dim FLOPs per distance computation)."""
        return 2.0 * dim / self.dist_unit_s(dim, batch)

    # -- persistence --------------------------------------------------

    def to_dict(self) -> dict:
        return dict(version=1, meta=self.meta,
                    entries=[e.to_dict() for e in self.entries])

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationTable":
        entries = [CalibEntry(**row) for row in d["entries"]]
        return cls(entries, meta=d.get("meta"))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def describe(self) -> dict:
        """Small summary block for bench/report meta."""
        dims = sorted({e.dim for e in self.entries if e.op == "dist"})
        pq_ms = sorted({e.pq_m for e in self.entries if e.op == "adc"})
        return dict(backend=self.meta.get("backend", "?"),
                    n_entries=len(self.entries), dims=dims, pq_ms=pq_ms)


def load_table(path: str | None = None) -> CalibrationTable:
    """Load a calibration table; ``None`` means the committed default,
    measured on the card by ``CALIBRATE_COMMAND``."""
    return CalibrationTable.load(path or DEFAULT_TABLE_PATH)
