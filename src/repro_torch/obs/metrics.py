"""Lightweight metrics registry: counters, gauges, log-bucketed histograms.

The serving layers publish into a :class:`MetricsRegistry` (owned by the
run's :class:`~repro_torch.obs.trace.Tracer`) instead of growing ad-hoc lists.
All three instrument types use fixed memory regardless of sample count,
so a 10M-query replay costs the same as a smoke run.  A periodic
snapshot (driven by the fleet router's ticker when tracing is enabled)
turns the registry into a time series that the Chrome-trace export
renders as counter tracks.

Everything here is observational: instruments never touch the kernel,
so publishing is safe from any event callback.

The port's own copy of ``repro.obs.metrics``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import math

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonically increasing count (events, bytes, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """Last-write-wins instantaneous value (queue depth, instances)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Log-bucketed histogram with fixed memory.

    Buckets are half-open decades split into ``buckets_per_decade``
    geometric sub-buckets covering [``lo``, ``hi``); samples outside the
    range clamp into the first/last bucket.  Quantiles interpolate
    within the winning bucket, which is plenty for attribution-grade
    summaries.

    Error bound (tested by ``test_histogram_quantile_exactness``): for
    in-range samples, the estimate and the true (inverted-CDF) sample
    quantile land in the *same* bucket, so the ratio estimate/true lies
    in ``[1/base, base]`` with ``base = 10**(1/buckets_per_decade)`` —
    a worst-case relative error of ``base - 1`` (~33% at the default 8
    buckets/decade — an earlier doc claimed ~12%, which the bound does
    not support; that would need ~20 buckets/decade).  The final clamp
    to [``min``, ``max``] makes q=0/q=1 exact for in-range samples and
    keeps every estimate inside the observed value range even when
    samples clamped into the edge buckets distort their bucket's edges.
    """

    __slots__ = ("name", "lo", "hi", "_base", "_n_buckets", "counts",
                 "count", "total", "min", "max")

    def __init__(self, name: str, lo: float = 1e-6, hi: float = 1e4,
                 buckets_per_decade: int = 8):
        self.name = name
        self.lo = lo
        self.hi = hi
        self._base = 10.0 ** (1.0 / buckets_per_decade)
        self._n_buckets = int(math.ceil(
            math.log(hi / lo) / math.log(self._base))) + 1
        self.counts = [0] * self._n_buckets
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket(self, x: float) -> int:
        if x <= self.lo:
            return 0
        i = int(math.log(x / self.lo) / math.log(self._base))
        return min(i, self._n_buckets - 1)

    def observe(self, x: float) -> None:
        self.counts[self._bucket(x)] += 1
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile via linear interpolation in the bucket."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                frac = (target - seen) / c
                b_lo = self.lo * self._base ** i
                b_hi = b_lo * self._base
                est = b_lo + frac * (b_hi - b_lo)
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def to_dict(self) -> dict:
        return dict(count=self.count,
                    sum=round(self.total, 9),
                    mean=round(self.mean, 9),
                    min=round(self.min, 9) if self.count else 0.0,
                    max=round(self.max, 9) if self.count else 0.0,
                    p50=round(self.quantile(0.50), 9),
                    p99=round(self.quantile(0.99), 9))


class MetricsRegistry:
    """Named instruments plus periodic time-series snapshots."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        #: list of (sim time, {name: value}) rows from snapshot()
        self.series: list[tuple[float, dict[str, float]]] = []

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, **kwargs) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, **kwargs)
        return h

    def snapshot(self, t: float) -> None:
        """Append one time-series row of every counter and gauge, plus
        each histogram's running ``count``/``sum`` — with both, the delta
        between any two ticks reconstructs that window's observation
        count and mean without re-tracing (windowed means =
        Δsum / Δcount; the deltas across all ticks telescope to the
        final histogram totals)."""
        row = {c.name: c.value for c in self._counters.values()}
        row.update({g.name: g.value for g in self._gauges.values()})
        for h in self._histograms.values():
            row[f"{h.name}.count"] = float(h.count)
            row[f"{h.name}.sum"] = h.total
        self.series.append((t, row))

    def to_dict(self) -> dict:
        return dict(
            counters={k: v.value for k, v in sorted(self._counters.items())},
            gauges={k: v.value for k, v in sorted(self._gauges.items())},
            histograms={k: v.to_dict()
                        for k, v in sorted(self._histograms.items())},
        )
