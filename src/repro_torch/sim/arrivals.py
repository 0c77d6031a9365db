"""Arrival processes: how queries reach a serving system.

The paper's harness is **closed-loop** — a fixed concurrency window drains
a query list, so offered load always equals capacity and the system never
falls behind.  Cloud services face **open-loop** traffic: queries arrive
whether or not the fleet keeps up.  This module makes the arrival process
a first-class axis:

* :class:`ClosedLoop` — the paper's §5.1 regime (all work queued at t=0,
  a window of ``concurrency`` in service) — the default everywhere, and
  the process under which the kernel refactor reproduces the pre-kernel
  reports exactly.
* :class:`Poisson` — open-loop memoryless arrivals at ``rate_qps``,
  optionally modulated (``diurnal`` / ``burst``) via thinning.
* :class:`Trace` — replay explicit (arrival time, workload index) pairs;
  :func:`zipf_trace` builds one from ``serving.workload``'s long-tailed
  repetition model.

A driver (``QueryEngine`` or ``FleetRouter``) passes itself as the sink:
``arrive(arrival_idx, workload_idx)`` is called at the kernel's current
virtual time for each arrival; the driver owns admission (window + FIFO
backlog) and completion accounting.

The port's own copy of ``repro.sim.arrivals``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.sim.kernel import Kernel

ARRIVAL_KINDS = ("closed", "poisson", "burst", "trace", "rw")


def offered_rate(n_arrivals: int, last_arrival_t: float,
                 wall_t: float) -> float:
    """Offered load in QPS: arrivals over the arrival span, falling back
    to the wall clock for instantaneous processes (closed loop arrives
    everything at t=0, where offered == achieved by construction)."""
    if last_arrival_t > 0:
        return n_arrivals / last_arrival_t
    return n_arrivals / wall_t if wall_t > 0 else 0.0


# ------------------------------------------------------------ modulation --

@dataclasses.dataclass(frozen=True)
class Modulation:
    """A time-varying rate multiplier with a known peak (for thinning)."""

    fn: Callable[[float], float]
    peak: float

    def __call__(self, t: float) -> float:
        return self.fn(t)


def diurnal(period_s: float, amplitude: float = 0.5) -> Modulation:
    """Sinusoidal day/night load: rate × (1 + amplitude·sin(2πt/T))."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    return Modulation(
        fn=lambda t: 1.0 + amplitude * math.sin(2 * math.pi * t / period_s),
        peak=1.0 + amplitude)


def burst(t0: float, t1: float, factor: float) -> Modulation:
    """Rate × ``factor`` inside [t0, t1), ×1 outside (a traffic spike)."""
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")
    peak = max(1.0, factor)
    return Modulation(fn=lambda t: factor if t0 <= t < t1 else 1.0,
                      peak=peak)


# -------------------------------------------------------------- processes --

class ArrivalProcess:
    """Base class.  ``window`` overrides the driver's admission window.

    ``start`` begins generating: ``arrive(arrival_idx, workload_idx)``
    fires at each arrival's virtual time; ``done()`` fires once no
    further arrivals will ever come (drivers use it to stop their
    monitor/controller processes).
    """

    kind = "closed"
    window: int | None = None
    #: kernel RNG stream name — tenancy renames it per tenant so N
    #: stochastic arrival processes on one kernel draw independently
    rng_stream: str = "arrivals"

    def start(self, kernel: Kernel, arrive: Callable[[int, int], None],
              n_workload: int, done: Callable[[], None] | None = None
              ) -> None:
        raise NotImplementedError


class ClosedLoop(ArrivalProcess):
    """The paper's closed loop: ``n_total`` queries queued at t=0 and
    served through a window of ``concurrency`` (driver default)."""

    kind = "closed"

    def __init__(self, concurrency: int | None = None,
                 n_total: int | None = None):
        self.window = concurrency
        self.n_total = n_total

    def start(self, kernel, arrive, n_workload, done=None):
        n = self.n_total if self.n_total is not None else n_workload
        for i in range(n):
            arrive(i, i % n_workload)
        if done is not None:
            done()


class Poisson(ArrivalProcess):
    """Open-loop Poisson arrivals at ``rate_qps`` (optionally modulated).

    Generation stops after ``n_total`` arrivals or past ``duration_s``,
    whichever comes first (at least one must be given).  Modulated rates
    use thinning: candidates at the peak rate, accepted with probability
    ``m(t)/peak`` — exact for any bounded profile.
    """

    kind = "poisson"

    def __init__(self, rate_qps: float, *, n_total: int | None = None,
                 duration_s: float | None = None,
                 modulation: Modulation | None = None,
                 kind: str | None = None):
        if rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
        if n_total is None and duration_s is None:
            raise ValueError("Poisson needs n_total and/or duration_s")
        self.rate = rate_qps
        self.n_total = n_total
        self.duration = duration_s
        self.modulation = modulation
        if kind is not None:           # e.g. "burst" from Scenario
            self.kind = kind

    def start(self, kernel, arrive, n_workload, done=None):
        rng = kernel.rng(self.rng_stream)
        mod = self.modulation
        peak_rate = self.rate * (mod.peak if mod is not None else 1.0)

        def next_time(t: float) -> float:
            while True:
                t += rng.exponential(1.0 / peak_rate)
                if mod is None:
                    return t
                if rng.uniform() * mod.peak <= max(mod(t), 0.0):
                    return t

        def fire(i: int) -> None:
            arrive(i, i % n_workload)
            schedule(i + 1, kernel.now)

        def schedule(i: int, t_prev: float) -> None:
            if self.n_total is not None and i >= self.n_total:
                if done is not None:
                    done()
                return
            t = next_time(t_prev)
            if self.duration is not None and t > self.duration:
                if done is not None:
                    done()
                return
            kernel.at(t, fire, i)

        schedule(0, 0.0)


class Trace(ArrivalProcess):
    """Replay explicit arrivals: ``times[i]`` → workload item ``qids[i]``
    (defaults to round-robin over the workload)."""

    kind = "trace"

    def __init__(self, times, qids=None):
        self.times = np.asarray(times, dtype=np.float64)
        if len(self.times) == 0:
            raise ValueError("trace must contain at least one arrival")
        if np.any(np.diff(self.times) < 0):
            raise ValueError("trace times must be non-decreasing")
        self.qids = None if qids is None else np.asarray(qids, dtype=np.int64)
        if self.qids is not None and len(self.qids) != len(self.times):
            raise ValueError(
                f"times ({len(self.times)}) and qids ({len(self.qids)}) "
                f"lengths differ")

    def start(self, kernel, arrive, n_workload, done=None):
        for i, t in enumerate(self.times):
            wi = int(self.qids[i]) % n_workload if self.qids is not None \
                else i % n_workload
            kernel.at(float(t), arrive, i, wi)
        if done is not None:
            # scheduled after the last arrival (same time, later seq)
            kernel.at(float(self.times[-1]), lambda: done())


def zipf_trace(n_workload: int, rate_qps: float, n_total: int,
               a: float = 1.2, seed: int = 0) -> Trace:
    """A production-style trace: Poisson arrival times × the long-tailed
    (Zipf-repeated) query popularity of ``serving.workload`` — hot queries
    recur, which is what makes shard caches and re-warm matter."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate_qps, size=n_total))
    ranks = rng.zipf(a, size=n_total)
    idx = np.minimum(ranks - 1, n_workload - 1)
    perm = rng.permutation(n_workload)            # random hot set
    return Trace(times, qids=perm[idx])


# --------------------------------------------------------------- scenario --

@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative scenario — what the CLIs and the tuner pass around.

    ``kind``: "closed" (paper harness), "poisson" (open loop), "burst"
    (Poisson with a mid-run spike), "trace" (Zipf-repeated replay),
    "rw" (closed-loop queries + a live insert/delete stream at
    ``write_rate_qps`` — the read-write mix ``repro.ingest`` serves).
    A zero write rate makes "rw" byte-identical to "closed".
    """

    kind: str = "closed"
    rate_qps: float = 200.0            # offered load (open-loop kinds)
    duration_s: float | None = None    # arrival horizon
    n_arrivals: int | None = None      # arrival count cap
    burst_factor: float = 4.0
    burst_start_s: float = 0.25
    burst_len_s: float = 0.25
    zipf_a: float = 1.2                # trace popularity skew
    slo_s: float = 0.05                # p99 target for goodput/autoscaling
    write_rate_qps: float = 0.0        # rw: update arrival rate
    n_updates: int | None = None       # rw: update count cap
    delete_frac: float = 0.2           # rw: delete share of updates

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"unknown scenario kind {self.kind!r}; one of "
                f"{ARRIVAL_KINDS}")
        if self.slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {self.slo_s}")
        if self.kind not in ("closed", "rw") and self.rate_qps <= 0:
            raise ValueError(f"rate_qps must be > 0, got {self.rate_qps}")
        if self.kind == "trace" and self.zipf_a <= 1.0:
            raise ValueError(
                f"zipf_a must be > 1 (numpy zipf domain), got "
                f"{self.zipf_a}")
        if self.write_rate_qps < 0:
            raise ValueError(f"write_rate_qps must be >= 0, got "
                             f"{self.write_rate_qps}")
        if not 0.0 <= self.delete_frac < 1.0:
            raise ValueError(f"delete_frac must be in [0, 1), got "
                             f"{self.delete_frac}")

    def make_arrivals(self, n_workload: int, concurrency: int,
                      seed: int = 0) -> ArrivalProcess:
        if self.kind in ("closed", "rw"):
            # n_arrivals cycles the query set (rw runs use it to keep
            # read traffic live for the whole write stream)
            return ClosedLoop(concurrency, n_total=self.n_arrivals)
        n = self.n_arrivals
        dur = self.duration_s
        if n is None and dur is None:
            dur = 1.0
        if self.kind == "poisson":
            return Poisson(self.rate_qps, n_total=n, duration_s=dur)
        if self.kind == "burst":
            return Poisson(
                self.rate_qps, n_total=n, duration_s=dur, kind="burst",
                modulation=burst(self.burst_start_s,
                                 self.burst_start_s + self.burst_len_s,
                                 self.burst_factor))
        # trace: needs a concrete arrival count
        n = n if n is not None else max(
            1, int(round(self.rate_qps * (dur if dur else 1.0))))
        return zipf_trace(n_workload, self.rate_qps, n, a=self.zipf_a,
                          seed=seed)

    def make_updates(self, data, seed: int = 0,
                     protected: frozenset | None = None):
        """The rw scenario's write stream (None for read-only kinds or a
        zero write rate — so a zero-write "rw" run schedules no update
        events and stays bit-identical to "closed")."""
        if self.kind != "rw" or self.write_rate_qps <= 0:
            return None
        from repro_torch.ingest.stream import synth_updates
        n = self.n_updates
        if n is None:
            n = max(1, int(round(self.write_rate_qps
                                 * (self.duration_s or 1.0))))
        return synth_updates(data, self.write_rate_qps, n,
                             delete_frac=self.delete_frac, seed=seed,
                             protected=protected)

    def to_dict(self) -> dict:
        d = dict(kind=self.kind, slo_s=self.slo_s)
        if self.kind not in ("closed", "rw"):
            d.update(rate_qps=self.rate_qps, duration_s=self.duration_s,
                     n_arrivals=self.n_arrivals)
        if self.kind == "burst":
            d.update(burst_factor=self.burst_factor,
                     burst_start_s=self.burst_start_s,
                     burst_len_s=self.burst_len_s)
        if self.kind == "trace":
            d.update(zipf_a=self.zipf_a)
        if self.kind == "rw":
            d.update(write_rate_qps=self.write_rate_qps,
                     n_updates=self.n_updates,
                     delete_frac=self.delete_frac)
        return d
