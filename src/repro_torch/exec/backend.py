"""The kernel execution backend: per-shard batch coalescing with
calibrated pricing.

A :class:`KernelBackend` replaces the serving engine's per-job analytic
compute pricing.  Jobs submit their work deltas (distance comps, PQ
lookups) as they yield; the backend holds them in an *open batch* for up
to one batch window, then flushes the whole batch as a single fused
dispatch priced from a measured :class:`~repro_torch.exec.table.CalibrationTable`
at the batch's aggregate operating point.  Larger batches hit the
calibration curve where per-op cost is lower — the utilization /
latency trade the batch window knob controls.

Timing-only by construction: results still come from the unchanged plan
generators, so result IDs and recall are bit-identical to the analytic
backend (the parity contract, enforced by ``tests/test_torch_fleet.py``).  The
real padded batched execution lives in :mod:`repro_torch.exec.batched` and is
what the calibration harness times.

Determinism: the flush event is scheduled whenever the first job joins a
window (tracer or not), continuations fire in submission order, and all
pricing is plain float arithmetic off the committed table — a traced run
stays bit-exact against an untraced one.

The port's own copy of ``repro.exec.backend``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.

One difference from the reference follows from the card: the port's
``QUERY_TILE`` is 32, the narrow ``l2_topk`` tile, where the reference's
is 8.  A traced run's ``exec.*batch_occupancy`` and ``exec.*pad_waste``
gauges therefore follow the card's tile; the pricing (``dt``) does not
depend on the tile.
"""
from __future__ import annotations

from repro_torch.exec.batched import QUERY_TILE, pad_amount
from repro_torch.exec.table import CalibrationTable

__all__ = ["KernelBackend"]


class _Detached:
    """Sentinel parent forcing a root span (batch spans cover many jobs,
    so nesting them under any one job's span would break the tree
    invariant "child interval inside parent interval")."""

    sid = None


_DETACHED = _Detached()


class _Pending:
    """One job's work since its last yield, waiting in the open batch."""

    __slots__ = ("st", "t_enq", "d_dist", "d_pq", "dim", "pq_m", "cont",
                 "interval")

    def __init__(self, st, t_enq, d_dist, d_pq, cont, interval=None):
        self.st = st
        self.t_enq = t_enq
        self.d_dist = d_dist
        self.d_pq = d_pq
        self.dim = st.dim
        self.pq_m = st.pq_m
        self.cont = cont
        self.interval = interval     # mutable [enq_t, flush_t] on st.coalesce


class KernelBackend:
    """Batch coalescer + calibrated pricing for one engine (one shard
    instance).  Attach via :meth:`attach`; the engine then routes every
    compute charge through :meth:`submit` instead of the analytic model.
    """

    def __init__(self, table: CalibrationTable, window_s: float = 0.0, *,
                 shard_id: int = 0, instance: int = 0):
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        self.table = table
        self.window_s = float(window_s)
        self.shard_id = shard_id
        self.instance = instance
        self.kernel = None
        self._open: list[_Pending] = []
        self._flush_ev = None
        # aggregate stats, tracer or not (read by benches and tests)
        self.batches = 0
        self.jobs_batched = 0
        self.occupancy_sum = 0.0
        self.busy_s = 0.0

    def attach(self, engine) -> "KernelBackend":
        self.kernel = engine.kernel
        return self

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0

    # -- engine-facing -------------------------------------------------

    def submit(self, st, t: float, d_dist: int, d_pq: int, cont) -> None:
        """Price ``st``'s work since its last yield; call ``cont(t_done)``.

        Zero-work submissions (graph fetch hops do no shard arithmetic)
        continue immediately — holding them a window would buy nothing.
        Otherwise the job joins the shard's open batch; the first joiner
        arms the flush timer at ``t + window``.  ``window == 0``
        degenerates to per-job calibrated pricing (batch of one).
        """
        if d_dist == 0 and d_pq == 0:
            cont(t)
            return
        if self.window_s <= 0.0:
            self._fire([_Pending(st, t, d_dist, d_pq, cont)], t)
            return
        interval = [t, None]
        st.coalesce.append(interval)
        self._open.append(_Pending(st, t, d_dist, d_pq, cont, interval))
        if self._flush_ev is None:
            self._flush_ev = self.kernel.at(t + self.window_s, self._flush)

    def _flush(self) -> None:
        self._flush_ev = None
        batch, self._open = self._open, []
        t = self.kernel.now
        live = []
        for p in batch:
            if not p.st.alive:       # aborted while waiting; drop silently
                continue
            p.interval[1] = t
            live.append(p)
        if live:
            self._fire(live, t)

    # -- pricing -------------------------------------------------------

    def _fire(self, entries: list[_Pending], t: float) -> None:
        """Price the batch as one fused dispatch and fire continuations.

        Each job's work is charged at the *batch's* aggregate operating
        point on the calibration curve, and the dispatch runs for the
        sum — every member completes at the same ``t + dt``.
        """
        total_dd = sum(p.d_dist for p in entries)
        total_lk = sum(p.d_pq * max(p.pq_m, 1) for p in entries)
        dt = 0.0
        for p in entries:
            dt += self.table.plan_seconds(
                p.d_dist, p.d_pq, p.dim, p.pq_m,
                dist_batch=total_dd, adc_batch=total_lk)
        done_t = t + dt
        b = len(entries)
        self.batches += 1
        self.jobs_batched += b
        occ = b / (b + pad_amount(b, QUERY_TILE))
        self.occupancy_sum += occ
        self.busy_s += dt
        tr = self.kernel.tracer
        if tr.enabled:
            tr.record("batch_compute", t, done_t, parent=_DETACHED,
                      shard=self.shard_id, instance=self.instance,
                      jobs=b, occupancy=round(occ, 4),
                      dist_comps=total_dd, pq_lookups=total_lk)
            m = tr.metrics
            m.counter("exec.batches").inc()
            m.counter("exec.batched_jobs").inc(b)
            m.gauge(f"exec.shard{self.shard_id}.batch_occupancy").set(occ)
            m.gauge(f"exec.shard{self.shard_id}.pad_waste").set(1.0 - occ)
            m.histogram("exec.batch_jobs", lo=1.0, hi=1e3).observe(b)
            m.histogram("exec.batch_occupancy",
                        lo=1e-2, hi=1.0).observe(occ)
            m.histogram("exec.batch_compute_s").observe(dt)
        for p in entries:
            p.cont(done_t)
