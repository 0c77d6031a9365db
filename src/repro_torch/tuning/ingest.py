"""Ingest tuning: the compaction knobs as a tunable axis.

A read-write workload adds three knobs — delta capacity, flush trigger
and compaction parallelism — whose trade surface is the classic LSM
one, priced here with the repo's cloud cost vocabulary:

* **write amplification** (analytic screen term): a flush rewrites
  every sealed object its delta touches, so small deltas pay the whole
  posting list per handful of new vectors while big deltas amortise —
  but big deltas seal late (freshness) and flush in storms (p99).
* **bandwidth share**: compaction reads + writes move through the same
  NIC/IOPS budget as queries; the screen derates predicted QPS by the
  share the write rate implies and rejects points whose compaction
  cannot keep up.
* **freshness**: the expected seal lag is fill-time + flush-time — the
  analytic mirror of the measured ``seal_lag`` in
  :class:`repro_torch.ingest.metrics.IngestReport`.

``tune_ingest`` screens the grid analytically, optionally refines the
survivors on the real engine (a small rw run per point), and recommends
the freshest point within a QPS slack of the best — the same
knee-with-slack shape as the index tuner.

The port's own copy of ``repro.tuning.ingest``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code apart from its ``device`` lines. The measured points' index builds run
where ``device`` says (default: the card).
"""
from __future__ import annotations

import dataclasses

from repro_torch.ingest.compaction import IngestConfig
from repro_torch.ingest.memtable import ID_BYTES
from repro_torch.tuning import screen as scr
from repro_torch.tuning.space import Candidate, EnvSpec, WorkloadSpec

DELTA_CAP_GRID = (64 * 1024, 256 * 1024, 1024 * 1024)
FLUSH_FRAC_GRID = (0.3, 0.6, 0.9)
PARALLELISM_GRID = (1, 2)

#: fraction of the NIC compaction may consume before a point is ruled
#: infeasible (beyond this the delta grows without bound)
MAX_BANDWIDTH_SHARE = 0.5
#: QPS slack for the freshest-within-slack recommendation
QPS_SLACK = 0.05
#: fitted back-edge rewrite factor: a stitched insert rewrites about
#: ``0.4 R`` neighbour blocks (measured on the repo's graph flushes)
GRAPH_BACKEDGE_BETA = 0.4


@dataclasses.dataclass(frozen=True)
class IngestPoint:
    """One point of the compaction-knob grid."""

    delta_cap_bytes: int
    flush_frac: float = 0.5
    compaction_parallelism: int = 1

    def to_config(self, **overrides) -> IngestConfig:
        return IngestConfig(delta_cap_bytes=self.delta_cap_bytes,
                            flush_frac=self.flush_frac,
                            compaction_parallelism=(
                                self.compaction_parallelism),
                            **overrides)

    def to_dict(self) -> dict:
        return dict(delta_cap_bytes=self.delta_cap_bytes,
                    flush_frac=self.flush_frac,
                    compaction_parallelism=self.compaction_parallelism)


def enumerate_ingest_space() -> list[IngestPoint]:
    return [IngestPoint(cap, ff, par)
            for cap in DELTA_CAP_GRID
            for ff in FLUSH_FRAC_GRID
            for par in PARALLELISM_GRID]


# ------------------------------------------------------------ analytics --

def entry_nbytes(w: WorkloadSpec) -> int:
    return w.vector_bytes + ID_BYTES


def flush_batch_entries(w: WorkloadSpec, point: IngestPoint) -> float:
    """Delta entries per flush at the trigger point."""
    return max(1.0, point.flush_frac * point.delta_cap_bytes
               / entry_nbytes(w))


def analytic_write_amplification(w: WorkloadSpec, c: Candidate,
                                 point: IngestPoint) -> float:
    """Expected compaction bytes written per payload byte ingested.

    Cluster: a flush of ``E`` entries (each closure-replicated into
    ``rep_eff`` lists) rewrites the distinct lists it touches — the
    coupon-collector expectation ``L (1 − (1 − 1/L)^{E·rep})`` — at
    ``avg_list_bytes`` each.  Graph: every stitched insert writes its
    own block plus ~``0.4 R`` back-edge neighbour rewrites, with a mild
    dedup discount for bigger flush batches (shared targets)."""
    E = flush_batch_entries(w, point)
    eb = entry_nbytes(w)
    if c.kind == "cluster":
        n_lists, _, list_bytes = scr.cluster_stats(w, c)
        rep_eff = 1.0 + scr.REPLICATION_PER_REPLICA * c.num_replica
        touched = n_lists * (1.0 - (1.0 - 1.0 / n_lists)
                             ** (E * rep_eff))
        written = touched * (list_bytes + eb) + E * eb
        return written / (E * eb)
    node_b = scr.graph_node_bytes(w, c)
    blocks_per_insert = (1.0 + GRAPH_BACKEDGE_BETA * c.R) \
        * max(0.5, 1.0 - 0.04 * (E ** 0.5))
    return blocks_per_insert * node_b / eb


def compaction_bandwidth_share(w: WorkloadSpec, env: EnvSpec,
                               c: Candidate, point: IngestPoint) -> float:
    """Fraction of the storage NIC the steady-state write rate claims
    (reads before rewrite ≈ writes, hence the factor 2)."""
    if w.write_rate_qps <= 0:
        return 0.0
    wa = analytic_write_amplification(w, c, point)
    byte_rate = 2.0 * wa * w.write_rate_qps * entry_nbytes(w)
    return min(1.0, byte_rate / env.storage.bandwidth_Bps)


def analytic_seal_lag(w: WorkloadSpec, env: EnvSpec, c: Candidate,
                      point: IngestPoint) -> float:
    """Expected seal lag ≈ time to fill the delta to the trigger plus
    the flush's own I/O time."""
    if w.write_rate_qps <= 0:
        return 0.0
    E = flush_batch_entries(w, point)
    fill_s = E / w.write_rate_qps
    wa = analytic_write_amplification(w, c, point)
    flush_bytes = 2.0 * wa * E * entry_nbytes(w)
    flush_s = flush_bytes / env.storage.bandwidth_Bps \
        / max(1, point.compaction_parallelism)
    return fill_s / 2.0 + flush_s


@dataclasses.dataclass(frozen=True)
class IngestPrediction:
    point: IngestPoint
    write_amplification: float
    bandwidth_share: float
    pred_qps: float                 # derated by the compaction share
    pred_seal_lag_s: float
    feasible: bool

    def to_dict(self) -> dict:
        return dict(point=self.point.to_dict(),
                    write_amplification=round(self.write_amplification, 3),
                    bandwidth_share=round(self.bandwidth_share, 4),
                    pred_qps=round(self.pred_qps, 2),
                    pred_seal_lag_s=round(self.pred_seal_lag_s, 6),
                    feasible=self.feasible)


def screen_ingest(w: WorkloadSpec, env: EnvSpec, c: Candidate,
                  points: list[IngestPoint] | None = None
                  ) -> list[IngestPrediction]:
    """Analytic pass: derate the candidate's predicted QPS by each
    point's compaction bandwidth share; points whose compaction would
    saturate the NIC are infeasible.  Sorted best-QPS-first."""
    points = points if points is not None else enumerate_ingest_space()
    base = scr.predict(w, env, c)
    preds = []
    for point in points:
        wa = analytic_write_amplification(w, c, point)
        share = compaction_bandwidth_share(w, env, c, point)
        preds.append(IngestPrediction(
            point=point, write_amplification=wa, bandwidth_share=share,
            pred_qps=base.pred_qps * (1.0 - share),
            pred_seal_lag_s=analytic_seal_lag(w, env, c, point),
            feasible=share < MAX_BANDWIDTH_SHARE))
    preds.sort(key=lambda p: (-p.feasible, -p.pred_qps))
    return preds


# ------------------------------------------------------------ refine -----

@dataclasses.dataclass
class IngestOutcome:
    pred: IngestPrediction
    measured_wa: float
    measured_seal_p99_s: float
    measured_p99_s: float           # query p99 during the rw run
    measured_qps: float

    def to_dict(self) -> dict:
        d = self.pred.to_dict()
        d.update(measured_write_amplification=round(self.measured_wa, 3),
                 measured_seal_p99_s=round(self.measured_seal_p99_s, 6),
                 measured_query_p99_s=round(self.measured_p99_s, 6),
                 measured_qps=round(self.measured_qps, 2))
        return d


def evaluate_ingest_point(w: WorkloadSpec, env: EnvSpec,
                          pred: IngestPrediction, *, eval_n: int = 1200,
                          nq: int = 32, seed: int = 0,
                          device=None) -> IngestOutcome:
    """Measure one knob point on the real engine: a small closed-loop
    query stream with a live update stream and this point's compaction
    config."""
    import numpy as np

    from repro_torch.core.cluster_index import ClusterIndex
    from repro_torch.core.types import ClusterIndexParams, SearchParams
    from repro_torch.data.synth import DatasetSpec, make_dataset
    from repro_torch.ingest import make_mutable, synth_updates
    from repro_torch.serving.engine import run_workload

    c = Candidate(kind="cluster")  # the rw eval rides the cluster engine
    spec = DatasetSpec("ingest-analog", w.dim, w.dtype, eval_n, nq,
                       n_clusters=max(8, min(64, eval_n // 16)),
                       intrinsic_dim=min(32, w.dim), seed=seed)
    data, queries = make_dataset(spec)
    index = make_mutable(ClusterIndex.build(
        data, ClusterIndexParams(kmeans_iters=4, seed=seed),
        device=device))
    # scale the write rate to eval scale: keep the write:read byte ratio
    stream = synth_updates(
        data, rate_qps=max(w.write_rate_qps, 1.0),
        n_updates=max(8, int(w.write_rate_qps)), seed=seed)
    # scale the delta cap by the eval-to-full index ratio so flush
    # cadence (flushes per update) is preserved
    full_bytes = scr.index_bytes(w, c)
    ratio = index.meta.index_bytes / max(full_bytes, 1.0)
    cap = max(4 * index.entry_nbytes,
              int(pred.point.delta_cap_bytes * ratio))
    cfg = pred.point.to_config()
    cfg = dataclasses.replace(cfg, delta_cap_bytes=cap)
    rep = run_workload(index, np.concatenate([queries, queries]),
                       SearchParams(k=w.k, nprobe=16), env.storage,
                       concurrency=max(1, w.concurrency), seed=seed,
                       updates=stream, ingest=cfg)
    ing = rep.ingest
    return IngestOutcome(
        pred=pred, measured_wa=ing["write_amplification"],
        measured_seal_p99_s=ing["seal_lag"]["p99_s"],
        measured_p99_s=rep.latency_percentile(99),
        measured_qps=rep.qps)


# --------------------------------------------------------- recommend -----

@dataclasses.dataclass
class IngestRecommendation:
    point: IngestPoint
    screened: list[IngestPrediction]
    outcomes: list[IngestOutcome]
    reason: str

    def to_dict(self) -> dict:
        return dict(point=self.point.to_dict(), reason=self.reason,
                    screened=[p.to_dict() for p in self.screened[:8]],
                    refined=[o.to_dict() for o in self.outcomes])


def tune_ingest(w: WorkloadSpec, env: EnvSpec,
                cand: Candidate | None = None, *, refine: int = 0,
                eval_n: int = 1200, nq: int = 32, seed: int = 0,
                device=None) -> IngestRecommendation:
    """Pick compaction knobs for a workload with ``write_rate_qps`` > 0.

    Analytic screen over the knob grid; with ``refine`` > 0 the top
    ``refine`` feasible points are measured on the real engine.  The
    recommendation is the *freshest* feasible point whose (predicted or
    measured) QPS is within ``QPS_SLACK`` of the best — freshness is
    what the delta tier exists to buy, so it is the tiebreak."""
    if w.write_rate_qps <= 0:
        raise ValueError("tune_ingest needs a WorkloadSpec with "
                         "write_rate_qps > 0 (read-only workloads have "
                         "no compaction to tune)")
    c = cand if cand is not None else Candidate(kind="cluster")
    screened = screen_ingest(w, env, c)
    feasible = [p for p in screened if p.feasible]
    if not feasible:
        return IngestRecommendation(
            point=min(screened,
                      key=lambda p: p.bandwidth_share).point,
            screened=screened, outcomes=[],
            reason="no point keeps compaction under "
                   f"{MAX_BANDWIDTH_SHARE:.0%} of the NIC at "
                   f"{w.write_rate_qps:g} writes/s; returning the "
                   "least-saturating point")
    outcomes: list[IngestOutcome] = []
    if refine > 0:
        for p in feasible[:refine]:
            outcomes.append(evaluate_ingest_point(
                w, env, p, eval_n=eval_n, nq=nq, seed=seed,
                device=device))
        best_qps = max(o.measured_qps for o in outcomes)
        ok = [o for o in outcomes
              if o.measured_qps >= (1.0 - QPS_SLACK) * best_qps]
        pick = min(ok, key=lambda o: o.measured_seal_p99_s)
        return IngestRecommendation(
            point=pick.pred.point, screened=screened, outcomes=outcomes,
            reason=f"freshest measured point within {QPS_SLACK:.0%} of "
                   f"best QPS ({best_qps:.1f})")
    best_qps = feasible[0].pred_qps
    ok = [p for p in feasible
          if p.pred_qps >= (1.0 - QPS_SLACK) * best_qps]
    pick = min(ok, key=lambda p: p.pred_seal_lag_s)
    return IngestRecommendation(
        point=pick.point, screened=screened, outcomes=[],
        reason=f"freshest screened point within {QPS_SLACK:.0%} of best "
               f"predicted QPS ({best_qps:.1f})")
