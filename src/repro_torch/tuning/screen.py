"""Stage 1 of the tuner: cheap analytic screening (no simulation).

Every candidate is priced with the paper's executable cost models
(Eq. 1 / Eq. 2 in ``core/cost_model.py``) at *full workload scale*, plus
two priors that make the pricing recall- and cache-aware:

* **recall priors** — monotone curves anchored on the paper's §5.2
  parameter sweeps (the knob values Figs 7/17–19 needed per recall level
  at GIST-like dimensionality), rescaled for dim / replica / out-degree.
  They are priors, not measurements: stage 2 replaces them with recall
  measured on subsampled data.
* **hit-rate priors** — a Zipf/coverage model of the segment cache
  (§4.1's "commonality and stability"): SLRU approaches the Zipf head
  mass ``coverage^(1-1/a)`` but pays a churn discount at small coverage;
  a pinned hot set avoids churn but cannot adapt, so the two cross over
  as the cache grows — the §7 policy-flip the tuner must rediscover.

``screen`` keeps the top predicted-QPS configs among those predicted to
meet the recall target, reserving a few slots for minority index kinds
and cache policies so stage 2 can observe crossovers.  On the standard
grids (≥40 configs) it prunes ≥90% of the space by construction
(``keep ≤ len(space) // 10``); heavily filtered small spaces keep a
floor of 4 survivors so stage 2 still has a cohort.

The port's own copy of ``repro.tuning.screen``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.cost_model import (ClusterWorkloadPoint, GraphWorkloadPoint,
                                         cluster_query_cost, graph_query_cost,
                                         predicted_qps)
from repro_torch.storage.object_store import round_to_sectors
from repro_torch.tuning.space import Candidate, EnvSpec, WorkloadSpec

# (recall, knob) anchors at the reference point: dim=960, n=1e6,
# replica=8 / R>=64.  From the paper's sweep protocol (§5.1/§5.2).
_CLUSTER_ANCHORS = ((0.70, 16), (0.90, 64), (0.95, 128), (0.99, 512),
                    (0.995, 2048))
_GRAPH_ANCHORS = ((0.70, 20), (0.90, 60), (0.95, 110), (0.99, 300),
                  (0.995, 500))

REPLICATION_PER_REPLICA = 0.10      # closure-replication bytes growth/replica
HIT_LATENCY_S = 100e-6


def _interp_recall(anchors, knob: float) -> float:
    """Monotone piecewise-linear recall(log2 knob) with saturating tails."""
    x = math.log2(max(knob, 1.0))
    pts = [(math.log2(v), r) for r, v in anchors]
    x0, r0 = pts[0]
    if x <= x0:                       # extrapolate down, floor at 0.05
        slope = (pts[1][1] - r0) / (pts[1][0] - x0)
        return max(0.05, r0 + slope * (x - x0))
    for (xa, ra), (xb, rb) in zip(pts, pts[1:]):
        if x <= xb:
            return ra + (rb - ra) * (x - xa) / (xb - xa)
    xn, rn = pts[-1]                  # saturate toward 1.0 above the top
    return min(0.9995, rn + (1.0 - rn) * (1.0 - 2.0 ** (xn - x)))


def cluster_recall_prior(w: WorkloadSpec, c: Candidate) -> float:
    """Effective nprobe: harder at high dim (§5.2 dimensionality study),
    helped by replication (Fig 16) and hurt by finer partitions at equal
    nprobe (Fig 14 — each of more lists covers fewer points)."""
    ne = (c.nprobe * math.sqrt(960.0 / w.dim)
          * (c.num_replica / 8.0) ** 0.3
          * (0.16 / c.centroid_frac) ** 0.5)
    return _interp_recall(_CLUSTER_ANCHORS, ne)


def graph_recall_prior(w: WorkloadSpec, c: Candidate) -> float:
    """Effective search_len: dim penalty plus sparse-graph penalty (Fig 17)
    and a mild beamwidth bonus (wider frontier explores more, Fig 19)."""
    le = (c.search_len * math.sqrt(960.0 / w.dim)
          * min(1.0, c.R / 64.0) ** 0.5
          * (c.beamwidth / 16.0) ** 0.1)
    return _interp_recall(_GRAPH_ANCHORS, le)


def graph_roundtrips(w: WorkloadSpec, c: Candidate) -> int:
    """rt grows with search_len/beamwidth and log(n) (Fig 8b).

    Total expansions ≈ 1.5 × search_len (DiskANN visits a constant factor
    beyond L; the paper's rt-vs-recall anchors give rt·W/L ≈ 1.5), spread
    over W-wide rounds.
    """
    scale = math.log2(max(w.n, 2)) / math.log2(1e6)
    return max(3, round(1.5 * c.search_len / c.beamwidth * scale))


# ------------------------------------------------------------- sizing ----

def cluster_stats(w: WorkloadSpec, c: Candidate) -> tuple[float, float, float]:
    """(n_lists, avg_list_len, avg_list_bytes) at full workload scale."""
    n_lists = max(1.0, c.centroid_frac * w.n)
    rep_factor = 1.0 + REPLICATION_PER_REPLICA * c.num_replica
    avg_len = w.n * rep_factor / n_lists
    return n_lists, avg_len, avg_len * (w.vector_bytes + 8)


def graph_node_bytes(w: WorkloadSpec, c: Candidate) -> int:
    return round_to_sectors(w.vector_bytes + c.R * 4 + 8, 4096)


def index_bytes(w: WorkloadSpec, c: Candidate) -> float:
    if c.kind == "cluster":
        n_lists, _, list_bytes = cluster_stats(w, c)
        return n_lists * list_bytes
    return float(w.n) * graph_node_bytes(w, c)


# ----------------------------------------------------------- hit rates ---

def hit_rate_prior(w: WorkloadSpec, env: EnvSpec, c: Candidate) -> float:
    """Expected steady-state segment-cache hit rate for (policy, dist)."""
    if c.cache_policy == "none" or env.cache_bytes <= 0:
        return 0.0
    cov = min(1.0, env.cache_bytes / index_bytes(w, c))
    if cov <= 0.0:
        return 0.0
    if w.query_dist == "zipf":
        # Zipf head mass reachable with this coverage (Che-style).
        head = cov ** max(0.12, 1.0 - 1.0 / w.zipf_a)
        if c.cache_policy == "slru":
            return min(0.98, head * (1.0 - 0.30 * (1.0 - cov)))
        return min(0.95, head * (0.95 - 0.35 * cov))        # pinned
    # sequential / cold-ish: only inter-query segment sharing helps …
    hr = 0.5 * cov
    if c.kind == "graph":
        # … plus the entry-neighbourhood rounds every query revisits
        # (Fig 23); a pinned hot set captures exactly those.
        rt = graph_roundtrips(w, c)
        entry = min(0.5, (2.5 if c.cache_policy == "pinned" else 1.5) / rt)
        hr = max(hr, entry * min(1.0, cov * 50.0))
    return min(0.9, hr)


# ------------------------------------------------------------ predict ----

@dataclasses.dataclass(frozen=True)
class Prediction:
    cand: Candidate
    pred_recall: float
    pred_qps: float
    hit_rate: float
    cost: dict
    feasible: bool

    def to_dict(self) -> dict:
        return dict(config=self.cand.to_dict(),
                    pred_recall=round(self.pred_recall, 4),
                    pred_qps=round(self.pred_qps, 2),
                    hit_rate_prior=round(self.hit_rate, 4),
                    feasible=self.feasible)


def predict(w: WorkloadSpec, env: EnvSpec, c: Candidate,
            hit_rate: float | None = None,
            recall: float | None = None,
            recall_margin: float = 0.02) -> Prediction:
    """Full-scale analytic (recall, QPS) for one candidate.

    ``hit_rate``/``recall`` override the priors — stage 2 calls back in
    with *measured* values to re-price survivors at full scale.
    """
    hr = hit_rate_prior(w, env, c) if hit_rate is None else hit_rate
    if c.kind == "cluster":
        n_lists, avg_len, list_bytes = cluster_stats(w, c)
        cost = cluster_query_cost(
            env.storage,
            ClusterWorkloadPoint(n_lists=int(n_lists),
                                 avg_list_bytes=list_bytes,
                                 avg_list_len=avg_len, dim=w.dim,
                                 nprobe=c.nprobe),
            concurrency=w.concurrency, hit_rate=hr,
            hit_latency_s=HIT_LATENCY_S)
        r = cluster_recall_prior(w, c) if recall is None else recall
    else:
        cost = graph_query_cost(
            env.storage,
            GraphWorkloadPoint(roundtrips=graph_roundtrips(w, c),
                               requests_per_round=float(c.beamwidth),
                               node_nbytes=graph_node_bytes(w, c),
                               R=c.R, pq_m=max(48, w.dim // 8), dim=w.dim),
            concurrency=w.concurrency, hit_rate=hr,
            hit_latency_s=HIT_LATENCY_S)
        r = graph_recall_prior(w, c) if recall is None else recall
    qps = predicted_qps(env.storage, cost["total"], cost["bytes"],
                        cost["requests"], w.concurrency)
    return Prediction(cand=c, pred_recall=r, pred_qps=qps, hit_rate=hr,
                      cost=cost, feasible=r >= w.target_recall - recall_margin)


# ------------------------------------------------------------- screen ----

@dataclasses.dataclass
class ScreenResult:
    kept: list[Prediction]
    n_total: int

    @property
    def prune_fraction(self) -> float:
        return 1.0 - len(self.kept) / max(1, self.n_total)


def best_predicted_qps(preds: list[Prediction]) -> float:
    """Best predicted QPS among feasible predictions (0 if none)."""
    return max((p.pred_qps for p in preds if p.feasible), default=0.0)


def screen(w: WorkloadSpec, env: EnvSpec, cands: list[Candidate],
           keep: int | None = None) -> ScreenResult:
    """Analytically prune the space down to the survivors stage 2 will
    simulate: ≤10% of the candidates (≥90% pruned) whenever the space has
    at least 40 configs, with a floor of 4 survivors on smaller spaces."""
    preds = [predict(w, env, c) for c in cands]
    cap = max(4, len(cands) // 10)
    cap = min(cap, keep) if keep is not None else cap
    feasible = sorted((p for p in preds if p.feasible),
                      key=lambda p: -p.pred_qps)
    if not feasible:
        # nothing meets the target: surface the closest-to-target configs
        # so the caller can report the achievable frontier honestly.
        closest = sorted(preds, key=lambda p: (-p.pred_recall, -p.pred_qps))
        return ScreenResult(kept=closest[:cap], n_total=len(cands))
    # diversify across the *search knob* first: many (build-param) variants
    # of the same knob value score near-identically, and keeping them all
    # would crowd the knee band (recommend.QPS_SLACK) out of the kept set.
    def _knob(c: Candidate):
        return (c.nprobe,) if c.kind == "cluster" else (
            c.search_len, c.beamwidth)

    knob_groups: dict[tuple, list[Prediction]] = {}
    for p in feasible:
        knob_groups.setdefault((p.cand.kind, p.cand.cache_policy,
                                _knob(p.cand)), []).append(p)
    # group representative: the highest-recall member among those within
    # 5% of the group's best QPS (build variants of one knob value are
    # near-ties on cost; recall is what distinguishes them).
    reps = []
    for members in knob_groups.values():
        best_q = max(m.pred_qps for m in members)
        near = [m for m in members if m.pred_qps >= 0.95 * best_q]
        reps.append(max(near, key=lambda m: (m.pred_recall, m.pred_qps)))
    kept = sorted(reps, key=lambda p: -p.pred_qps)[:cap]
    seen = set(id(p) for p in kept)
    # reserve the best of each missing (kind, cache_policy) group FIRST —
    # crossovers (index class, policy flip) must survive to simulation —
    # evicting the lowest-QPS member of an over-represented group when
    # the cap is already reached.
    groups: dict[tuple, Prediction] = {}
    for p in feasible:                    # qps-sorted: first is group best
        groups.setdefault((p.cand.kind, p.cand.cache_policy), p)

    def _gkey(p: Prediction) -> tuple:
        return (p.cand.kind, p.cand.cache_policy)

    for key, p in groups.items():
        if any(_gkey(k) == key for k in kept):
            continue
        if len(kept) >= cap:
            counts: dict[tuple, int] = {}
            for k in kept:
                counts[_gkey(k)] = counts.get(_gkey(k), 0) + 1
            victims = [k for k in kept if counts[_gkey(k)] > 1]
            if not victims:
                continue                  # every group is a singleton
            worst = min(victims, key=lambda k: k.pred_qps)
            kept.remove(worst)
            seen.discard(id(worst))
        kept.append(p)
        seen.add(id(p))
    # fill any remaining slots with the next-best overall
    for p in feasible:
        if len(kept) >= cap:
            break
        if id(p) not in seen:
            kept.append(p)
            seen.add(id(p))
    kept.sort(key=lambda p: -p.pred_qps)
    return ScreenResult(kept=kept, n_total=len(cands))
