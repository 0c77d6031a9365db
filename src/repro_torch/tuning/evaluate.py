"""Stage 2 of the tuner: successive-halving refinement on real components.

Screen survivors are run through the *actual* serving stack — index build
(``core/cluster_index.py`` / ``core/graph_index.py``), the discrete-event
storage simulator, and the segment cache — on subsampled synthetic data
(``data/synth.py``) matching the workload's dim/dtype.  Measured recall
and measured cache hit rate then re-price each survivor at full workload
scale through the analytic model (``screen.predict``), replacing the
stage-1 priors with observations.

Scaling discipline (what transfers from a few-hundred-point analogue and
what does not):

* recall vs the search knob transfers (clustered low-intrinsic-dim data);
  when the eval index is too small to exercise a knob (nprobe clamped to
  the number of lists) the measurement is uninformative and the prior is
  kept — ``recall_est = min(measured, prior + 0.05)`` caps the small-scale
  optimism either way.
* graph out-degree is scaled down with the subsample (R/4) — degree ratios
  stay comparable; build passes drop to 1.  Builds are cached per
  ``Candidate.build_sig`` within a tuning run.
* the cache budget is scaled by the eval-to-full index-bytes ratio so
  *coverage* (the axis that drives policy behaviour) is preserved.

The port's own copy of ``repro.tuning.evaluate``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code apart from its ``device`` lines. Each rung's exact ground truth
(``l2_topk``) and index builds (the cluster closure through ``l2_topk``; the
graph's greedy search and PQ training) run where ``device`` says (default:
the card; ``"cpu"`` runs the plain PyTorch versions).
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np

from repro_torch.core.cluster_index import ClusterIndex
from repro_torch.core.flat import exact_topk
from repro_torch.core.graph_index import GraphIndex
from repro_torch.core.types import (ClusterIndexParams, GraphIndexParams,
                                    QueryMetrics, SearchParams)
from repro_torch.data.synth import DatasetSpec, make_dataset
from repro_torch.serving.engine import EngineConfig, QueryEngine
from repro_torch.serving.workload import sequential, zipf_repeated
from repro_torch.tuning import screen as scr
from repro_torch.tuning.space import Candidate, EnvSpec, WorkloadSpec


@dataclasses.dataclass(frozen=True)
class EvalBudget:
    """Successive-halving rungs: (subsample n, query count) per rung."""

    rungs: tuple[tuple[int, int], ...]
    max_rung0: int = 12          # configs entering rung 0
    min_promote: int = 3
    seed: int = 0


def default_budget(w: WorkloadSpec, seed: int = 0) -> EvalBudget:
    """Rung sizes scaled so graph builds stay seconds, not minutes."""
    if w.dim >= 512:
        rungs = ((500, 24), (900, 36))
    else:
        rungs = ((1500, 40), (3000, 56))
    return EvalBudget(rungs=rungs, seed=seed)


@dataclasses.dataclass
class EvalOutcome:
    pred: scr.Prediction                 # stage-1 screen entry
    measured_recall: float
    measured_qps: float                  # virtual-time QPS at eval scale
    hit_rate: float
    recall_est: float                    # blended (see module docstring)
    final: scr.Prediction                # full-scale re-prediction
    rung: int
    eval_n: int

    @property
    def cand(self) -> Candidate:
        return self.pred.cand

    def to_dict(self) -> dict:
        return dict(config=self.cand.to_dict(),
                    measured_recall=round(self.measured_recall, 4),
                    measured_qps_eval=round(self.measured_qps, 2),
                    measured_hit_rate=round(self.hit_rate, 4),
                    recall_est=round(self.recall_est, 4),
                    qps_full_scale=round(self.final.pred_qps, 2),
                    feasible=self.final.feasible,
                    rung=self.rung, eval_n=self.eval_n)


# ---------------------------------------------------------------- data ---

class _Rung:
    """One subsample scale: dataset + ground truth + per-build index cache."""

    def __init__(self, w: WorkloadSpec, n: int, nq: int, seed: int,
                 device=None):
        n = min(n, w.n)
        self.n = n
        spec = DatasetSpec(
            "tuner-analog", w.dim, w.dtype, n, nq,
            n_clusters=max(8, min(64, n // 16)),
            intrinsic_dim=min(32, w.dim), seed=seed)
        self.data, self.queries = make_dataset(spec)
        self.gt, _ = exact_topk(self.data, self.queries, w.k, device=device)
        self._indexes: dict[tuple, object] = {}
        self.seed = seed
        self.device = device

    def index_for(self, c: Candidate):
        sig = c.build_sig()
        if sig in self._indexes:
            return self._indexes[sig]
        if c.kind == "cluster":
            idx = ClusterIndex.build(self.data, ClusterIndexParams(
                centroid_frac=c.centroid_frac, num_replica=c.num_replica,
                kmeans_iters=4, seed=self.seed), device=self.device)
        else:
            R_eval = max(12, c.R // 4)
            from repro_torch.core.pq import default_pq_dims
            idx = GraphIndex.build(self.data, GraphIndexParams(
                R=R_eval, L_build=max(24, 2 * R_eval), build_passes=1,
                pq_dims=default_pq_dims(self.data.shape[1]),
                seed=self.seed), device=self.device)
        self._indexes[sig] = idx
        return idx


def _search_params(w: WorkloadSpec, c: Candidate, index) -> SearchParams:
    if c.kind == "cluster":
        return SearchParams(k=w.k, nprobe=min(c.nprobe, index.meta.n_lists))
    return SearchParams(k=w.k, search_len=c.search_len,
                        beamwidth=c.beamwidth)


def _workload_stream(w: WorkloadSpec, queries: np.ndarray, seed: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    if w.query_dist == "zipf":
        return zipf_repeated(queries, n_total=3 * len(queries),
                             a=w.zipf_a, seed=seed)
    return sequential(queries)


def hot_keys(index, queries: np.ndarray, params: SearchParams,
             budget_bytes: int, n_warmup: int = 12) -> frozenset:
    """Frequency-ranked fetch keys from a warmup slice, greedily packed
    into the byte budget — the pinned policy's fixed content."""
    freq: Counter = Counter()
    sizes: dict = {}
    for q in queries[: n_warmup]:
        gen = index.search_plan(q, params, QueryMetrics())
        try:
            batch = next(gen)
            while True:
                for rq in batch.requests:
                    freq[rq.key] += 1
                    sizes[rq.key] = rq.nbytes
                batch = gen.send({rq.key: index.store.get(rq.key)
                                  for rq in batch.requests})
        except StopIteration:
            pass
    picked = []
    used = 0
    for key, _ in freq.most_common():
        nb = sizes[key]
        if used + nb > budget_bytes:
            continue
        picked.append(key)
        used += nb
    return frozenset(picked)


def evaluate_candidate(w: WorkloadSpec, env: EnvSpec, pred: scr.Prediction,
                       rung: _Rung, rung_idx: int) -> EvalOutcome:
    """Build (or reuse), simulate, measure, and re-price one candidate."""
    c = pred.cand
    index = rung.index_for(c)
    params = _search_params(w, c, index)
    stream_q, stream_ids = _workload_stream(w, rung.queries, rung.seed)

    # preserve cache *coverage* at eval scale
    cache_eval = 0
    pinned: frozenset | None = None
    if c.cache_policy != "none" and env.cache_bytes > 0:
        full_bytes = scr.index_bytes(w, c)
        cache_eval = int(env.cache_bytes
                         * index.meta.index_bytes / max(full_bytes, 1.0))
        cache_eval = min(cache_eval, index.meta.index_bytes)
        if c.cache_policy == "pinned":
            pinned = hot_keys(index, stream_q, params, cache_eval)

    cfg = EngineConfig(
        storage=env.storage, concurrency=min(w.concurrency, len(stream_q)),
        cache_bytes=cache_eval, cache_policy=c.cache_policy,
        pinned_keys=pinned, seed=rung.seed)
    eng = QueryEngine(index, cfg)
    if c.cache_policy == "slru" and cache_eval > 0:
        # steady-state measurement: one warm-up pass fills the cache so
        # SLRU isn't charged its compulsory cold misses against the
        # pinned policy, whose set is prefilled from its own warm-up.
        # (Pinned contents are fixed — a warm-up pass would be a no-op.)
        eng.run(stream_q, params)
    rep = eng.run(stream_q, params, query_ids=stream_ids)

    measured_recall = rep.recall_against(rung.gt)
    hit_rate = rep.hit_rate
    # a saturated measurement (probing ~every list / visiting ~the whole
    # graph, or recall pegged at ~1 by the small scale) carries no signal
    # about full-scale recall: fall back to the prior.  An unsaturated
    # measurement is informative both ways — it can veto an optimistic
    # prior outright, or lift a pessimistic one by at most 0.05.
    saturated = measured_recall >= 0.995 or (
        c.nprobe >= index.meta.n_lists if c.kind == "cluster"
        else c.search_len >= rung.n)
    if saturated:
        recall_est = min(measured_recall, pred.pred_recall)
    else:
        recall_est = min(measured_recall, pred.pred_recall + 0.05)
    final = scr.predict(w, env, c, hit_rate=hit_rate, recall=recall_est)
    return EvalOutcome(pred=pred, measured_recall=measured_recall,
                       measured_qps=rep.qps, hit_rate=hit_rate,
                       recall_est=recall_est, final=final,
                       rung=rung_idx, eval_n=rung.n)


def trace_candidate(w: WorkloadSpec, env: EnvSpec, cand: Candidate, *,
                    eval_n: int = 800, nq: int = 32, seed: int = 0,
                    tracer=None, device=None):
    """Re-run one (typically: the recommended) candidate with a tracer
    attached, using the same rung recipe as :func:`evaluate_candidate`.

    The halving sweep stays untraced — spans from discarded configs are
    noise; the single validation rerun shows where the winner's time
    goes.  Returns the engine report; the spans land in ``tracer``.
    """
    rung = _Rung(w, eval_n, nq, seed, device=device)
    index = rung.index_for(cand)
    params = _search_params(w, cand, index)
    stream_q, stream_ids = _workload_stream(w, rung.queries, rung.seed)
    cache_eval = 0
    pinned: frozenset | None = None
    if cand.cache_policy != "none" and env.cache_bytes > 0:
        full_bytes = scr.index_bytes(w, cand)
        cache_eval = int(env.cache_bytes
                         * index.meta.index_bytes / max(full_bytes, 1.0))
        cache_eval = min(cache_eval, index.meta.index_bytes)
        if cand.cache_policy == "pinned":
            pinned = hot_keys(index, stream_q, params, cache_eval)
    cfg = EngineConfig(
        storage=env.storage, concurrency=min(w.concurrency, len(stream_q)),
        cache_bytes=cache_eval, cache_policy=cand.cache_policy,
        pinned_keys=pinned, seed=rung.seed)
    eng = QueryEngine(index, cfg)
    return eng.run(stream_q, params, query_ids=stream_ids, tracer=tracer)


def _score(o: EvalOutcome) -> tuple:
    """Feasible first, then full-scale QPS, then recall headroom."""
    return (o.final.feasible, o.final.pred_qps, o.recall_est)


def successive_halving(w: WorkloadSpec, env: EnvSpec,
                       screened: list[scr.Prediction],
                       budget: EvalBudget | None = None,
                       device=None) -> list[EvalOutcome]:
    """Run survivors through progressively larger simulations, halving the
    cohort between rungs.  Returns the latest outcome per candidate."""
    budget = budget or default_budget(w)
    cohort = sorted(screened, key=lambda p: -p.pred_qps)[: budget.max_rung0]
    latest: dict[tuple, EvalOutcome] = {}
    for ri, (n_sub, nq) in enumerate(budget.rungs):
        if not cohort:
            break
        rung = _Rung(w, n_sub, nq, seed=budget.seed + ri, device=device)
        outcomes = [evaluate_candidate(w, env, p, rung, ri) for p in cohort]
        for o in outcomes:
            latest[tuple(sorted(o.cand.to_dict().items()))] = o
        outcomes.sort(key=_score, reverse=True)
        n_next = max(budget.min_promote, len(outcomes) // 2)
        cohort = [o.pred for o in outcomes[:n_next]]
    return list(latest.values())
