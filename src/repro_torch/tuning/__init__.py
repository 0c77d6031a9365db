"""``repro_torch.tuning`` — simulation-driven auto-configuration (paper §5.2/§7
as a decision system).

Pipeline: ``enumerate_space`` (declarative grids, paper-derived priors)
→ ``screen`` (analytic Eq. 1/2 pricing prunes ≥90%) → ``successive_halving``
(survivors run on the real engine + storage simulator at subsampled scale)
→ ``pareto_frontier`` + ``autotune`` (knee-with-slack recommendation).

CLI: ``python -m repro_torch.tuning --recall 0.95 --concurrency 64 --dim 960
--storage tos`` emits a JSON :class:`Recommendation`.

The port's own copy of ``repro.tuning``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.  Every entry point that builds an index or an exact ground truth
takes ``device`` (default: the card; ``"cpu"`` runs the plain PyTorch
versions).
"""
from repro_torch.tuning.evaluate import (EvalBudget, EvalOutcome, default_budget,
                                         successive_halving)
from repro_torch.tuning.fleet import (FleetOutcome, FleetPoint,
                                      FleetRecommendation, LoadOutcome,
                                      LoadRecommendation, WindowOutcome,
                                      WindowRecommendation, evaluate_batch_window,
                                      evaluate_fleet_load, evaluate_fleet_point,
                                      tune_batch_window, tune_fleet,
                                      tune_fleet_for_load)
from repro_torch.tuning.ingest import (IngestOutcome, IngestPoint,
                                       IngestPrediction, IngestRecommendation,
                                       analytic_write_amplification,
                                       enumerate_ingest_space, screen_ingest,
                                       tune_ingest)
from repro_torch.tuning.pareto import hypervolume, pareto_frontier
from repro_torch.tuning.tenancy import (CacheSplit, CacheSplitRecommendation,
                                        SplitOutcome, SplitPrediction,
                                        che_hit_rate, enumerate_splits,
                                        miss_curve, object_access_profile,
                                        screen_cache_splits, tune_cache_split)
from repro_torch.tuning.recommend import Recommendation, autotune
from repro_torch.tuning.tier import (TierOutcome, TierPrediction, TierSplit,
                                     TierSplitRecommendation,
                                     enumerate_tier_splits, evaluate_tier_split,
                                     fleet_access_profile, screen_tier_splits,
                                     tune_tier_split)
from repro_torch.tuning.screen import (Prediction, ScreenResult,
                                       best_predicted_qps, predict, screen)
from repro_torch.tuning.space import (Candidate, EnvSpec, WorkloadSpec,
                                      enumerate_space, resolve_storage)

__all__ = [
    "autotune", "Recommendation", "WorkloadSpec", "EnvSpec", "Candidate",
    "enumerate_space", "resolve_storage", "screen", "predict",
    "Prediction", "ScreenResult", "best_predicted_qps",
    "successive_halving", "EvalBudget", "EvalOutcome", "default_budget",
    "pareto_frontier", "hypervolume",
    "FleetPoint", "FleetOutcome", "FleetRecommendation",
    "evaluate_fleet_point", "tune_fleet",
    "LoadOutcome", "LoadRecommendation", "evaluate_fleet_load",
    "tune_fleet_for_load",
    "WindowOutcome", "WindowRecommendation", "evaluate_batch_window",
    "tune_batch_window",
    "IngestPoint", "IngestPrediction", "IngestOutcome",
    "IngestRecommendation", "enumerate_ingest_space", "screen_ingest",
    "analytic_write_amplification", "tune_ingest",
    "CacheSplit", "SplitPrediction", "SplitOutcome",
    "CacheSplitRecommendation", "object_access_profile", "che_hit_rate",
    "miss_curve", "enumerate_splits", "screen_cache_splits",
    "tune_cache_split",
    "TierSplit", "TierPrediction", "TierOutcome",
    "TierSplitRecommendation", "fleet_access_profile",
    "enumerate_tier_splits", "screen_tier_splits", "evaluate_tier_split",
    "tune_tier_split",
]
