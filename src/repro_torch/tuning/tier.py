"""Budget-split tuning across the storage hierarchy: given a fixed
fleet spend in $/hour, how should it divide between machines, DRAM
cache, and the local NVMe tier?

The knobs trade against each other through one price book
(:class:`repro_torch.obs.cost.PriceBook`): a wider fleet buys parallelism but
dilutes the per-query cache budget; more DRAM buys the fastest hits at
~10x the $/GiB of NVMe; a big NVMe tier absorbs the DRAM overflow at
~100us instead of the object store's ~10ms.  The paper's observation
that storage pricing, not raw latency, decides the deployment shape is
exactly this trade.

Same two-stage discipline as :mod:`repro_torch.tuning.tenancy`:

* **screen** — enumerate (width, DRAM GiB, NVMe GiB) points that spend
  the budget, predict per-tier hit rates with Che's approximation
  (:func:`repro_torch.tuning.tenancy.che_hit_rate`) over the workload's
  cluster-list access profile — or a measured miss-ratio curve from
  ``repro_torch.obs.mrc`` when one is supplied — and rank by expected fetch
  latency ``h_dram*0 + (h_nvme - h_dram)*t_nvme + (1 - h_nvme)*t_remote``.
* **refine** — re-price the top-K screened points with real tiered
  fleet runs and recommend the measured-p99 winner.

Candidate byte budgets are scaled by the eval-to-full index-bytes
ratio (the ``tuning.evaluate`` coverage discipline), so a 1200-vector
analogue sees the same *fraction* of its index cached as the full
deployment would.

The port's own copy of ``repro.tuning.tier``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code apart from its ``device`` lines. The eval index is built where
``device`` says (default: the card).
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.core.types import SearchParams
from repro_torch.fleet.partition import ClusterPartition
from repro_torch.fleet.router import FleetConfig, FleetRouter
from repro_torch.obs.cost import GiB, PriceBook
from repro_torch.obs.mrc import mrc_miss_ratio
from repro_torch.storage.spec import NVME
from repro_torch.tuning.fleet import _eval_index
from repro_torch.tuning.space import EnvSpec, WorkloadSpec
from repro_torch.tuning.tenancy import che_hit_rate

TIER_WIDTH_GRID = (1, 2, 4)


def fleet_access_profile(index, queries, nprobe: int) -> dict:
    """(key -> [nbytes, access_count]) over the probed posting lists —
    the single-tenant analogue of ``tenancy.object_access_profile``."""
    profile: dict = {}
    np_eff = min(nprobe, index.meta.n_lists)
    for q in queries:
        lids, _ = index.select_lists(q, np_eff)
        for li in lids:
            key = ("list", int(li))
            ent = profile.get(key)
            if ent is None:
                profile[key] = [int(index.meta.list_nbytes[int(li)]), 1]
            else:
                ent[1] += 1
    return profile


@dataclasses.dataclass(frozen=True)
class TierSplit:
    """One evaluable point: machines x per-machine DRAM x per-machine
    NVMe.  GiB figures are *full-scale* (what the budget buys)."""

    n_shards: int
    dram_gib: float
    nvme_gib: float

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.dram_gib < 0 or self.nvme_gib < 0:
            raise ValueError("dram_gib/nvme_gib must be >= 0, got "
                             f"({self.dram_gib}, {self.nvme_gib})")

    def usd_per_hour(self, book: PriceBook) -> float:
        return self.n_shards * (
            book.instance_per_hour_usd
            + self.dram_gib * book.cache_dram_per_gib_hour_usd
            + self.nvme_gib * book.nvme_per_gib_hour_usd)

    def label(self) -> str:
        return (f"tier[S={self.n_shards},dram={self.dram_gib:.1f}GiB,"
                f"nvme={self.nvme_gib:.1f}GiB]")

    def to_dict(self) -> dict:
        return dict(n_shards=self.n_shards,
                    dram_gib=round(self.dram_gib, 3),
                    nvme_gib=round(self.nvme_gib, 3))


@dataclasses.dataclass
class TierPrediction:
    """Analytic screen result for one split."""

    split: TierSplit
    usd_per_hour: float
    hit_dram: float                # fetches absorbed by DRAM
    hit_nvme: float                # cumulative: DRAM or NVMe
    expected_fetch_s: float        # access-weighted mean fetch latency

    def to_dict(self) -> dict:
        return dict(split=self.split.to_dict(),
                    usd_per_hour=round(self.usd_per_hour, 6),
                    hit_dram=round(self.hit_dram, 4),
                    hit_nvme=round(self.hit_nvme, 4),
                    expected_fetch_s=round(self.expected_fetch_s, 9))


def enumerate_tier_splits(budget_usd_per_hour: float, book: PriceBook,
                          widths: tuple[int, ...] = TIER_WIDTH_GRID,
                          steps: int = 6) -> list[TierSplit]:
    """Splits that spend the budget: for each feasible width, sweep the
    DRAM share of the per-machine residual in ``steps`` increments (the
    rest buys NVMe).  Endpoints are the pure strategies — all-DRAM
    (flat cache fleet, no tier) and all-NVMe."""
    if budget_usd_per_hour <= 0:
        raise ValueError("budget_usd_per_hour must be > 0, got "
                         f"{budget_usd_per_hour}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    out = []
    for w in widths:
        rem = budget_usd_per_hour / w - book.instance_per_hour_usd
        if rem <= 0:
            continue                    # width alone blows the budget
        for i in range(steps + 1):
            f = i / steps
            out.append(TierSplit(
                n_shards=w,
                dram_gib=f * rem / book.cache_dram_per_gib_hour_usd,
                nvme_gib=(1.0 - f) * rem / book.nvme_per_gib_hour_usd))
    if not out:
        raise ValueError(
            f"budget ${budget_usd_per_hour}/h cannot pay for one "
            f"instance at ${book.instance_per_hour_usd}/h "
            f"(pricebook {book.name!r})")
    return out


def resolve_mrc_curve(artifact: dict) -> dict:
    """Accept either a bare curve (``{"sizes", "miss_ratio"}``) or a
    full ``--mrc`` profiler artifact (``repro_torch.obs.mrc``).  The tier
    split is fleet-wide, so a multi-tenant artifact is ambiguous —
    loud error rather than a silent pick."""
    if "miss_ratio" in artifact and "sizes" in artifact:
        return artifact
    rows = artifact.get("tenants")
    if isinstance(rows, list) and len(rows) == 1:
        return rows[0]
    raise ValueError(
        "tier tuning wants one fleet-wide miss-ratio curve: pass "
        "{'sizes': [...], 'miss_ratio': [...]} or a single-tenant "
        "--mrc artifact "
        f"(got {len(rows) if isinstance(rows, list) else 'no'} "
        "tenant rows)")


def _hit(profile: dict, mrc: dict | None, cache_bytes: float) -> float:
    if mrc is not None:
        return 1.0 - mrc_miss_ratio(mrc["sizes"], mrc["miss_ratio"],
                                    cache_bytes)
    return che_hit_rate(profile, int(cache_bytes))


def screen_tier_splits(profile: dict, splits: list[TierSplit],
                       book: PriceBook, *, remote_spec,
                       scale: float = 1.0,
                       mrc: dict | None = None) -> list[TierPrediction]:
    """Rank splits by predicted mean fetch latency.

    ``scale`` maps full-scale GiB onto the profiled index (the
    eval-to-full index-bytes ratio; 1.0 when profiling at full scale).
    DRAM hits cost nothing extra (the engine never leaves the node);
    NVMe hits pay the device's TTFB; the rest pay ``remote_spec``.
    Ties break toward fewer machines — same latency, simpler fleet.
    """
    t_nvme = NVME.ttfb_p50_s + NVME.min_latency_s
    t_remote = remote_spec.ttfb_p50_s + remote_spec.min_latency_s
    preds = []
    for s in splits:
        dram = s.n_shards * s.dram_gib * GiB * scale
        hd = _hit(profile, mrc, dram)
        hn = _hit(profile, mrc, dram + s.n_shards * s.nvme_gib * GiB
                  * scale)
        hn = max(hn, hd)               # cumulative by construction
        preds.append(TierPrediction(
            split=s, usd_per_hour=s.usd_per_hour(book), hit_dram=hd,
            hit_nvme=hn,
            expected_fetch_s=(hn - hd) * t_nvme + (1.0 - hn) * t_remote))
    preds.sort(key=lambda p: (p.expected_fetch_s, p.split.n_shards,
                              -p.hit_dram))
    return preds


@dataclasses.dataclass
class TierOutcome:
    """Measured behaviour of one refined split at eval scale."""

    split: TierSplit
    usd_per_hour: float
    qps: float
    p99_s: float
    recall: float
    hit_dram: float                # measured DRAM hit rate
    hit_nvme_frac: float           # NVMe share of DRAM misses
    eval_n: int

    def to_dict(self) -> dict:
        return dict(split=self.split.to_dict(),
                    usd_per_hour=round(self.usd_per_hour, 6),
                    qps_eval=round(self.qps, 2),
                    p99_s=round(self.p99_s, 6),
                    recall=round(self.recall, 4),
                    hit_dram=round(self.hit_dram, 4),
                    hit_nvme_frac=round(self.hit_nvme_frac, 4),
                    eval_n=self.eval_n)


@dataclasses.dataclass
class TierSplitRecommendation:
    """screen + refine result: how to spend the hourly budget."""

    workload: WorkloadSpec
    env_storage: str
    budget_usd_per_hour: float
    pricebook: str
    split: TierSplit
    feasible: bool                 # a refined split met the recall floor
    screened: list[TierPrediction]
    refined: list[TierOutcome]

    def to_dict(self) -> dict:
        return dict(
            workload=dataclasses.asdict(self.workload),
            environment=dict(storage=self.env_storage),
            budget_usd_per_hour=self.budget_usd_per_hour,
            pricebook=self.pricebook,
            recommendation=self.split.to_dict(),
            meets_recall=self.feasible,
            screened=[p.to_dict() for p in self.screened[:12]],
            refined=[o.to_dict() for o in self.refined])

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


def _tier_fleet_cfg(w: WorkloadSpec, env: EnvSpec, split: TierSplit,
                    scale: float, index_bytes: int,
                    seed: int) -> FleetConfig:
    """The refine run's concrete fleet: per-shard budgets scaled onto
    the eval index and clamped to it (a device bigger than the dataset
    buys nothing)."""
    cache = min(int(split.dram_gib * GiB * scale), index_bytes)
    nvme = min(int(split.nvme_gib * GiB * scale), index_bytes)
    return FleetConfig(
        n_shards=split.n_shards, storage=env.storage,
        concurrency=max(w.concurrency, 32), shard_concurrency=8,
        queue_depth=64, cache_bytes=cache,
        cache_policy="slru" if cache > 0 else "none",
        nvme_bytes=nvme, seed=seed)


def evaluate_tier_split(w: WorkloadSpec, env: EnvSpec, split: TierSplit,
                        index, queries, gt, *, scale: float,
                        book: PriceBook, nprobe: int = 32,
                        seed: int = 0) -> TierOutcome:
    """Run one split on the shared eval index and measure it."""
    params = SearchParams(k=w.k, nprobe=min(nprobe, index.meta.n_lists))
    cfg = _tier_fleet_cfg(w, env, split, scale, index.meta.index_bytes,
                          seed)
    partition = ClusterPartition.build(index.meta.list_nbytes,
                                       split.n_shards, 1)
    rep = FleetRouter(index, cfg, partition=partition).run(queries, params)
    nv_hits = nv_misses = 0
    for s in rep.shard_stats or []:
        nv = getattr(s, "nvme", None)
        if nv:
            nv_hits += nv["hits"]
            nv_misses += nv["misses"]
    return TierOutcome(
        split=split, usd_per_hour=split.usd_per_hour(book), qps=rep.qps,
        p99_s=rep.latency_percentile(99), recall=rep.recall_against(gt),
        hit_dram=rep.hit_rate,
        hit_nvme_frac=(nv_hits / (nv_hits + nv_misses)
                       if nv_hits + nv_misses else 0.0),
        eval_n=index.meta.n_data)


def tune_tier_split(w: WorkloadSpec, env: EnvSpec,
                    budget_usd_per_hour: float, *,
                    book: PriceBook | None = None,
                    widths: tuple[int, ...] = TIER_WIDTH_GRID,
                    steps: int = 6, refine_top: int = 3,
                    mrc: dict | None = None, eval_n: int = 1200,
                    nq: int = 48, nprobe: int = 32,
                    seed: int = 0, device=None) -> TierSplitRecommendation:
    """Split a fixed $/h budget across fleet width, DRAM and NVMe.

    Screens every budget-spending split analytically, then re-prices
    the top ``refine_top`` with real tiered fleet runs; the pick is the
    measured-p99 winner among refined splits meeting the workload's
    recall floor (ties: fewer machines).  ``mrc`` accepts a measured
    miss-ratio curve (``{"sizes": [...], "miss_ratio": [...]}`` from
    ``repro_torch.obs.mrc``) in place of the Che screen.
    """
    book = book or PriceBook()
    if mrc is not None:
        mrc = resolve_mrc_curve(mrc)
    index, queries, gt = _eval_index(w, eval_n, nq, seed, device=device)
    profile = {} if mrc is not None else \
        fleet_access_profile(index, queries, nprobe)
    scale = index.meta.index_bytes / max(w.n * w.vector_bytes, 1)
    splits = enumerate_tier_splits(budget_usd_per_hour, book,
                                   widths=widths, steps=steps)
    screened = screen_tier_splits(profile, splits, book,
                                  remote_spec=env.storage, scale=scale,
                                  mrc=mrc)
    refined = [evaluate_tier_split(
        w, env, p.split, index, queries, gt, scale=scale, book=book,
        nprobe=nprobe, seed=seed)
        for p in screened[:max(refine_top, 1)]]
    feas = [o for o in refined if o.recall >= w.target_recall - 0.005]
    if feas:
        pick = min(feas, key=lambda o: (o.p99_s, o.split.n_shards))
        feasible = True
    else:
        pick = max(refined, key=lambda o: (o.recall, -o.p99_s))
        feasible = False
    return TierSplitRecommendation(
        workload=w, env_storage=env.storage.name,
        budget_usd_per_hour=budget_usd_per_hour, pricebook=book.name,
        split=pick.split, feasible=feasible, screened=screened,
        refined=refined)
