"""Critical-path extraction and aggregate attribution over span trees.

For every ``query`` root span the extractor walks the tree and charges
each instant of the query's sojourn to exactly one *stage*:

``admission``     waiting for an admission-window slot
``route``         router pricing/partition lookup (per round)
``dispatch``      gap between a round opening and its winning shard job
                  being submitted (retry backoff after sheds)
``queue``         winning job waiting in the shard's run queue
``batching``      waiting in a kernel-backend batch window (coalescing;
                  zero on the analytic backend)
``cache_fetch``   fetch legs served entirely from the shard DRAM cache
``nvme_fetch``    fetch legs served entirely from the local NVMe tier
``storage_fetch`` fetch legs that went to remote storage (a mixed
                  NVMe+remote round is bounded by the remote fetch and
                  charges here; its attrs carry the NVMe split)
``compute``       scan/ADC/distance work between fetch legs
``merge``         global top-k merge after the final gather
``other``         residue (float error, uninstrumented gaps)

The *winning* job of a round is the one whose completion closed the
round (largest end time); everything the query actually waited for lies
on that chain, so summing stages over it reproduces the sojourn exactly
(to float error) — the acceptance criterion checks <= 1% drift against
the measured mean sojourn.

:func:`attribute` aggregates per-query paths into an
:class:`AttributionReport` (overall + p99 tail); :func:`trace_diff`
compares two reports so a failed perf gate can say *where* the
regression lives.

The port's own copy of ``repro.obs.critical_path``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["STAGES", "QueryPath", "AttributionReport", "extract_paths",
           "query_path", "path_shares", "attribute", "trace_diff",
           "render_diff"]

STAGES = ("admission", "route", "dispatch", "queue", "batching",
          "cache_fetch", "nvme_fetch", "storage_fetch", "compute",
          "merge", "other")

_LEG_NAMES = frozenset(("queue", "batching", "cache_fetch", "nvme_fetch",
                        "storage_fetch", "compute"))


@dataclass
class QueryPath:
    """One query's critical path, decomposed into stage times."""

    qid: int
    tenant: str | None
    sojourn: float
    stages: dict[str, float]

    @property
    def accounted(self) -> float:
        return sum(self.stages.values())


def _dur(span, clamp_hi: float) -> float:
    """A span's duration, treating an unclosed span (query aborted
    mid-round by a fault, or a leg cut off at trace end) as running to
    ``clamp_hi`` — never None arithmetic, never negative."""
    t1 = span.t1 if span.t1 is not None else clamp_hi
    return max(0.0, t1 - span.t0)


def _leg_stages(children: list, lo: float, hi: float) -> dict[str, float]:
    """Charge [lo, hi] to queue/fetch/compute legs among ``children``."""
    out: dict[str, float] = {}
    covered = 0.0
    for ch in children:
        if ch.name in _LEG_NAMES:
            d = _dur(ch, hi)
            out[ch.name] = out.get(ch.name, 0.0) + d
            covered += d
    residue = (hi - lo) - covered
    if residue > 1e-12:
        out["other"] = out.get("other", 0.0) + residue
    return out


def query_path(root, kids_of) -> QueryPath | None:
    """One query root's critical path.  ``kids_of`` maps span sid ->
    child span list (any index shaped like ``Tracer.children_index()``).

    Degenerate trees are hardened, never fatal: unclosed children clamp
    to the root's end, jobless rounds charge to ``other``, and a
    zero-duration root yields an all-zero (finite) stage vector.
    Returns None for a root that never closed.
    """
    if root.t1 is None:
        return None
    root_hi = root.t1
    stages = dict.fromkeys(STAGES, 0.0)
    kids = kids_of.get(root.sid, [])
    # Single-engine traces put the job legs directly under the root.
    if not any(k.name == "round" for k in kids):
        for name, d in _leg_stages(kids, root.t0, root_hi).items():
            stages[name] += d
        for ch in kids:
            if ch.name in ("admission", "route", "merge"):
                d = _dur(ch, root_hi)
                stages[ch.name] += d
                stages["other"] = max(0.0, stages["other"] - d)
    else:
        for ch in kids:
            if ch.name in ("admission", "route", "merge"):
                stages[ch.name] += _dur(ch, root_hi)
            elif ch.name == "round":
                ch_hi = ch.t1 if ch.t1 is not None else root_hi
                jobs = [j for j in kids_of.get(ch.sid, [])
                        if j.name == "shard_job" and j.t1 is not None]
                if not jobs:
                    stages["other"] += max(0.0, ch_hi - ch.t0)
                    continue
                # the job whose completion closed the round
                winner = max(jobs, key=lambda j: j.t1)
                stages["dispatch"] += max(0.0, winner.t0 - ch.t0)
                legs = _leg_stages(kids_of.get(winner.sid, []),
                                   winner.t0, winner.t1)
                for name, d in legs.items():
                    stages[name] += d
                # gather fired at round close; job may end earlier
                # than the round boundary only by float error
                stages["other"] += max(0.0, ch_hi - winner.t1)
    attrs = root.attrs or {}
    return QueryPath(
        qid=attrs.get("qid", -1), tenant=attrs.get("tenant"),
        sojourn=max(0.0, root.t1 - root.t0), stages=stages)


def path_shares(path: QueryPath) -> dict[str, float]:
    """A path's stage vector normalised to fractions of its sojourn
    (all-zero for a zero-duration query — finite, never NaN)."""
    if path.sojourn <= 0.0:
        return dict.fromkeys(STAGES, 0.0)
    return {k: path.stages.get(k, 0.0) / path.sojourn for k in STAGES}


def extract_paths(tracer) -> list[QueryPath]:
    """Per-query critical paths from a tracer's span trees."""
    idx = tracer.children_index()
    paths: list[QueryPath] = []
    for root in idx.get(None, []):
        if root.name != "query":
            continue
        qp = query_path(root, idx)
        if qp is not None:
            paths.append(qp)
    return paths


@dataclass
class AttributionReport:
    """Aggregate stage attribution: where sojourn time goes."""

    n_queries: int
    mean_sojourn: float
    #: mean seconds per stage over all queries
    overall: dict[str, float]
    #: mean seconds per stage over the slowest 1% of queries
    tail: dict[str, float] = field(default_factory=dict)
    tail_mean_sojourn: float = 0.0

    @property
    def accounted(self) -> float:
        return sum(self.overall.values())

    def to_dict(self) -> dict:
        return dict(
            n_queries=self.n_queries,
            mean_sojourn_s=round(self.mean_sojourn, 9),
            accounted_s=round(self.accounted, 9),
            stages_s={k: round(v, 9) for k, v in self.overall.items()},
            tail_mean_sojourn_s=round(self.tail_mean_sojourn, 9),
            tail_stages_s={k: round(v, 9) for k, v in self.tail.items()},
        )

    def render(self) -> str:
        lines = [f"critical-path attribution over {self.n_queries} queries",
                 f"  mean sojourn {self.mean_sojourn * 1e3:9.3f} ms  "
                 f"(accounted {self.accounted * 1e3:.3f} ms)"]
        lines.append(f"  {'stage':<14}{'mean':>12}{'share':>8}"
                     f"{'p99-tail':>12}{'share':>8}")
        for name in STAGES:
            mu = self.overall.get(name, 0.0)
            tl = self.tail.get(name, 0.0)
            if mu <= 0.0 and tl <= 0.0:
                continue
            fs = mu / self.mean_sojourn if self.mean_sojourn else 0.0
            ft = tl / self.tail_mean_sojourn if self.tail_mean_sojourn \
                else 0.0
            lines.append(f"  {name:<14}{mu * 1e3:9.3f} ms{fs:7.1%}"
                         f"{tl * 1e3:9.3f} ms{ft:7.1%}")
        return "\n".join(lines)


def attribute(tracer) -> AttributionReport:
    """Aggregate per-query critical paths into one report."""
    paths = extract_paths(tracer)
    n = len(paths)
    if n == 0:
        return AttributionReport(0, 0.0, dict.fromkeys(STAGES, 0.0))
    overall = dict.fromkeys(STAGES, 0.0)
    for p in paths:
        for k, v in p.stages.items():
            overall[k] += v
    overall = {k: v / n for k, v in overall.items()}
    mean_sojourn = sum(p.sojourn for p in paths) / n
    # slowest 1% (at least one query)
    slow = sorted(paths, key=lambda p: p.sojourn)
    tail_n = max(1, int(round(n * 0.01)))
    tail_paths = slow[-tail_n:]
    tail = dict.fromkeys(STAGES, 0.0)
    for p in tail_paths:
        for k, v in p.stages.items():
            tail[k] += v
    tail = {k: v / tail_n for k, v in tail.items()}
    tail_mean = sum(p.sojourn for p in tail_paths) / tail_n
    return AttributionReport(n, mean_sojourn, overall, tail, tail_mean)


def trace_diff(a: dict, b: dict) -> dict:
    """Stage-by-stage delta between two attribution dicts (b - a).

    Antisymmetric by construction — ``trace_diff(a, b)`` negates
    ``trace_diff(b, a)`` — and exactly zero for identical runs.  Inputs
    are ``AttributionReport.to_dict()`` payloads (e.g. the ``attrib``
    block of a benchmark JSON).
    """
    sa, sb = a.get("stages_s", {}), b.get("stages_s", {})
    stages = {k: round(sb.get(k, 0.0) - sa.get(k, 0.0), 9)
              for k in sorted(set(sa) | set(sb))}
    return dict(
        mean_sojourn_delta_s=round(b.get("mean_sojourn_s", 0.0)
                                   - a.get("mean_sojourn_s", 0.0), 9),
        stages_delta_s=stages,
    )


def render_diff(diff: dict) -> str:
    """Human-readable trace diff, biggest movers first."""
    total = diff.get("mean_sojourn_delta_s", 0.0)
    lines = [f"attribution diff: mean sojourn {total * 1e3:+.3f} ms"]
    movers = sorted(diff.get("stages_delta_s", {}).items(),
                    key=lambda kv: -abs(kv[1]))
    for name, d in movers:
        if d == 0.0:
            continue
        share = d / total if total else 0.0
        lines.append(f"  {name:<14}{d * 1e3:+9.3f} ms"
                     + (f"  ({share:+.0%} of delta)" if total else ""))
    if len(lines) == 1:
        lines.append("  (no per-stage movement)")
    return "\n".join(lines)
