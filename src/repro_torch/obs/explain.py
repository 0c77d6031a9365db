"""Tail-latency explanation: exemplar reservoirs, windowed attribution,
and alert forensics over the span stream.

Attribution (PR 6) answers "where does the *mean* sojourn go"; this
module answers the operator's actual question — **why is the tail
slow** — while staying a pure observer (no kernel events, no kernel
RNG, bit-exact goldens hold with an :class:`ExplainCollector` attached).

Three mechanisms, all bounded-memory:

* **Tail-exemplar reservoirs** — the K worst-sojourn queries per tenant
  (a min-heap keyed ``(sojourn, qid)`` — fully deterministic), plus a
  uniform reservoir (Algorithm R on a private seeded PRNG, never the
  kernel's) as the "normal query" baseline.  Each exemplar keeps its
  critical-path stage vector, dominant stage and dominant shard.
* **Windowed attribution** — per-query stage vectors are folded into
  per-window stage *shares* published as ``attrib.<stage>.share``
  gauges on the tracer's registry, so the snapshot ticker turns
  run-level attribution into a flamegraph-over-time (Perfetto counter
  tracks).
* **explain_tail()** — clusters the worst exemplars by
  ``(dominant stage, dominant shard)`` signature, names the
  compaction/fault/scale events concurrent with each cluster's
  exemplars, and emits a deterministic report whose headline reads
  like a diagnosis: ``p99.9 is storage_fetch on shard 3 during
  compaction:recluster@shard3``.

:meth:`ExplainCollector.forensics` snapshots the same state (plus
counter deltas) into a dict; the router installs it as the
``FleetMonitor.forensics_provider`` so every fired alert carries its
own root-cause bundle.

The port's own copy of ``repro.obs.explain``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import heapq
import random

from .critical_path import STAGES, path_shares, query_path

__all__ = ["ExplainConfig", "Exemplar", "ExplainCollector",
           "render_explain"]


@dataclasses.dataclass(frozen=True)
class ExplainConfig:
    """Knobs for the tail-explanation collector."""

    k_worst: int = 8            # worst-sojourn exemplars kept per tenant
    uniform_k: int = 16         # baseline uniform reservoir size
    tail_pct: float = 99.9      # label for the report headline
    reservoir_seed: int = 0x5EED  # private PRNG (never the kernel's)

    def __post_init__(self) -> None:
        if self.k_worst < 1 or self.uniform_k < 1:
            raise ValueError("reservoir sizes must be >= 1")
        if not (50.0 <= self.tail_pct < 100.0):
            raise ValueError(f"tail_pct must be in [50, 100), got "
                             f"{self.tail_pct}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Exemplar:
    """One captured query: where its time went and what gated it."""

    qid: int
    tenant: str | None
    t0: float
    t1: float
    sojourn: float
    stages: dict[str, float]
    dominant_stage: str
    shard: int                  # dominant shard (-1: no shard job seen)

    def to_dict(self) -> dict:
        return dict(qid=self.qid, tenant=self.tenant,
                    sojourn_s=round(self.sojourn, 9),
                    t0=round(self.t0, 6), t1=round(self.t1, 6),
                    stage=self.dominant_stage, shard=self.shard,
                    stages_s={k: round(v, 9)
                              for k, v in self.stages.items() if v > 0})


def _dominant_stage(stages: dict[str, float]) -> str:
    """Largest stage, deterministic STAGES-order tie-break; ``other``
    for an all-zero vector (zero-duration query)."""
    best, best_v = "other", 0.0
    for name in STAGES:
        v = stages.get(name, 0.0)
        if v > best_v:
            best, best_v = name, v
    return best


def render_explain(rep: dict) -> str:
    """Human-readable rendering of an :meth:`ExplainCollector.
    explain_tail` report dict (also what ``--explain`` prints to
    stderr)."""
    lines = [f"tail explanation over {rep['n_queries']} queries "
             f"({rep['n_exemplars']} exemplars)",
             f"  {rep['headline']}"]
    for row in rep["clusters"]:
        ev = f"  [{', '.join(row['events'])}]" if row["events"] else ""
        shard = f" shard {row['shard']}" if row["shard"] >= 0 else ""
        lines.append(
            f"  {row['n']:>3}x {row['stage']:<14}{shard:<9} "
            f"mean {row['mean_sojourn_s'] * 1e3:8.3f} ms  "
            f"max {row['max_sojourn_s'] * 1e3:8.3f} ms{ev}")
    base = rep["baseline_shares"]
    tail = rep["tail_shares"]
    movers = sorted(STAGES, key=lambda s: -(tail[s] - base[s]))[:3]
    diffs = ", ".join(f"{s} {tail[s] - base[s]:+.0%}" for s in movers
                      if abs(tail[s] - base[s]) >= 0.005)
    if diffs:
        lines.append(f"  tail vs baseline shares: {diffs}")
    return "\n".join(lines)


class ExplainCollector:
    """Per-run tail-exemplar + windowed-attribution collector.

    The router calls :meth:`on_query` from ``_finish_query`` (the
    query's full span tree is recorded by then) and :meth:`publish`
    from its metrics-snapshot ticker.  Everything here reads tracer
    state; nothing is fed back into the simulation.
    """

    def __init__(self, tracer, cfg: ExplainConfig | None = None):
        self.cfg = cfg or ExplainConfig()
        self._tr = tracer
        # incremental children index: each span indexed exactly once
        self._by_parent: dict[int | None, list] = {}
        self._cursor = 0
        # tenant name (or "") -> min-heap of (sojourn, qid, Exemplar)
        self._worst: dict[str, list] = {}
        self._uniform: list[Exemplar] = []
        self._uniform_seen = 0
        self._rng = random.Random(self.cfg.reservoir_seed)
        # windowed attribution accumulators (reset on publish)
        self._win_stages = dict.fromkeys(STAGES, 0.0)
        self._win_sojourn = 0.0
        self._win_n = 0
        # cumulative (for baseline-free summaries)
        self._cum_stages = dict.fromkeys(STAGES, 0.0)
        self._cum_sojourn = 0.0
        self.n_queries = 0
        self._last_counters: dict[str, float] = {}

    # ------------------------------------------------------------ intake --
    def _index_new_spans(self) -> None:
        spans = self._tr.spans
        for sid in range(self._cursor, len(spans)):
            sp = spans[sid]
            self._by_parent.setdefault(sp.parent, []).append(sp)
        self._cursor = len(spans)

    def _dominant_shard(self, root) -> int:
        """Shard of the longest round-winning job (-1 without jobs)."""
        best_shard, best_dur = -1, -1.0
        for ch in self._by_parent.get(root.sid, []):
            if ch.name != "round":
                continue
            jobs = [j for j in self._by_parent.get(ch.sid, [])
                    if j.name == "shard_job" and j.t1 is not None]
            if not jobs:
                continue
            winner = max(jobs, key=lambda j: j.t1)
            dur = winner.t1 - winner.t0
            if dur > best_dur:
                best_dur = dur
                best_shard = (winner.attrs or {}).get("shard", -1)
        return best_shard

    def on_query(self, root) -> None:
        """Fold one completed query root span into the collector."""
        self._index_new_spans()
        qp = query_path(root, self._by_parent)
        if qp is None:
            return
        self.n_queries += 1
        for k, v in qp.stages.items():
            self._win_stages[k] += v
            self._cum_stages[k] += v
        self._win_sojourn += qp.sojourn
        self._cum_sojourn += qp.sojourn
        self._win_n += 1
        ex = Exemplar(
            qid=qp.qid, tenant=qp.tenant, t0=root.t0, t1=root.t1,
            sojourn=qp.sojourn, stages=qp.stages,
            dominant_stage=_dominant_stage(qp.stages),
            shard=self._dominant_shard(root))
        heap = self._worst.setdefault(qp.tenant or "", [])
        item = (qp.sojourn, qp.qid, ex)
        if len(heap) < self.cfg.k_worst:
            heapq.heappush(heap, item)
        elif item[:2] > heap[0][:2]:
            heapq.heapreplace(heap, item)
        # uniform baseline: Algorithm R on the private PRNG
        self._uniform_seen += 1
        if len(self._uniform) < self.cfg.uniform_k:
            self._uniform.append(ex)
        else:
            j = self._rng.randrange(self._uniform_seen)
            if j < self.cfg.uniform_k:
                self._uniform[j] = ex

    # ------------------------------------------------- windowed attribution --
    def publish(self, registry) -> None:
        """Publish the window-since-last-publish stage shares as gauges
        (``attrib.<stage>.share`` + ``attrib.window.queries``) and reset
        the window.  Driven by the router's snapshot ticker, so the
        shares land in the metrics time series and render as Perfetto
        counter tracks."""
        tot = self._win_sojourn
        for name in STAGES:
            share = self._win_stages[name] / tot if tot > 0 else 0.0
            registry.gauge(f"attrib.{name}.share").set(share)
        registry.gauge("attrib.window.queries").set(self._win_n)
        self._win_stages = dict.fromkeys(STAGES, 0.0)
        self._win_sojourn = 0.0
        self._win_n = 0

    # --------------------------------------------------------- reporting --
    def _worst_exemplars(self) -> list[Exemplar]:
        out = [it[2] for heap in self._worst.values() for it in heap]
        out.sort(key=lambda e: (-e.sojourn, e.tenant or "", e.qid))
        return out

    def _events(self) -> tuple[list, list]:
        """(compaction spans, instants) recorded by the tracer."""
        comps = [sp for sp in self._tr.spans if sp.name == "compaction"]
        return comps, list(self._tr.instants)

    @staticmethod
    def _concurrent_events(ex: Exemplar, comps: list,
                           instants: list) -> list[str]:
        """Deterministic labels of events overlapping ``[t0, t1]``."""
        labels = set()
        for sp in comps:
            hi = sp.t1 if sp.t1 is not None else float("inf")
            if sp.t0 <= ex.t1 and hi >= ex.t0:
                a = sp.attrs or {}
                labels.add(f"compaction:{a.get('kind', '?')}"
                           f"@shard{a.get('shard', '?')}")
        for name, t, attrs in instants:
            if ex.t0 <= t <= ex.t1:
                a = attrs or {}
                suffix = f"@shard{a['shard']}" if "shard" in a else ""
                labels.add(f"{name}{suffix}")
        return sorted(labels)

    @staticmethod
    def _mean_shares(exemplars: list[Exemplar]) -> dict[str, float]:
        if not exemplars:
            return dict.fromkeys(STAGES, 0.0)
        acc = dict.fromkeys(STAGES, 0.0)
        for ex in exemplars:
            shares = path_shares(ex)
            for k in STAGES:
                acc[k] += shares[k]
        return {k: round(v / len(exemplars), 6) for k, v in acc.items()}

    def explain_tail(self) -> dict:
        """The deterministic tail-explanation report.

        Clusters the worst exemplars by ``(dominant stage, shard)``,
        names concurrent compaction/fault/scale/alert events, and
        contrasts the tail's stage shares with the uniform baseline.
        """
        worst = self._worst_exemplars()
        comps, instants = self._events()
        clusters: dict[tuple[str, int], list[Exemplar]] = {}
        for ex in worst:
            clusters.setdefault((ex.dominant_stage, ex.shard),
                                []).append(ex)
        rows = []
        for (stage, shard), members in clusters.items():
            events = sorted({lab for ex in members for lab in
                             self._concurrent_events(ex, comps, instants)})
            shares = [path_shares(ex).get(stage, 0.0) for ex in members]
            rows.append(dict(
                stage=stage, shard=shard, n=len(members),
                frac=round(len(members) / len(worst), 4) if worst else 0.0,
                mean_sojourn_s=round(
                    sum(ex.sojourn for ex in members) / len(members), 9),
                max_sojourn_s=round(
                    max(ex.sojourn for ex in members), 9),
                mean_stage_share=round(sum(shares) / len(shares), 4),
                qids=sorted(ex.qid for ex in members),
                events=events))
        rows.sort(key=lambda r: (-r["n"], -r["max_sojourn_s"],
                                 r["stage"], r["shard"]))
        headline = f"p{self.cfg.tail_pct:g}: no completed queries"
        if rows:
            top = rows[0]
            headline = f"p{self.cfg.tail_pct:g} is {top['stage']}"
            if top["shard"] >= 0:
                headline += f" on shard {top['shard']}"
            if top["events"]:
                headline += f" during {', '.join(top['events'])}"
            headline += (f" ({top['n']}/{len(worst)} worst exemplars, "
                         f"worst {top['max_sojourn_s'] * 1e3:.3f} ms)")
        tenants = {}
        for name in sorted(self._worst):
            heap = self._worst[name]
            t_worst = max(heap, key=lambda it: it[:2])[2] if heap else None
            if t_worst is not None:
                tenants[name or "fleet"] = dict(
                    n_exemplars=len(heap),
                    worst_sojourn_s=round(t_worst.sojourn, 9),
                    worst_qid=t_worst.qid,
                    stage=t_worst.dominant_stage, shard=t_worst.shard)
        return dict(
            tail_pct=self.cfg.tail_pct,
            n_queries=self.n_queries,
            n_exemplars=len(worst),
            headline=headline,
            clusters=rows,
            tail_shares=self._mean_shares(worst),
            baseline_shares=self._mean_shares(self._uniform),
            baseline_n=len(self._uniform),
            exemplars=[ex.to_dict() for ex in worst],
            tenants=tenants,
        )

    def render(self, report: dict | None = None) -> str:
        """Human-readable tail explanation (stderr companion of the
        JSON block)."""
        return render_explain(report if report is not None
                              else self.explain_tail())

    # --------------------------------------------------------- forensics --
    def forensics(self, now: float, registry=None) -> dict:
        """Root-cause bundle for a firing alert: the current worst
        exemplars, counter deltas since the previous bundle, and the
        in-flight window's stage shares.  Pure read of observer state."""
        worst = self._worst_exemplars()[:3]
        tot = self._win_sojourn
        shares = {k: round(self._win_stages[k] / tot, 4)
                  for k in STAGES if tot > 0 and self._win_stages[k] > 0}
        deltas: dict[str, float] = {}
        if registry is not None:
            counters = registry.to_dict()["counters"]
            for name in sorted(counters):
                d = counters[name] - self._last_counters.get(name, 0.0)
                if d:
                    deltas[name] = round(d, 6)
            self._last_counters = dict(counters)
        return dict(
            at=round(now, 6),
            window=dict(queries=self._win_n, shares=shares),
            exemplars=[dict(qid=ex.qid, tenant=ex.tenant,
                            sojourn_s=round(ex.sojourn, 9),
                            stage=ex.dominant_stage, shard=ex.shard)
                       for ex in worst],
            counter_deltas=deltas,
        )
