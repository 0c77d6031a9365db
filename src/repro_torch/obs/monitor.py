"""Live SLO monitors: rolling windows, multi-window burn rates, an
alert log in simulated time, and an alert->action hook bus.

Tracing (PR 6) is post-hoc; this module watches the run *while it is
in flight*.  Each :class:`SLOMonitor` keeps a rolling window of
good/bad observations against one objective (latency-SLO attainment,
recall floor, freshness-lag bound).  The **burn rate** over a window is
the classic SRE quantity::

    burn = bad_fraction(window) / error_budget,   budget = 1 - objective

i.e. burn 1.0 consumes the budget exactly at the sustainable rate; an
alert rule fires when the burn exceeds its threshold over *both* a long
and a short window (the short window makes alerts clear quickly once
the condition ends; the long window rejects blips).  Fired/cleared
alerts are stamped in simulated time in an :class:`AlertLog`.

Actions are **off by default**: the monitor only reads fleet state, and
its ticker — like the tracer's snapshot ticker — only consumes kernel
sequence numbers, shifting all later seqs uniformly, so a monitored run
stays bit-exact with an unmonitored one (enforced against the golden in
``tests/test_monitor_cost.py``).  With ``actions=True`` (CLI
``--alert-actions``) subscribers on the :class:`ActionBus` may
legitimately perturb the run: the autoscaler subscribes to scale out on
a sustained latency burn, and the admission layer subscribes to
deprioritize an over-budget tenant (see ``FleetRouter._execute``).

The port's own copy of ``repro.obs.monitor``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from .trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """One multi-window burn-rate alert rule (SRE-style)."""

    name: str
    long_s: float
    short_s: float
    threshold: float
    severity: str = "page"

    def __post_init__(self) -> None:
        if not (self.long_s > self.short_s > 0):
            raise ValueError(f"rule {self.name!r}: need "
                             f"long_s > short_s > 0, got "
                             f"{self.long_s}/{self.short_s}")
        if self.threshold <= 0:
            raise ValueError(f"rule {self.name!r}: threshold must be "
                             f"> 0, got {self.threshold}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: Windows are in *simulated* seconds; fleet runs last O(seconds), so
#: these are the sim-scale analogue of Google's 1h/5m + 6h/30m pairs
#: (same ~12x long:short ratio between tiers, page fires on a fast
#: hard burn, ticket on a slow sustained one).
DEFAULT_RULES: tuple[BurnRateRule, ...] = (
    BurnRateRule("fast", long_s=0.25, short_s=0.05, threshold=8.0,
                 severity="page"),
    BurnRateRule("slow", long_s=1.0, short_s=0.25, threshold=2.0,
                 severity="ticket"),
)


class SLOMonitor:
    """Rolling good/bad observations against one objective.

    ``observe`` is O(1); window eviction is amortized O(1) because
    events leave the deque exactly once.  ``burn_rate`` scans only the
    events inside the widest rule window (bounded memory regardless of
    run length).
    """

    __slots__ = ("name", "kind", "tenant", "objective", "budget",
                 "rules", "min_samples", "_events", "_horizon",
                 "total", "bad_total", "last_value", "worst_value")

    def __init__(self, name: str, *, objective: float = 0.99,
                 rules: tuple[BurnRateRule, ...] = DEFAULT_RULES,
                 min_samples: int = 8, kind: str = "latency",
                 tenant: str | None = None) -> None:
        if not (0.0 < objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got "
                             f"{objective}")
        self.name = name
        self.kind = kind
        self.tenant = tenant
        self.objective = objective
        self.budget = 1.0 - objective
        self.rules = tuple(rules)
        self.min_samples = min_samples
        self._events: deque = deque()  # (t, bad: bool, value: float)
        self._horizon = max(r.long_s for r in self.rules)
        self.total = 0
        self.bad_total = 0
        self.last_value = 0.0
        self.worst_value = 0.0

    def observe(self, t: float, *, bad: bool, value: float = 0.0) -> None:
        self._events.append((t, bad, value))
        self.total += 1
        self.bad_total += bad
        self.last_value = value
        if value > self.worst_value:
            self.worst_value = value
        self._evict(t)

    def _evict(self, now: float) -> None:
        cutoff = now - self._horizon
        ev = self._events
        while ev and ev[0][0] < cutoff:
            ev.popleft()

    def window_counts(self, now: float, window: float) -> tuple[int, int]:
        """(events, bad events) inside ``[now - window, now]``."""
        cutoff = now - window
        n = bad = 0
        for t, b, _ in reversed(self._events):
            if t < cutoff:
                break
            n += 1
            bad += b
        return n, bad

    def burn_rate(self, now: float, window: float) -> float:
        """Bad fraction over ``window`` divided by the error budget;
        0.0 until ``min_samples`` events have landed in the window (a
        single early failure is not a trend)."""
        n, bad = self.window_counts(now, window)
        if n < self.min_samples:
            return 0.0
        return (bad / n) / self.budget

    def window_quantile(self, now: float, window: float,
                        q: float) -> float:
        """Quantile of observed values in the window (e.g. rolling
        p99 latency); 0.0 on an empty window."""
        cutoff = now - window
        vals = sorted(v for t, _, v in self._events if t >= cutoff)
        if not vals:
            return 0.0
        idx = min(int(q * len(vals)), len(vals) - 1)
        return vals[idx]

    def to_dict(self) -> dict:
        d = dict(name=self.name, kind=self.kind,
                 objective=self.objective, total=self.total,
                 bad_total=self.bad_total,
                 bad_frac=round(self.bad_total / self.total, 6)
                 if self.total else 0.0,
                 worst_value=round(self.worst_value, 6))
        if self.tenant is not None:
            d["tenant"] = self.tenant
        return d


@dataclasses.dataclass
class Alert:
    """One fired (and possibly cleared) alert, in simulated time."""

    monitor: str
    rule: str
    severity: str
    fired_t: float
    tenant: str | None = None
    cleared_t: float | None = None
    peak_burn: float = 0.0
    #: root-cause bundle snapshotted at fire time (exemplars, counter
    #: deltas, stage shares) when an explain collector is attached;
    #: omitted from the dict when absent so existing alert payloads
    #: are unchanged.
    forensics: dict | None = None

    @property
    def active(self) -> bool:
        return self.cleared_t is None

    def to_dict(self) -> dict:
        d = dict(monitor=self.monitor, rule=self.rule,
                 severity=self.severity,
                 fired_t=round(self.fired_t, 6),
                 cleared_t=(round(self.cleared_t, 6)
                            if self.cleared_t is not None else None),
                 peak_burn=round(self.peak_burn, 4))
        if self.tenant is not None:
            d["tenant"] = self.tenant
        if self.forensics is not None:
            d["forensics"] = self.forensics
        return d


class AlertLog:
    """Every fired/cleared alert of a run, stamped in simulated time.

    At most one active alert per (monitor, rule): while the condition
    persists the existing alert's ``peak_burn`` is updated instead of
    stacking duplicates.
    """

    def __init__(self) -> None:
        self.alerts: list[Alert] = []
        self._active: dict[tuple[str, str], Alert] = {}

    def fire(self, now: float, monitor: SLOMonitor, rule: BurnRateRule,
             burn: float) -> Alert | None:
        """Returns the new :class:`Alert` on a fresh fire, or ``None``
        if this (monitor, rule) is already firing (peak updated)."""
        key = (monitor.name, rule.name)
        cur = self._active.get(key)
        if cur is not None:
            if burn > cur.peak_burn:
                cur.peak_burn = burn
            return None
        alert = Alert(monitor=monitor.name, rule=rule.name,
                      severity=rule.severity, fired_t=now,
                      tenant=monitor.tenant, peak_burn=burn)
        self._active[key] = alert
        self.alerts.append(alert)
        return alert

    def clear(self, now: float, monitor: SLOMonitor,
              rule: BurnRateRule) -> Alert | None:
        """Returns the cleared :class:`Alert`, or ``None`` if nothing
        was firing."""
        alert = self._active.pop((monitor.name, rule.name), None)
        if alert is not None:
            alert.cleared_t = now
        return alert

    @property
    def active(self) -> list[Alert]:
        return list(self._active.values())

    def to_dicts(self) -> list[dict]:
        return [a.to_dict() for a in self.alerts]


class ActionBus:
    """Alert -> action hooks.  Disabled unless ``enabled``: with the
    bus off, ``publish`` returns before touching subscribers, so a
    monitored run stays a pure observer and goldens stay bit-exact."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self._subs: list = []

    def subscribe(self, fn) -> None:
        """``fn(event, alert, now)`` with event ``"fired"``/``"cleared"``."""
        self._subs.append(fn)

    def publish(self, event: str, alert: Alert, now: float) -> None:
        if not self.enabled:
            return
        for fn in self._subs:
            fn(event, alert, now)


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Configuration for a fleet's live monitor set.

    ``interval_s`` is the evaluation tick (rules are checked on the
    tick, observations land continuously).  ``gt_ids`` optionally
    enables the live recall monitor: an ``(nq, k)`` int array of
    ground-truth neighbor ids — or, multi-tenant, a mapping of tenant
    name to such an array — compared per completed query.  ``gt_ids``
    is carried data, not config: it is excluded from ``to_dict``.
    """

    interval_s: float = 0.05
    objective: float = 0.99
    rules: tuple[BurnRateRule, ...] = DEFAULT_RULES
    min_samples: int = 8
    freshness_slo_s: float | None = None
    recall_target: float | None = None
    gt_ids: object = dataclasses.field(default=None, repr=False,
                                       compare=False)
    actions: bool = False
    max_instances: int = 4

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if not self.rules:
            raise ValueError("need at least one BurnRateRule")

    def to_dict(self) -> dict:
        return dict(interval_s=self.interval_s,
                    objective=self.objective,
                    rules=[r.to_dict() for r in self.rules],
                    min_samples=self.min_samples,
                    freshness_slo_s=self.freshness_slo_s,
                    recall_target=self.recall_target,
                    actions=self.actions,
                    max_instances=self.max_instances)


class FleetMonitor:
    """The live monitor set for one fleet run (owned by the router).

    The router feeds observations from ``_finish_query`` and the ingest
    apply hook, and calls :meth:`tick` from a kernel ticker.  All state
    here is derived from fleet events; nothing schedules kernel work.
    """

    def __init__(self, cfg: MonitorConfig, tracer=NULL_TRACER) -> None:
        self.cfg = cfg
        self.tracer = tracer
        self.monitors: dict[str, SLOMonitor] = {}
        self.log = AlertLog()
        self.bus = ActionBus(enabled=cfg.actions)
        #: optional ``fn(now) -> dict`` snapshotting forensics (tail
        #: exemplars, counter deltas, stage shares) onto each freshly
        #: fired alert — installed by the router when ``--explain`` is
        #: on; a pure read of observer state, so bit-exactness holds.
        self.forensics_provider = None

    def monitor(self, name: str, *, kind: str = "latency",
                tenant: str | None = None,
                objective: float | None = None) -> SLOMonitor:
        m = self.monitors.get(name)
        if m is None:
            m = SLOMonitor(
                name,
                objective=(self.cfg.objective if objective is None
                           else objective),
                rules=self.cfg.rules, min_samples=self.cfg.min_samples,
                kind=kind, tenant=tenant)
            self.monitors[name] = m
        return m

    # -- observation feeds (called by the router) ---------------------

    def observe_latency(self, t: float, name: str, sojourn_s: float,
                        slo_s: float, tenant: str | None = None) -> None:
        """The latency/goodput monitor: a query is *bad* when its
        sojourn misses the SLO, so ``bad_frac == 1 - goodput`` and the
        burn rate is goodput burn; the rolling window's p99 is exported
        as the ``slo.<name>.p99_s`` gauge when traced."""
        m = self.monitor(name, kind="latency", tenant=tenant)
        m.observe(t, bad=sojourn_s > slo_s, value=sojourn_s)

    def observe_recall(self, t: float, name: str, recall: float,
                       target: float, tenant: str | None = None) -> None:
        m = self.monitor(name, kind="recall", tenant=tenant)
        m.observe(t, bad=recall < target, value=recall)

    def observe_freshness(self, t: float, name: str, lag_s: float,
                          bound_s: float,
                          tenant: str | None = None) -> None:
        m = self.monitor(name, kind="freshness", tenant=tenant)
        m.observe(t, bad=lag_s > bound_s, value=lag_s)

    # -- rule evaluation ----------------------------------------------

    def tick(self, now: float) -> None:
        """Evaluate every rule on every monitor; fire/clear alerts and
        publish them on the bus.  Iteration order is insertion order,
        which is deterministic under the sim's event order."""
        tr = self.tracer
        for m in self.monitors.values():
            for rule in m.rules:
                burn_long = m.burn_rate(now, rule.long_s)
                burn_short = m.burn_rate(now, rule.short_s)
                firing = (burn_long > rule.threshold
                          and burn_short > rule.threshold)
                if firing:
                    alert = self.log.fire(now, m, rule,
                                          max(burn_long, burn_short))
                    if alert is not None:
                        if self.forensics_provider is not None:
                            alert.forensics = self.forensics_provider(now)
                        if tr.enabled:
                            tr.instant("alert_fired", now,
                                       monitor=m.name, rule=rule.name,
                                       severity=rule.severity,
                                       burn=round(burn_long, 3))
                        self.bus.publish("fired", alert, now)
                else:
                    alert = self.log.clear(now, m, rule)
                    if alert is not None:
                        if tr.enabled:
                            tr.instant("alert_cleared", now,
                                       monitor=m.name, rule=rule.name,
                                       severity=rule.severity)
                        self.bus.publish("cleared", alert, now)
            if tr.enabled:
                reg = tr.metrics
                rule0 = m.rules[0]
                reg.gauge(f"slo.{m.name}.burn").set(
                    m.burn_rate(now, rule0.long_s))
                if m.kind == "latency":
                    reg.gauge(f"slo.{m.name}.p99_s").set(
                        m.window_quantile(now, rule0.long_s, 0.99))

    # -- reporting ----------------------------------------------------

    def summary(self) -> dict:
        """The ``alerts`` block attached to the fleet report."""
        return dict(
            config=self.cfg.to_dict(),
            monitors=[m.to_dict() for m in self.monitors.values()],
            fired=self.log.to_dicts(),
        )
