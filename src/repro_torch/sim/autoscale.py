"""SLO-driven autoscaling: size the fleet from tail-latency error.

The controller is a kernel :class:`~repro_torch.sim.kernel.Ticker` that wakes
every ``check_interval_s``, estimates p99 arrival-to-completion time over
a sliding window of recent completions and computes the relative SLO
error ``(p99 - slo) / slo``:

* error > ``up_error``   → add one instance to the most loaded shard
  (cold cache — the new replica re-warms from traffic);
* error < ``down_error`` → drain one extra instance from the least
  loaded shard (it stops taking new work, finishes its queue, then stops
  billing).

Scaling acts on serving *instances*, not data placement: storage is
disaggregated, so capacity can follow load while the partition (and with
R >= 2, fault tolerance) stays fixed.  Every decision is recorded, and
the fleet report prices the run in **shards·seconds** — the integral of
active instances over the run, i.e. what a cloud bill would charge.

The port's own copy of ``repro.sim.autoscale``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.kernel import Kernel, Ticker


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    slo_p99_s: float               # the target the controller defends
    check_interval_s: float = 0.1
    window: int = 64               # completions in the p99 estimate
    min_samples: int = 16          # don't act on thin evidence
    up_error: float = 0.0          # scale up when error > this
    down_error: float = -0.5       # scale down when error < this
    cooldown_s: float = 0.25       # min time between actions
    min_instances: int = 1         # per shard
    max_instances: int = 4         # per shard

    def __post_init__(self):
        if self.slo_p99_s <= 0:
            raise ValueError(f"slo_p99_s must be > 0, got {self.slo_p99_s}")
        if self.check_interval_s <= 0:
            raise ValueError("check_interval_s must be > 0")
        if self.down_error >= self.up_error:
            raise ValueError(
                f"down_error ({self.down_error}) must be < up_error "
                f"({self.up_error})")
        if not 1 <= self.min_instances <= self.max_instances:
            raise ValueError(
                f"need 1 <= min_instances <= max_instances, got "
                f"{self.min_instances}..{self.max_instances}")

    def to_dict(self) -> dict:
        return dict(slo_p99_s=self.slo_p99_s,
                    check_interval_s=self.check_interval_s,
                    window=self.window, min_samples=self.min_samples,
                    up_error=self.up_error,
                    down_error=self.down_error, cooldown_s=self.cooldown_s,
                    min_instances=self.min_instances,
                    max_instances=self.max_instances)


class Autoscaler:
    """The controller process.  ``fleet`` is any object exposing
    ``recent_sojourns`` (iterable of floats), ``total_instances``,
    ``scale_up_one()`` and ``scale_down_one()`` (both return a bool)."""

    def __init__(self, cfg: AutoscaleConfig, fleet):
        self.cfg = cfg
        self.fleet = fleet
        self.events: list[dict] = []       # every decision, acted or not
        self._last_action_t = -float("inf")
        self._ticker: Ticker | None = None
        self._kernel: Kernel | None = None

    def start(self, kernel: Kernel) -> None:
        self._kernel = kernel
        self._ticker = kernel.every(self.cfg.check_interval_s, self._check)

    def stop(self) -> None:
        if self._ticker is not None:
            self._ticker.cancel()
            self._ticker = None

    # ------------------------------------------------------------ policy --
    def _check(self, now: float) -> None:
        cfg = self.cfg
        lats = list(self.fleet.recent_sojourns)
        if len(lats) < cfg.min_samples:
            return
        p99 = float(np.percentile(np.asarray(lats), 99.0))
        err = (p99 - cfg.slo_p99_s) / cfg.slo_p99_s
        action = "hold"
        if now - self._last_action_t >= cfg.cooldown_s:
            if err > cfg.up_error:
                if self.fleet.scale_up_one():
                    action = "up"
                    self._last_action_t = now
            elif err < cfg.down_error:
                if self.fleet.scale_down_one():
                    action = "down"
                    self._last_action_t = now
        if action != "hold" or not self.events or \
                self.events[-1]["action"] != "hold":
            self.events.append(dict(
                t=round(now, 6), p99_s=round(p99, 6), error=round(err, 4),
                action=action, instances=self.fleet.total_instances))
        if action != "hold":
            tr = self._kernel.tracer
            if tr.enabled:
                tr.instant(f"autoscale_{action}", now, p99_s=round(p99, 6),
                           error=round(err, 4),
                           instances=self.fleet.total_instances)

    # ------------------------------------------------------- alert hook --
    def alert_scale_up(self, now: float, alert) -> bool:
        """Action-bus subscriber (``repro_torch.obs.monitor``): a fired
        page-severity burn alert forces a scale-up decision *between*
        periodic checks.  The cooldown still applies — the burn windows
        and the controller share one actuation budget, so the two
        policies cannot fight each other into oscillation."""
        if now - self._last_action_t < self.cfg.cooldown_s:
            return False
        if not self.fleet.scale_up_one():
            return False
        self._last_action_t = now
        self.events.append(dict(
            t=round(now, 6), action="up",
            reason=f"alert:{alert.monitor}/{alert.rule}",
            instances=self.fleet.total_instances))
        if self._kernel is not None:
            tr = self._kernel.tracer
            if tr.enabled:
                tr.instant("autoscale_up", now,
                           reason=f"alert:{alert.monitor}/{alert.rule}",
                           instances=self.fleet.total_instances)
        return True
