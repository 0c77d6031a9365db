"""The one admission-window driver every stream in the system shares.

Three consumers used to hand-roll the same loop — a window of
``window`` in-service items over a FIFO backlog, with per-arrival
bookkeeping (arrival time, offered-rate counters):

* :class:`repro_torch.serving.engine.QueryEngine` — queries into one engine;
* :class:`repro_torch.fleet.router.FleetRouter` — queries into a shard fleet;
* :class:`repro.ingest.compaction.IngestAgent` — the update stream into
  a delta tier (applies are serialized through a window of 1, so update
  backpressure surfaces as freshness lag, exactly like query
  backpressure surfaces as sojourn).

The helper is purely synchronous — it schedules **no kernel events** of
its own, so folding it into a driver cannot perturb event order: an
``offer`` either starts the item immediately (same virtual instant,
same call stack) or parks it in the backlog; a ``release`` either pops
the backlog (starting the next item at the completing item's timestamp)
or shrinks the in-service count.  That property is what lets the
kernel-refactor golden files (bit-exact closed-loop reports) survive
the unification.

The port's own copy of ``repro.sim.admission``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable

from repro_torch.sim.arrivals import offered_rate
from repro_torch.sim.kernel import Kernel


class AdmissionWindow:
    """Window + FIFO backlog + arrival bookkeeping for one stream.

    ``start(item, t)`` is the driver's service entry point: it is called
    synchronously either from :meth:`offer` (admission at the arrival
    instant) or from :meth:`release` (backlog pop at the completing
    item's virtual time ``t``).
    """

    def __init__(self, kernel: Kernel, window: int,
                 start: Callable[[Any, float], None]):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.kernel = kernel
        self.window = window
        self._start = start
        self.backlog: deque = deque()
        self.in_window = 0
        self.arrive_t: dict[Any, float] = {}
        self.arrivals_total = 0
        self.last_arrival_t = 0.0
        self.exhausted = False        # the arrival process finished

    # --------------------------------------------------------- arrivals --
    def offer(self, item: Any, key: Any = None) -> bool:
        """An arrival at the kernel's current time.  Returns True when the
        item entered service immediately (window had room), False when it
        joined the backlog.  ``key`` (default: the item itself) indexes
        the arrival-time record consumed by :meth:`pop_arrive_t`."""
        t = self.kernel.now
        self.arrivals_total += 1
        self.last_arrival_t = t
        self.arrive_t[item if key is None else key] = t
        if self.in_window < self.window:
            self.in_window += 1
            self._start(item, t)
            return True
        self.backlog.append(item)
        return False

    def pop_arrive_t(self, key: Any) -> float:
        """Claim (and forget) the arrival time recorded for ``key``."""
        return self.arrive_t.pop(key)

    # ------------------------------------------------------ completions --
    def release(self, t: float) -> bool:
        """One in-service item finished at virtual time ``t``: start the
        next backlogged item at exactly ``t``, or shrink the in-service
        count.  Returns True when a backlogged item was started.

        The ``in_window <= window`` guard only matters when ``window``
        was shrunk mid-run (alert-driven tenant deprioritization,
        ``repro_torch.obs.monitor``): in-flight items above the new window
        drain off instead of being replaced from the backlog.  With a
        static window the guard always holds at this point, so the
        behavior (and the golden files) are unchanged."""
        if self.backlog and self.in_window <= self.window:
            self._start(self.backlog.popleft(), t)
            return True
        self.in_window -= 1
        return False

    def mark_exhausted(self) -> None:
        self.exhausted = True

    # ------------------------------------------------------------ state --
    @property
    def idle(self) -> bool:
        return self.in_window == 0 and not self.backlog

    @property
    def drained(self) -> bool:
        """No more arrivals will ever come and nothing is in service."""
        return self.exhausted and self.idle

    @property
    def depth(self) -> int:
        """Items waiting (not yet in service)."""
        return len(self.backlog)

    def offered_qps(self, wall_t: float) -> float:
        return offered_rate(self.arrivals_total, self.last_arrival_t,
                            wall_t)
