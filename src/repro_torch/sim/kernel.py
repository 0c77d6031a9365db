"""Deterministic discrete-event kernel — the one virtual clock everything
in this repo now runs on.

Before this module existed the codebase carried four hand-rolled
virtual-clock loops (the storage simulator's ``advance_to``, the serving
engine's event heap, the closed-loop driver's drain loop and the fleet
router's min-merge over shard clocks).  They are unified here:

* :class:`EventQueue` — a min-heap of :class:`Event` ordered by
  ``(time, seq)``; the monotonically increasing sequence number makes
  same-time events fire in insertion order, which is what makes every
  simulation in this repo bit-reproducible.
* :class:`Clock` — the virtual time owned by a kernel.  Time only moves
  when an event fires; nothing in the system polls.
* :class:`Kernel` — schedule with :meth:`Kernel.at` / :meth:`Kernel.after`
  (both return a cancellable :class:`Event`), repeat with
  :meth:`Kernel.every` (a :class:`Ticker` — the "process" primitive used
  by monitors and the autoscaler), and draw randomness through
  :meth:`Kernel.rng`, which hands out named, independently seeded streams
  so adding a consumer in one component can never shift the samples seen
  by another.

Everything is plain Python + numpy; a kernel is cheap enough to create
per run.

The port's own copy of ``repro.sim.kernel``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import heapq
import zlib
from typing import Callable

import numpy as np

from repro_torch.obs.trace import NULL_TRACER

#: Slack used when deciding whether an event at ``t`` belongs to
#: ``run_until(t)`` — absorbs last-ulp float error in event arithmetic.
TIME_EPS = 1e-15


class Clock:
    """Virtual time.  Advanced only by the kernel, read by everyone."""

    __slots__ = ("now",)

    def __init__(self, start: float = 0.0):
        self.now = float(start)


class Event:
    """A scheduled callback; cancel via :meth:`Kernel.cancel` (lazy).

    ``span`` is the tracing context the event was scheduled under (set
    by :meth:`Kernel.at` only when a tracer is attached); it costs one
    slot and lets ``repr`` say which span an event belongs to.
    """

    __slots__ = ("t", "seq", "fn", "args", "cancelled", "span")

    def __init__(self, t: float, seq: int, fn: Callable, args: tuple):
        self.t = t
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False
        self.span = None

    def __lt__(self, other: "Event") -> bool:
        return (self.t, self.seq) < (other.t, other.seq)

    def __repr__(self) -> str:
        state = " cancelled" if self.cancelled else ""
        span = ""
        if self.span is not None:
            span = f" span={self.span.name}#{self.span.sid}"
        return f"Event(t={self.t!r}, seq={self.seq}{state}{span})"


class EventQueue:
    """Min-heap of events keyed ``(time, seq)`` with lazy cancellation.

    The seq tie-break is load-bearing: two events scheduled for the same
    virtual instant fire in the order they were scheduled, so causally
    chained same-time work (job done -> pop queue -> submit next) keeps
    its program order and runs are deterministic.
    """

    def __init__(self):
        self._heap: list[Event] = []
        self._seq = 0
        self._live = 0

    def push(self, t: float, fn: Callable, args: tuple = ()) -> Event:
        ev = Event(t, self._seq, fn, args)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        self._live += 1
        return ev

    def cancel(self, ev: Event) -> None:
        if not ev.cancelled:
            ev.cancelled = True
            self._live -= 1

    def peek(self) -> Event | None:
        """Earliest live event without removing it."""
        heap = self._heap
        while heap and heap[0].cancelled:
            heapq.heappop(heap)
        return heap[0] if heap else None

    def pop(self) -> Event | None:
        ev = self.peek()
        if ev is not None:
            heapq.heappop(self._heap)
            self._live -= 1
        return ev

    def __len__(self) -> int:
        return self._live

    def __bool__(self) -> bool:
        return self._live > 0


class Ticker:
    """A repeating timer (the kernel's "process" for periodic work).

    Fires ``fn(now)`` every ``interval`` until cancelled.  Tickers keep
    the kernel busy forever, so whoever starts one owns stopping it
    (e.g. the fleet router cancels its monitor once the workload drains).
    """

    def __init__(self, kernel: "Kernel", interval: float, fn: Callable,
                 start: float | None = None):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.kernel = kernel
        self.interval = interval
        self.fn = fn
        self.cancelled = False
        first = kernel.now + interval if start is None else start
        self._ev = kernel.at(first, self._fire)

    def _fire(self) -> None:
        if self.cancelled:
            return
        self.fn(self.kernel.now)
        if not self.cancelled:                    # fn may cancel us
            self._ev = self.kernel.at(self.kernel.now + self.interval,
                                      self._fire)

    def cancel(self) -> None:
        if not self.cancelled:
            self.cancelled = True
            self.kernel.cancel(self._ev)


class Kernel:
    """The discrete-event kernel: one clock, one queue, named RNG streams.

    Components hold a reference to the kernel, schedule their own events
    and never see each other's: causality is purely through event times
    and the (time, seq) total order.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.clock = Clock()
        self.queue = EventQueue()
        self._rngs: dict[str, np.random.Generator] = {}
        self._name_counts: dict[str, int] = {}
        self.events_fired = 0
        # Tracing context.  The tracer observes and never perturbs: it
        # schedules no events and draws no RNG, so attaching one leaves
        # the (time, seq) order — and therefore every result — bit-exact.
        self.tracer = NULL_TRACER
        self.current_span = None

    # ------------------------------------------------------------ clock --
    @property
    def now(self) -> float:
        return self.clock.now

    # ------------------------------------------------------- scheduling --
    def at(self, t: float, fn: Callable, *args) -> Event:
        """Schedule ``fn(*args)`` at virtual time ``t`` (>= now)."""
        if t < self.clock.now - TIME_EPS:
            raise ValueError(
                f"cannot schedule at t={t!r} before now={self.clock.now!r}")
        ev = self.queue.push(max(t, self.clock.now), fn, args)
        if self.tracer.enabled:
            ev.span = self.current_span
        return ev

    def after(self, delay: float, fn: Callable, *args) -> Event:
        return self.at(self.clock.now + delay, fn, *args)

    def every(self, interval: float, fn: Callable,
              start: float | None = None) -> Ticker:
        return Ticker(self, interval, fn, start=start)

    def cancel(self, ev: Event) -> None:
        self.queue.cancel(ev)

    # ------------------------------------------------------------- rng ---
    def rng(self, name: str, seed: int | None = None) -> np.random.Generator:
        """The named RNG stream, created on first use.

        Without an explicit ``seed`` the stream is derived from
        ``(kernel seed, crc32(name))`` so distinct components draw from
        independent, reproducible streams.  An explicit ``seed`` pins the
        stream to ``default_rng(seed)`` (used where a pre-kernel sample
        sequence must be preserved exactly).
        """
        if name not in self._rngs:
            if seed is None:
                self._rngs[name] = np.random.default_rng(
                    (self.seed, zlib.crc32(name.encode())))
            else:
                self._rngs[name] = np.random.default_rng(seed)
        return self._rngs[name]

    def unique_name(self, prefix: str) -> str:
        """Deterministic per-kernel unique names (RNG stream keys)."""
        i = self._name_counts.get(prefix, 0)
        self._name_counts[prefix] = i + 1
        return f"{prefix}#{i}"

    # ------------------------------------------------------------- run ---
    def peek(self) -> float | None:
        """Time of the next live event, or None when idle."""
        ev = self.queue.peek()
        return ev.t if ev is not None else None

    def step(self) -> bool:
        """Fire the single earliest event; False when the queue is idle."""
        ev = self.queue.pop()
        if ev is None:
            return False
        if ev.t > self.clock.now:
            self.clock.now = ev.t
        self.events_fired += 1
        if self.tracer.enabled:
            # Restore the scheduling span around the callback so spans
            # opened without an explicit parent nest across event hops.
            prev = self.current_span
            self.current_span = ev.span
            try:
                ev.fn(*ev.args)
            finally:
                self.current_span = prev
        else:
            ev.fn(*ev.args)
        return True

    def run(self, max_events: int | None = None) -> int:
        """Fire events until the queue drains; returns events fired.

        ``max_events`` is a runaway guard: exceeding it raises instead of
        hanging (a scheduling bug in any component would otherwise stall
        the whole simulation).
        """
        n = 0
        while self.step():
            n += 1
            if max_events is not None and n >= max_events:
                raise RuntimeError(
                    f"kernel fired {n} events without draining "
                    f"(suspected event loop; next at t={self.peek()!r})")
        return n

    def run_until(self, t: float) -> int:
        """Fire every event with timestamp <= ``t``; clock ends at ``t``."""
        n = 0
        while True:
            ev = self.queue.peek()
            if ev is None or ev.t > t + TIME_EPS:
                break
            self.step()
            n += 1
        if t > self.clock.now:
            self.clock.now = t
        return n

    @property
    def busy(self) -> bool:
        return bool(self.queue)
