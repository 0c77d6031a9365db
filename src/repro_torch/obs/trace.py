"""Query-level tracing over the sim kernel: spans in *simulated* time.

A :class:`Span` is an interval of virtual time with a name, a parent
link and free-form attributes (shard id, tenant, cache hit/miss, bytes
fetched).  A :class:`Tracer` collects spans, instant events and flow
arrows for one run; :mod:`repro_torch.obs.export` turns them into a
Chrome-trace/Perfetto JSON file and :mod:`repro_torch.obs.critical_path`
extracts per-query critical paths and attribution reports from them.

Two properties are load-bearing:

* **Zero cost when disabled.**  Every instrumentation site in the
  serving stack guards on ``tracer.enabled``; the module-level
  :data:`NULL_TRACER` (a :class:`NullTracer`) is the kernel default, so
  an untraced run pays one attribute read + bool test per site and
  allocates nothing.
* **Observe, never perturb.**  A tracer records what the kernel already
  did: it schedules no events, draws no RNG, and never feeds a value
  back into the simulation.  A traced run is therefore bit-exact
  against the untraced goldens (the metrics-snapshot ticker the fleet
  router starts when tracing is on only *reads* state — see
  ``FleetRouter._obs_snapshot``).

Span-tree conventions (see ``docs/observability.md`` for the full
attribute table):

``query`` roots (one per query, ``t0`` = arrival) own ``admission``,
``route``, per-round ``round`` and final ``merge`` children; each
``round`` owns the ``shard_job`` spans whose completions the gather
consumed; each ``shard_job`` owns its ``queue`` wait and its
``storage_fetch`` / ``cache_fetch`` / ``compute`` legs.  Work the query
did not wait for — hedge-race losers, jobs aborted by a shard death —
is recorded as *parentless* spans with ``wasted=True`` (plus a flow
arrow from the round that launched it), so the tree invariant "child
interval inside parent interval" holds for every parented span.

The port's own copy of ``repro.obs.trace``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

from typing import Any

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER",
           "emit_job_spans"]


class Span:
    """One interval of simulated time in a trace."""

    __slots__ = ("sid", "name", "t0", "t1", "parent", "attrs")

    def __init__(self, sid: int, name: str, t0: float,
                 parent: int | None = None,
                 attrs: dict[str, Any] | None = None):
        self.sid = sid
        self.name = name
        self.t0 = t0
        self.t1: float | None = None
        self.parent = parent             # parent span's sid
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        end = "open" if self.t1 is None else f"{self.t1:.6f}"
        return (f"Span({self.name}#{self.sid} [{self.t0:.6f}, {end}]"
                f"{'' if self.parent is None else f' <- #{self.parent}'})")


class Tracer:
    """Span/event/flow collector for one simulation run.

    Attach to a kernel with :meth:`attach` (done by the serving drivers
    when handed a tracer); scheduling then records the *current span*
    into every event so span context survives event-callback hops, and
    ``Event.__repr__`` shows which span scheduled it.
    """

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []
        self.instants: list[tuple[str, float, dict | None]] = []
        self.flows: list[tuple[int, int]] = []    # (src sid, dst sid)
        self._kernel = None
        from repro_torch.obs.metrics import MetricsRegistry
        self.metrics = MetricsRegistry()

    # ------------------------------------------------------------ wiring --
    def attach(self, kernel) -> "Tracer":
        """Register on ``kernel`` (sets ``kernel.tracer``); events then
        carry the span that was current when they were scheduled."""
        self._kernel = kernel
        kernel.tracer = self
        return self

    @property
    def current(self) -> Span | None:
        """The span of the event currently firing (kernel context)."""
        return self._kernel.current_span if self._kernel is not None \
            else None

    # ------------------------------------------------------------- spans --
    def begin(self, name: str, t0: float, parent: Span | None = None,
              **attrs) -> Span:
        """Open a span; close with :meth:`end`.  With no explicit
        ``parent`` the kernel's current span (if any) is the parent."""
        if parent is None:
            parent = self.current
        sp = Span(len(self.spans), name, t0,
                  parent=parent.sid if parent is not None else None,
                  attrs=attrs or None)
        self.spans.append(sp)
        return sp

    def end(self, span: Span, t1: float) -> Span:
        span.t1 = t1
        return span

    def record(self, name: str, t0: float, t1: float,
               parent: Span | None = None, **attrs) -> Span:
        """Record a complete span (both endpoints already known)."""
        sp = self.begin(name, t0, parent=parent, **attrs)
        sp.t1 = t1
        return sp

    # -------------------------------------------------- events / arrows --
    def instant(self, name: str, t: float, **attrs) -> None:
        """A point event (shed, shard fail/recover, autoscale decision)."""
        self.instants.append((name, t, attrs or None))

    def flow(self, src: Span, dst: Span) -> None:
        """An async arrow (e.g. a hedge forking off its round)."""
        self.flows.append((src.sid, dst.sid))

    # ------------------------------------------------------------- intro --
    def children_index(self) -> dict[int | None, list[Span]]:
        """sid -> children (in record order); key None = root spans."""
        out: dict[int | None, list[Span]] = {}
        for sp in self.spans:
            out.setdefault(sp.parent, []).append(sp)
        return out

    def __len__(self) -> int:
        return len(self.spans)


class NullTracer:
    """The disabled tracer: every operation is a no-op.

    Call sites guard on :attr:`enabled`, so in an untraced run the only
    cost tracing adds is that boolean test.
    """

    enabled = False
    metrics = None
    spans: list = []
    instants: list = []
    flows: list = []
    current = None

    def attach(self, kernel) -> "NullTracer":
        kernel.tracer = self
        return self

    def begin(self, name, t0, parent=None, **attrs):
        return None

    def end(self, span, t1):
        return None

    def record(self, name, t0, t1, parent=None, **attrs):
        return None

    def instant(self, name, t, **attrs):
        return None

    def flow(self, src, dst):
        return None


#: The shared disabled tracer every kernel starts with.
NULL_TRACER = NullTracer()


def emit_job_spans(tr: Tracer, parent: Span | None, submit_t: float,
                   job) -> None:
    """Synthesize one shard job's sub-spans from its completion record.

    ``job`` is a :class:`repro_torch.serving.engine.JobRecord`; its
    ``start_t``/``end_t`` and per-batch :class:`BatchTrace` rows carry
    enough to tile the interval exactly: queue wait (submit -> engine
    start), alternating ``compute`` and fetch legs, final compute.
    Fetch legs are ``storage_fetch`` when any request missed to remote
    storage, ``nvme_fetch`` when the misses were served entirely from
    the local NVMe tier, and ``cache_fetch`` when the whole batch was
    served from the DRAM cache.  A mixed round (some misses NVMe, some
    remote) is bounded by the remote fetch, so it stays a
    ``storage_fetch`` leg and carries the NVMe split in its attrs.  On a
    kernel backend the job's ``coalesce`` intervals (waits in the batch
    window) are tiled out of the compute gaps as ``batching`` legs; with
    no coalescing the emitted spans are identical to before the backend
    existed.
    """
    coalesce = getattr(job, "coalesce", None) or ()

    def compute_legs(lo: float, hi: float) -> None:
        cur = lo
        for iv in coalesce:
            e, f = iv[0], iv[1]
            if f is None or f <= cur or e >= hi:
                continue
            e, f = max(e, cur), min(f, hi)
            if e > cur:
                tr.record("compute", cur, e, parent=parent)
            tr.record("batching", e, f, parent=parent)
            cur = f
        if hi > cur:
            tr.record("compute", cur, hi, parent=parent)

    if job.start_t > submit_t:
        tr.record("queue", submit_t, job.start_t, parent=parent)
    cursor = job.start_t
    for b in job.batches:
        if b.submit_t > cursor:
            compute_legs(cursor, b.submit_t)
        n_nvme = getattr(b, "n_nvme", 0)
        if b.n_requests > 0:
            name = "storage_fetch"
        elif n_nvme > 0:
            name = "nvme_fetch"
        else:
            name = "cache_fetch"
        attrs = dict(requests=b.n_requests, hits=b.n_hits,
                     bytes_storage=b.nbytes_storage, bytes=b.nbytes_total)
        if n_nvme > 0:
            # only tiered runs grow the attr set — flat spans stay
            # byte-identical to the pre-tier tracer output
            attrs["nvme_requests"] = n_nvme
            attrs["bytes_nvme"] = getattr(b, "nbytes_nvme", 0)
        tr.record(name, b.submit_t, b.done_t, parent=parent, **attrs)
        cursor = b.done_t
    if job.end_t > cursor:
        compute_legs(cursor, job.end_t)
