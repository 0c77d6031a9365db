"""Chrome-trace / Perfetto JSON export and deterministic flame summary.

The export maps a run onto trace-viewer concepts:

* the **router** process (pid 1) has one thread lane per tenant; each
  query's span tree renders there as nested *async* slices;
* each **shard** gets its own process (pid 100 + shard id) with one
  thread lane per instance, carrying the ``shard_job`` spans and their
  queue/fetch/compute legs;
* hedges draw **flow arrows** from the round that launched them to the
  wasted attempt; sheds, faults, recoveries and autoscale decisions are
  **instant** events; registry snapshots become **counter** tracks
  (``cost.*`` dollar and ``slo.*`` burn-rate gauges included, when a
  price book / monitor is attached);
* alert lifecycle events (``alert_fired`` / ``alert_cleared`` and the
  ``alert_action_*`` actuations) get their own ``alert`` category so
  they can be isolated in the viewer's filter box.

All slices are emitted as async begin/end pairs (``ph: "b"/"e"``) keyed
by the local tree root, because many queries overlap on one lane and
synchronous ``X`` slices would force the viewer to mis-nest them.

Load the output at https://ui.perfetto.dev (or chrome://tracing).
Timestamps are simulated seconds scaled to microseconds.

The export is **byte-deterministic**: events follow span/instant/flow
recording order (itself deterministic under the simulator's
``(time, seq)`` discipline), counter rows and lane metadata are
explicitly sorted, and the JSON is written with pinned separators —
two identical runs produce identical trace files, so trace artifacts
can be diffed byte-for-byte across runs and CI uploads.

The port's own copy of ``repro.obs.export``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import json

__all__ = ["chrome_trace", "write_chrome_trace", "flame_summary"]

_US = 1e6            # simulated seconds -> trace microseconds

_ROUTER_PID = 1
_SHARD_PID0 = 100


def _jsonable(attrs: dict) -> dict:
    """Coerce numpy scalars (query ids, byte counts) to plain JSON types."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        elif hasattr(v, "item"):            # numpy scalar
            out[k] = v.item()
        else:
            out[k] = str(v)
    return out


def _lane(span, attrs, roots) -> tuple[int, int]:
    """(pid, tid) for a span: shard process for shard work, else the
    router process with one lane per tenant (tid from root attrs)."""
    if span.name in ("shard_job", "compaction", "batch_compute"):
        shard = attrs.get("shard", 0)
        return _SHARD_PID0 + int(shard), int(attrs.get("instance", 0))
    root_attrs = roots.get(span.sid, {})
    return _ROUTER_PID, int(root_attrs.get("tid", 0))


def _local_roots(tracer) -> dict[int, dict]:
    """sid -> attrs of the span's local tree root (its topmost parent)."""
    out: dict[int, dict] = {}
    for sp in tracer.spans:             # parents precede children
        if sp.parent is None:
            out[sp.sid] = sp.attrs or {}
        else:
            out[sp.sid] = out[sp.parent]
    return out


def chrome_trace(tracer) -> dict:
    """Build the Chrome-trace JSON object for one traced run."""
    roots = _local_roots(tracer)
    events: list[dict] = []
    lanes: dict[tuple[int, int], None] = {}

    for sp in tracer.spans:
        if sp.t1 is None:
            continue
        attrs = dict(sp.attrs or {})
        pid, tid = _lane(sp, attrs, roots)
        lanes.setdefault((pid, tid))
        # async id = the local tree root, so one query's slices nest
        # together while concurrent queries on the same lane stay apart
        aid = sp.sid
        p = sp.parent
        while p is not None:
            aid = p
            p = tracer.spans[p].parent
        common = dict(cat="sim", name=sp.name, pid=pid, tid=tid,
                      id=aid)
        events.append(dict(common, ph="b", ts=sp.t0 * _US,
                           args=_jsonable(attrs)))
        events.append(dict(common, ph="e", ts=sp.t1 * _US))

    for name, t, attrs in tracer.instants:
        cat = "alert" if name.startswith("alert_") else "sim"
        events.append(dict(ph="i", cat=cat, name=name, ts=t * _US,
                           pid=_ROUTER_PID, tid=0, s="g",
                           args=_jsonable(attrs or {})))

    for i, (src, dst) in enumerate(tracer.flows):
        a, b = tracer.spans[src], tracer.spans[dst]
        pa, ta = _lane(a, dict(a.attrs or {}), roots)
        pb, tb = _lane(b, dict(b.attrs or {}), roots)
        events.append(dict(ph="s", cat="hedge", name="hedge", id=i,
                           ts=a.t0 * _US, pid=pa, tid=ta))
        events.append(dict(ph="f", cat="hedge", name="hedge", id=i,
                           ts=b.t0 * _US, pid=pb, tid=tb, bp="e"))

    if tracer.metrics is not None:
        for t, row in tracer.metrics.series:
            for name, value in sorted(row.items()):
                events.append(dict(ph="C", cat="metrics", name=name,
                                   ts=t * _US, pid=_ROUTER_PID, tid=0,
                                   args={"value": value}))

    meta: list[dict] = []
    for pid in sorted({p for p, _ in lanes} | {_ROUTER_PID}):
        pname = "router" if pid == _ROUTER_PID \
            else f"shard {pid - _SHARD_PID0}"
        meta.append(dict(ph="M", name="process_name", pid=pid, tid=0,
                         args={"name": pname}))
        for p, t in sorted(lanes):
            if p != pid:
                continue
            tname = f"tenant {t}" if pid == _ROUTER_PID \
                else f"instance {t}"
            meta.append(dict(ph="M", name="thread_name", pid=pid,
                             tid=t, args={"name": tname}))

    return dict(traceEvents=meta + events, displayTimeUnit="ms")


def write_chrome_trace(path, tracer) -> None:
    # pinned separators + insertion-ordered dicts => byte-identical
    # files for identical runs (asserted in tests/test_obs.py)
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f, separators=(",", ":"))


def flame_summary(tracer, top: int = 20) -> str:
    """Deterministic text flame summary: per span name, the count,
    total (inclusive) time and self (exclusive-of-children) time."""
    total: dict[str, float] = {}
    count: dict[str, int] = {}
    child_time: dict[int, float] = {}
    for sp in tracer.spans:
        if sp.t1 is None:
            continue
        d = sp.t1 - sp.t0
        total[sp.name] = total.get(sp.name, 0.0) + d
        count[sp.name] = count.get(sp.name, 0) + 1
        if sp.parent is not None:
            child_time[sp.parent] = child_time.get(sp.parent, 0.0) + d
    self_t: dict[str, float] = {}
    for sp in tracer.spans:
        if sp.t1 is None:
            continue
        d = (sp.t1 - sp.t0) - child_time.get(sp.sid, 0.0)
        self_t[sp.name] = self_t.get(sp.name, 0.0) + max(0.0, d)
    rows = sorted(total, key=lambda n: (-total[n], n))[:top]
    lines = [f"{'span':<16}{'count':>8}{'total':>12}{'self':>12}"]
    for name in rows:
        lines.append(f"{name:<16}{count[name]:>8}"
                     f"{total[name] * 1e3:>10.3f}ms"
                     f"{self_t[name] * 1e3:>10.3f}ms")
    return "\n".join(lines)
