"""Spans and counters inside the port's index build and device search.

Off by default.  While off, every call the hot path makes costs one test
of a module-level bool: :func:`span` returns one shared null context and
:func:`count` returns at once.  Turn it on around the work to look at::

    from repro_torch import spans
    spans.enable()
    ...                       # build, search
    got = spans.snapshot()    # {"spans": [...], "counters": {...}}
    spans.disable()

A span records its name, the span it opened inside, a batch number (or
``None``) and its start and end on ``time.perf_counter_ns``.  It also opens
a ``torch.profiler.record_function`` of the same name, so a running
profiler holds the span as a ``user_annotation`` on the clock of the
device's operations, and every operation launched inside it can be put
down to it.  The profiler's chrome export does not carry a range's
arguments, so the batch number lives in the snapshot only: in a trace the
``n``-th ``repro_torch.search`` range since the reset is batch ``n``.

A counter adds host ints, or 0-d device tensors into one accumulator on
their device without a synchronize; :func:`snapshot` reads the
accumulators once.  The recorder keeps what one thread does: each thread
has its own stack of open spans, and counters take a lock.

Not the simulator's tracer (:mod:`repro_torch.obs`), which keeps spans in
simulated time.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_spans: list[dict] = []           # in order of start
_host: dict[str, int] = {}
_device: dict[str, torch.Tensor] = {}


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording (what was recorded before stays)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`snapshot`."""
    global _on
    _on = False


def reset() -> None:
    """Drop every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _host.clear()
        _device.clear()


def snapshot() -> dict:
    """``{"spans": [{"name", "parent", "batch", "start_ns", "end_ns"}],
    "counters": {name: int}}``: copies of what was recorded, spans in order
    of start (``parent`` is the index of the enclosing span, or ``None``;
    an open span's ``end_ns`` is ``None``).  Reads each device counter
    once, which waits for the device."""
    with _lock:
        counters = dict(_host)
        for name, acc in _device.items():
            counters[name] = counters.get(name, 0) + int(acc.item())
        return {"spans": [dict(s) for s in _spans], "counters": counters}


class _Span:
    __slots__ = ("name", "batch", "_rf", "_rec")

    def __init__(self, name: str, batch: int | None):
        self.name = name
        self.batch = batch

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._rec = {"name": self.name, "parent": stack[-1] if stack else None,
                     "batch": self.batch, "start_ns": time.perf_counter_ns(),
                     "end_ns": None}
        with _lock:
            stack.append(len(_spans))
            _spans.append(self._rec)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self._rec["end_ns"] = time.perf_counter_ns()
        _local.stack.pop()
        return False


def span(name: str, batch: int | None = None):
    """A context that records the span ``name`` while on; the shared null
    context while off."""
    if not _on:
        return _NULL
    return _Span(name, batch)


def count(name: str, n) -> None:
    """Add ``n`` (a host int or a 0-d tensor) to the counter ``name``."""
    if not _on:
        return
    if isinstance(n, torch.Tensor):
        with _lock:
            acc = _device.get(name)
            if acc is None:
                _device[name] = n.detach().to(torch.int64).clone()
            else:
                acc.add_(n)
        return
    with _lock:
        _host[name] = _host.get(name, 0) + int(n)


def next_batch(name: str) -> int | None:
    """Count one more batch under the host counter ``name`` and return its
    number (0 for the first since the last :func:`reset`); ``None`` while
    off."""
    if not _on:
        return None
    with _lock:
        b = _host.get(name, 0)
        _host[name] = b + 1
    return b
