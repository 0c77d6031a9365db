"""Discrete-event simulator of remote-storage I/O (paper §2.2 mechanisms).

Three resources gate every fetch batch:

1. **GET-rate limiter** (token bucket at ``get_qps_limit``): every request
   in a batch consumes a token — DiskANN's W batched requests still count
   as W IOs (paper footnote 8).  Under saturation this produces exactly
   the Fig 10d / Fig 19e IOPS ceiling.
2. **TTFB**: one lognormal sample per batch (requests in a batch are
   issued concurrently, so their first bytes arrive together); this gives
   graph search its ``rt × TTFB`` latency floor (§2.3.2).
3. **Shared bandwidth pipe** (processor sharing): all in-flight batch
   transfers progress at ``bandwidth / n_active`` — I/O congestion rises
   with recall × concurrency exactly as in Fig 9.

The simulator is a component on the shared :class:`repro_torch.sim.Kernel`: a
batch's transfer-start and transfer-completion are kernel events, and the
processor-sharing pipe keeps exactly one completion event scheduled —
rescheduled whenever pipe membership changes.  Passing no kernel gives the
sim a private one (standalone use in unit tests and notebooks).

Batches are the unit of transfer, requests the unit of rate limiting;
everything is deterministic for a given seed.

The port's own copy of ``repro.storage.simulator``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.sim.kernel import Event, Kernel
from repro_torch.storage.spec import StorageSpec


@dataclasses.dataclass
class BatchTicket:
    batch_id: int
    submit_t: float
    start_t: float = 0.0         # transfer start (post admission + TTFB)
    done_t: float = 0.0
    nbytes: int = 0
    n_requests: int = 0


class _SharedPipe:
    """Exact processor-sharing pipe: active transfers share bandwidth."""

    def __init__(self, bandwidth_Bps: float):
        self.bw = bandwidth_Bps
        self.active: dict[int, float] = {}     # id -> remaining bytes
        self.t = 0.0

    def _advance(self, t: float) -> None:
        if t <= self.t:
            return
        if self.active:
            rate = self.bw / len(self.active)
            dt = t - self.t
            for k in self.active:
                self.active[k] -= rate * dt
        self.t = t

    def add(self, t: float, tid: int, nbytes: float) -> None:
        self._advance(t)
        self.active[tid] = max(float(nbytes), 1.0)

    def next_completion(self) -> tuple[float, int] | None:
        """(time, id) of the earliest finishing transfer, else None."""
        if not self.active:
            return None
        rate = self.bw / len(self.active)
        tid, rem = min(self.active.items(), key=lambda kv: kv[1])
        return self.t + max(rem, 0.0) / rate, tid

    def complete(self, t: float, tid: int) -> None:
        self._advance(t)
        self.active.pop(tid, None)

    def remove(self, t: float, tid: int) -> None:
        """Drop a transfer without completing it (fault abort)."""
        self._advance(t)
        self.active.pop(tid, None)


class StorageSim:
    """Event-driven storage backend on a (possibly shared) kernel.

    ``submit_batch(nbytes, n_requests, on_done)`` admits a batch at the
    kernel's current virtual time; ``on_done(ticket)`` fires at the
    batch's completion event.  Without a callback, completed tickets
    accumulate and :meth:`drain` (standalone kernels only) runs the clock
    forward and returns them.
    """

    def __init__(self, spec: StorageSpec, kernel: Kernel | None = None,
                 *, seed: int = 0):
        self.spec = spec
        self.kernel = kernel if kernel is not None else Kernel(seed=seed)
        self.pipe = _SharedPipe(spec.bandwidth_Bps)
        self.rng = self.kernel.rng(self.kernel.unique_name("storage"),
                                   seed=seed)
        self._bucket_vt = 0.0                  # IOPS token-bucket clock
        self._next_id = 0
        self._tickets: dict[int, BatchTicket] = {}
        self._on_done: dict[int, Callable[[BatchTicket], None] | None] = {}
        self._start_evs: dict[int, Event] = {}
        #: per-batch token-bucket charge (seconds of bucket time), kept
        #: until transfer start so abort_all can refund batches whose
        #: admission tokens were charged but never used
        self._bucket_charge: dict[int, float] = {}
        self._completion_ev: Event | None = None
        self.completed: list[BatchTicket] = []   # callback-less tickets
        # aggregates (puts are also included in the totals: a PUT is
        # admitted and transferred exactly like a GET, it just bills
        # differently — repro_torch.obs.cost meters the split)
        self.total_bytes = 0
        self.total_requests = 0
        self.total_put_bytes = 0
        self.total_put_requests = 0

    # ----------------------------------------------------------- submit --
    def sample_ttfb(self) -> float:
        s = self.spec.ttfb_sigma
        mu = math.log(self.spec.ttfb_p50_s)
        return float(np.exp(self.rng.normal(mu, s)))

    def submit_batch(self, nbytes: int, n_requests: int,
                     on_done: Callable[[BatchTicket], None] | None = None,
                     *, put: bool = False) -> BatchTicket:
        """Admit a dependency-free batch of GETs at the current time.

        ``put=True`` marks the batch as object-store writes (compaction
        flushes): identical simulation behavior, but metered separately
        so the cost model can price PUT requests at their (much higher)
        rate."""
        t = self.kernel.now
        tid = self._next_id
        self._next_id += 1
        # 1) GET-rate admission: n tokens at get_qps_limit
        charge = n_requests / self.spec.get_qps_limit
        self._bucket_vt = max(self._bucket_vt, t) + charge
        self._bucket_charge[tid] = charge
        admit_t = max(t, self._bucket_vt)
        # 2) TTFB (one overlapped sample per batch)
        start_t = admit_t + self.sample_ttfb() + self.spec.min_latency_s
        ticket = BatchTicket(batch_id=tid, submit_t=t, start_t=start_t,
                             nbytes=nbytes, n_requests=n_requests)
        self._tickets[tid] = ticket
        self._on_done[tid] = on_done
        self._start_evs[tid] = self.kernel.at(start_t, self._start, tid)
        self.total_bytes += nbytes
        self.total_requests += n_requests
        if put:
            self.total_put_bytes += nbytes
            self.total_put_requests += n_requests
        return ticket

    # ------------------------------------------------------------ events --
    def _start(self, tid: int) -> None:
        """Transfer-start event: the batch joins the shared pipe."""
        self._start_evs.pop(tid, None)
        self._bucket_charge.pop(tid, None)     # tokens are spent now
        self.pipe.add(self.kernel.now, tid, self._tickets[tid].nbytes)
        self._reschedule_completion()

    def _reschedule_completion(self) -> None:
        """Keep exactly one completion event: pipe membership changed, so
        the earliest finisher (and its finish time) may have too."""
        if self._completion_ev is not None:
            self.kernel.cancel(self._completion_ev)
            self._completion_ev = None
        nc = self.pipe.next_completion()
        if nc is not None:
            self._completion_ev = self.kernel.at(
                max(nc[0], self.kernel.now), self._complete, nc[1])

    def _complete(self, tid: int) -> None:
        self._completion_ev = None
        t = self.kernel.now
        self.pipe.complete(t, tid)
        tk = self._tickets.pop(tid)
        tk.done_t = t
        cb = self._on_done.pop(tid)
        self._reschedule_completion()
        if cb is not None:
            cb(tk)
        else:
            self.completed.append(tk)

    # ------------------------------------------------------------ faults --
    def abort_all(self) -> None:
        """Drop every queued and in-flight transfer (the node died).

        Waiters are NOT notified — the failing server reports aborted
        jobs; storage just forgets the work.

        GET-rate tokens charged to batches that never reached transfer
        start are refunded: their admission slots were reserved but the
        requests never issued, so leaving ``_bucket_vt`` advanced would
        make post-fault traffic queue behind phantom I/O.
        """
        for tid, ev in self._start_evs.items():
            self.kernel.cancel(ev)
            self._bucket_vt -= self._bucket_charge.pop(tid, 0.0)
        self._bucket_vt = max(self._bucket_vt, self.kernel.now)
        self._start_evs.clear()
        self._bucket_charge.clear()
        for tid in list(self.pipe.active):
            self.pipe.remove(self.kernel.now, tid)
        if self._completion_ev is not None:
            self.kernel.cancel(self._completion_ev)
            self._completion_ev = None
        self._tickets.clear()
        self._on_done.clear()

    # ----------------------------------------------------------- helpers --
    @property
    def busy(self) -> bool:
        return bool(self._start_evs or self.pipe.active)

    def drain(self) -> list[BatchTicket]:
        """Standalone helper: run the (private) kernel dry and return the
        tickets completed without a callback since the last drain."""
        self.kernel.run()
        out = self.completed
        self.completed = []
        return out
