"""Update streams: the write side of a read-write workload.

An :class:`UpdateStream` is an explicit, pre-materialised sequence of
timestamped insert/delete operations — the write analogue of
:class:`repro_torch.sim.arrivals.Trace`.  Pre-materialising (rather than
drawing from a kernel RNG stream at run time) keeps the *query* side of
a mixed run byte-identical to the pure-query run: the stream is fixed
before the kernel exists, so a zero-write run schedules zero events and
reproduces the closed-loop golden reports bit-exactly.

:func:`synth_updates` builds a production-style stream from the dataset:
Poisson arrival times at ``rate_qps``; inserts are perturbed points from
the data manifold (new ids above the sealed range), deletes pick live
ids uniformly (never an id already deleted, optionally never a protected
id such as a graph medoid).  :func:`churned_corpus` materialises the
corpus the stream leaves behind, for ground-truth recall under churn.

The port's own copy of ``repro.ingest.stream``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.sim.kernel import Kernel


@dataclasses.dataclass(frozen=True)
class UpdateOp:
    """One timestamped update."""

    t: float
    seq: int
    kind: str                  # "insert" | "delete"
    id: int
    vec: np.ndarray | None = None     # insert payload


class UpdateStream:
    """An ordered sequence of updates, schedulable on a kernel."""

    def __init__(self, ops: list[UpdateOp]):
        if any(b.t < a.t for a, b in zip(ops, ops[1:])):
            raise ValueError("update times must be non-decreasing")
        self.ops = list(ops)

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def n_inserts(self) -> int:
        return sum(1 for op in self.ops if op.kind == "insert")

    @property
    def n_deletes(self) -> int:
        return len(self.ops) - self.n_inserts

    @property
    def bytes_ingested(self) -> int:
        """Payload bytes the stream writes (inserted vectors + 8B ids)."""
        return sum(op.vec.nbytes + 8 for op in self.ops
                   if op.vec is not None)

    def start(self, kernel: Kernel,
              deliver: Callable[[UpdateOp], None]) -> None:
        """Schedule every op at its timestamp.  An empty stream schedules
        nothing — the zero-write invariant the rw scenario relies on."""
        for op in self.ops:
            kernel.at(op.t, deliver, op)

    def to_dict(self) -> dict:
        return dict(n_updates=len(self.ops), n_inserts=self.n_inserts,
                    n_deletes=self.n_deletes,
                    bytes_ingested=self.bytes_ingested)


def synth_updates(data: np.ndarray, rate_qps: float, n_updates: int,
                  delete_frac: float = 0.2, seed: int = 0,
                  protected: frozenset | None = None,
                  jitter: float = 0.05) -> UpdateStream:
    """A synthetic churn stream against ``data`` (the sealed corpus).

    Inserts are existing points plus small manifold-scale noise — the
    recommender/RAG regime where new vectors land near old ones, so they
    genuinely compete for top-k slots.  New ids start at ``len(data)``.
    Deletes draw uniformly from the live set (sealed ∪ inserted − already
    deleted), excluding ``protected`` ids.
    """
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    if not 0.0 <= delete_frac < 1.0:
        raise ValueError(f"delete_frac must be in [0, 1), got "
                         f"{delete_frac}")
    rng = np.random.default_rng((seed, 0x1463E57))
    n = len(data)
    times = np.cumsum(rng.exponential(1.0 / rate_qps, size=n_updates))
    scale = float(np.std(data.astype(np.float64))) * jitter
    protected = protected or frozenset()
    live = [i for i in range(n) if i not in protected]
    live_set = set(live)
    next_id = n
    ops: list[UpdateOp] = []
    for s in range(n_updates):
        is_delete = (rng.uniform() < delete_frac) and len(live) > 1
        if is_delete:
            # lazily compact the live list of stale (deleted) ids
            while True:
                victim = live[int(rng.integers(len(live)))]
                if victim in live_set:
                    break
            live_set.discard(victim)
            live = [i for i in live if i in live_set] \
                if len(live) > 2 * len(live_set) else live
            ops.append(UpdateOp(t=float(times[s]), seq=s, kind="delete",
                                id=victim))
        else:
            src = int(rng.integers(n))
            vec = data[src].astype(np.float64) + rng.normal(
                0.0, scale, size=data.shape[1])
            vec = vec.astype(data.dtype) if data.dtype != np.int8 else \
                np.clip(np.round(vec), -127, 127).astype(np.int8)
            ops.append(UpdateOp(t=float(times[s]), seq=s, kind="insert",
                                id=next_id, vec=vec))
            live_set.add(next_id)
            live.append(next_id)
            next_id += 1
    return UpdateStream(ops)


def churned_corpus(data: np.ndarray, stream: UpdateStream
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The corpus after the whole stream applies: (vectors, ids).

    Ground truth for recall-under-churn: exact top-k over this corpus is
    what a fully-compacted (or freshly rebuilt) index must return.
    """
    vecs: dict[int, np.ndarray] = {i: data[i] for i in range(len(data))}
    for op in stream.ops:
        if op.kind == "insert":
            vecs[op.id] = op.vec
        else:
            vecs.pop(op.id, None)
    ids = np.array(sorted(vecs), dtype=np.int64)
    return np.stack([vecs[i] for i in ids]), ids


def churn_ground_truth(data: np.ndarray, stream: UpdateStream,
                       queries: np.ndarray, k: int,
                       device=None) -> np.ndarray:
    """Exact top-``k`` ids per query against the post-churn corpus, on
    ``device`` (default: the card, through ``l2_topk``)."""
    from repro_torch.core.flat import exact_topk
    corpus, ids = churned_corpus(data, stream)
    idx, _ = exact_topk(corpus, queries, k, device=device)
    return ids[idx]
