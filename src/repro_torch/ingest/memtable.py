"""The in-memory delta tier: a brute-force flat segment + tombstones.

Cloud-native indexes are built once and served read-only (the paper's
setting); live corpora churn.  The standard reconciliation — LSM-style —
is a small memory-resident *delta* absorbing writes at memory speed while
the sealed segments stay immutable on the object store:

* **inserts** land in the memtable (id → vector [+ posting-list
  assignment for cluster indexes]) and become searchable the moment they
  are applied: merged search scans the delta by brute force (it is tiny
  relative to the sealed tier, so a flat scan is both exact and cheap).
* **deletes** are tombstones: sealed copies cannot be touched without a
  rewrite, so the id is recorded and filtered out of every merged result
  until compaction folds the delete into the sealed objects.

The memtable is **sized in bytes** (vector payload + 8-byte id per
entry, 8 bytes per tombstone) because bytes are what trigger flushes and
what the flush ultimately writes; entry counts would mis-size the tier
across dims/dtypes.

The port's own copy of ``repro.ingest.memtable``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core.distances import np_sq_l2

#: per-entry id overhead (matches the sealed posting-list layout)
ID_BYTES = 8
#: per-tombstone bookkeeping bytes
TOMBSTONE_BYTES = 8


@dataclasses.dataclass
class DeltaEntry:
    """One live insert: the vector plus where it will be sealed.

    ``lists`` is the closure-replicated posting-list assignment for
    cluster indexes (empty tuple for graph nodes, whose placement is the
    node id itself); ``arrive_t`` feeds freshness-lag accounting.
    """

    id: int
    vec: np.ndarray
    lists: tuple[int, ...]
    arrive_t: float
    apply_t: float


class Memtable:
    """Flat delta segment + tombstone set for one ingest site.

    A *site* is whoever applies updates against one view: the single
    engine, or one fleet shard group (each owner group of an update's
    keys holds its own copy — replication at the delta tier, mirroring
    replication of the sealed objects).
    """

    def __init__(self, vec_nbytes: int):
        self.vec_nbytes = int(vec_nbytes)       # payload bytes per vector
        self.entries: dict[int, DeltaEntry] = {}
        self.tombstones: dict[int, float] = {}  # id -> arrive_t
        self.by_list: dict[int, set[int]] = {}  # list id -> delta ids
        self.peak_bytes = 0
        self.total_inserts = 0
        self.total_deletes = 0

    # ------------------------------------------------------------ sizing --
    @property
    def entry_nbytes(self) -> int:
        return self.vec_nbytes + ID_BYTES

    @property
    def used_bytes(self) -> int:
        return (len(self.entries) * self.entry_nbytes
                + len(self.tombstones) * TOMBSTONE_BYTES)

    def __len__(self) -> int:
        return len(self.entries)

    # ----------------------------------------------------------- mutation --
    def insert(self, id_: int, vec: np.ndarray, lists: tuple[int, ...],
               arrive_t: float, apply_t: float) -> None:
        """Apply an insert: the id becomes searchable immediately.  A
        re-insert of a tombstoned id resurrects it (the delta copy wins
        over any stale sealed copy via the tombstone it replaces)."""
        self.tombstones.pop(id_, None)
        old = self.entries.pop(id_, None)
        if old is not None:
            for li in old.lists:
                self.by_list.get(li, set()).discard(id_)
        self.entries[id_] = DeltaEntry(id_, vec, tuple(lists),
                                       arrive_t, apply_t)
        for li in lists:
            self.by_list.setdefault(li, set()).add(id_)
        self.total_inserts += 1
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)

    def delete(self, id_: int, arrive_t: float) -> bool:
        """Apply a delete.  Returns True when the victim was still in the
        delta (no sealed copy to tombstone — the entry just vanishes)."""
        self.total_deletes += 1
        old = self.entries.pop(id_, None)
        if old is not None:
            for li in old.lists:
                self.by_list.get(li, set()).discard(id_)
            return True
        self.tombstones[id_] = arrive_t
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)
        return False

    def clear_flushed(self, entries: dict, tombstones: dict) -> None:
        """Drop the snapshot a completed flush sealed.  Entries replaced
        *after* the snapshot (re-insert of the same id) and tombstones
        re-laid since are kept — only the exact flushed state clears."""
        for id_, e in entries.items():
            if self.entries.get(id_) is e:
                del self.entries[id_]
                for li in e.lists:
                    self.by_list.get(li, set()).discard(id_)
        for id_, arrive_t in tombstones.items():
            if self.tombstones.get(id_) == arrive_t:
                del self.tombstones[id_]

    def remap_list(self, old_li: int, moved: dict[int, int]) -> None:
        """A re-cluster split list ``old_li``: delta ids in ``moved``
        now belong to their new list id (entries keep closure copies in
        unaffected lists)."""
        for id_, new_li in moved.items():
            e = self.entries.get(id_)
            if e is None:
                continue
            e.lists = tuple(new_li if li == old_li else li
                            for li in e.lists)
            self.by_list.get(old_li, set()).discard(id_)
            self.by_list.setdefault(new_li, set()).add(id_)

    # ------------------------------------------------------------- search --
    def live_items(self, lists: Iterator[int] | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        """(ids, vecs) of live delta entries — restricted to entries
        assigned to ``lists`` when given (the shard-scan path: a scan job
        probing posting lists L sees exactly the delta points destined
        for L, so every replica owner serves the same content)."""
        if lists is None:
            ids = sorted(self.entries)
        else:
            sel: set[int] = set()
            for li in lists:
                sel |= self.by_list.get(li, set())
            ids = sorted(sel)
        if not ids:
            return (np.zeros(0, dtype=np.int64), np.zeros((0, 0)))
        vecs = np.stack([self.entries[i].vec for i in ids])
        return np.asarray(ids, dtype=np.int64), vecs

    def search(self, q: np.ndarray, k: int,
               lists: Iterator[int] | None = None
               ) -> tuple[np.ndarray, np.ndarray, int]:
        """Brute-force top-``k`` over the (restricted) live delta.

        Returns (ids, sq-l2 dists, n_dist_comps) — the caller merges
        them with the sealed result through ``dedup_topk`` and charges
        the comps to its compute budget.
        """
        ids, vecs = self.live_items(lists)
        if len(ids) == 0:
            return ids, np.zeros(0, dtype=np.float32), 0
        d = np_sq_l2(np.asarray(q, dtype=np.float32),
                     vecs.astype(np.float32, copy=False))
        if len(ids) > k:
            sel = np.argpartition(d, k)[:k]
            sel = sel[np.argsort(d[sel], kind="stable")]
        else:
            sel = np.argsort(d, kind="stable")
        return ids[sel], d[sel].astype(np.float32), len(ids)
