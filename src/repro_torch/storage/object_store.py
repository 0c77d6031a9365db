"""In-process object store: the "remote storage" truth source (paper Fig 1).

Objects are immutable (key -> payload) with an explicit *billable size* in
bytes, which is what the I/O simulator charges for.  Index segment layouts:

* cluster index: one object per posting list
  (``("list", i)`` -> (ids, vectors); size = len * (D*itemsize + 8)).
* graph index: one object per node block, DiskANN's 4KB sector layout
  (``("node", i)`` -> (vector, neighbour ids); size rounded up to
  ``sector_bytes`` — nodes whose vector+adjacency exceed one sector span
  multiple sectors, which is why denser graphs are bigger, Table 4/Fig 17).

The port's own copy of ``repro.storage.object_store``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

from typing import Any, Hashable


class ObjectStore:
    def __init__(self) -> None:
        self._data: dict[Hashable, Any] = {}
        self._size: dict[Hashable, int] = {}
        # unlinked-but-still-readable payloads (POSIX-unlink semantics):
        # not billed, not a member, but a reader that resolved the key
        # before the unlink can still fetch it until purge_lingering().
        self._lingering: dict[Hashable, Any] = {}
        self._linger_t: dict[Hashable, float] = {}   # key -> unlink time

    def put(self, key: Hashable, payload: Any, nbytes: int) -> None:
        self._lingering.pop(key, None)     # re-insert supersedes a corpse
        self._linger_t.pop(key, None)
        self._data[key] = payload
        self._size[key] = int(nbytes)

    def get(self, key: Hashable) -> Any:
        if key in self._data:
            return self._data[key]
        return self._lingering[key]

    def remove(self, key: Hashable) -> int:
        """Delete an object (compaction retired it); returns its billable
        size (0 when absent)."""
        self._data.pop(key, None)
        self._lingering.pop(key, None)
        self._linger_t.pop(key, None)
        return self._size.pop(key, 0)

    def unlink(self, key: Hashable, t: float = 0.0) -> int:
        """Stop billing and membership for ``key`` but keep the payload
        readable until :meth:`purge_lingering` — the reclamation protocol
        for retired graph blocks: queries already holding a pre-compaction
        reference may still fetch the block; nothing new can find it, and
        its bytes no longer count toward :attr:`total_bytes`.  ``t`` is
        the unlink's virtual time, consulted by grace-based purges.
        Returns the bytes reclaimed (0 when absent)."""
        if key not in self._data:
            return 0
        self._lingering[key] = self._data.pop(key)
        self._linger_t[key] = float(t)
        return self._size.pop(key, 0)

    def purge_lingering(self, before: float | None = None) -> int:
        """Drop unlinked payloads — all of them, or (``before`` given)
        only corpses unlinked earlier than ``before``, so a reader whose
        sub-request was parked (shed backoff, fault window) across a
        compaction epoch still finds blocks retired within the grace
        window.  Returns how many corpses were purged."""
        if before is None:
            n = len(self._lingering)
            self._lingering.clear()
            self._linger_t.clear()
            return n
        victims = [k for k, t in self._linger_t.items() if t < before]
        for k in victims:
            self._lingering.pop(k, None)
            self._linger_t.pop(k, None)
        return len(victims)

    @property
    def lingering_count(self) -> int:
        return len(self._lingering)

    def nbytes(self, key: Hashable) -> int:
        return self._size[key]

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    @property
    def total_bytes(self) -> int:
        return sum(self._size.values())


def round_to_sectors(nbytes: int, sector_bytes: int) -> int:
    return -(-nbytes // sector_bytes) * sector_bytes
