"""In-process object store: the "remote storage" truth source (paper Fig 1).

Objects are immutable (key -> payload) with an explicit *billable size* in
bytes, which is what an I/O simulator charges for.  Index segment layouts:

* cluster index: one object per posting list
  (``("list", i)`` -> (ids, vectors); size = len * (D*itemsize + 8)).
* graph index: one object per node block, DiskANN's 4KB sector layout
  (``("node", i)`` -> (vector, neighbour ids); size rounded up to
  ``sector_bytes``).

The port's own copy of what the index slices need from
``repro.storage.object_store``; the reference's unlink/linger protocol for
compaction comes with the ingest slice.
"""
from __future__ import annotations

from typing import Any, Hashable


class ObjectStore:
    def __init__(self) -> None:
        self._data: dict[Hashable, Any] = {}
        self._size: dict[Hashable, int] = {}

    def put(self, key: Hashable, payload: Any, nbytes: int) -> None:
        self._data[key] = payload
        self._size[key] = int(nbytes)

    def get(self, key: Hashable) -> Any:
        return self._data[key]

    def nbytes(self, key: Hashable) -> int:
        return self._size[key]


def round_to_sectors(nbytes: int, sector_bytes: int) -> int:
    return -(-nbytes // sector_bytes) * sector_bytes
