"""The one traffic generator: it reads a traffic file's parameters and says
which queries of the pool each request carries.

A traffic file (``traffic/<name>.json``) holds::

    {"loop": "closed", "clients": 1, "batch": 512, "k": 10, "nprobe": 64}

``closed`` with one client: the client sends a batch of ``batch`` queries,
waits until its answers are on the host, then sends the next.  Batches
walk the pool in order and start again at its head, so every query is
asked as often as every other.  ``k`` and the index kind's knobs
(``kinds/<index>/kind.py``'s ``KNOBS``: ``nprobe`` for SPANN) are the
search parameters that every request of the mix carries; the file holds
exactly these keys.
"""
from __future__ import annotations

import dataclasses

KEYS = {"loop", "clients", "batch", "k"}
# SPANN's knobs, for the callers that name no kind (tools/trace_stages.py,
# tools/ab_search.py)
CLUSTER_KNOBS = ("nprobe",)


@dataclasses.dataclass(frozen=True)
class ClosedLoop:
    batch: int
    k: int
    pool: int
    knobs: dict                  # the kind's search parameters, by name

    @property
    def nprobe(self) -> int:
        """SPANN's knob, as ``tools/ab_search.py`` reads it."""
        return self.knobs["nprobe"]

    @property
    def slots(self) -> int:
        """Batches in one walk of the pool."""
        return self.pool // self.batch

    def rows(self, b: int) -> slice:
        """The pool rows of the ``b``-th batch sent."""
        s = (b % self.slots) * self.batch
        return slice(s, s + self.batch)


def generator(traffic: dict, pool: int, knobs=CLUSTER_KNOBS) -> ClosedLoop:
    """The generator for a traffic file's parameters over a pool of
    ``pool`` queries, whose requests carry the index kind's ``knobs``;
    raises on a mix it cannot make."""
    want = KEYS | set(knobs)
    if set(traffic) != want:
        raise ValueError(f"a traffic file has the keys {sorted(want)}, "
                         f"got {sorted(traffic)}")
    if traffic["loop"] != "closed" or traffic["clients"] != 1:
        raise ValueError("only a closed loop with one client is generated: "
                         f"got {traffic['loop']} with {traffic['clients']}")
    if traffic["batch"] < 1 or pool % traffic["batch"]:
        raise ValueError(f"the pool of {pool} queries is not a whole number "
                         f"of batches of {traffic['batch']}")
    return ClosedLoop(traffic["batch"], traffic["k"], pool,
                      {name: traffic[name] for name in knobs})
