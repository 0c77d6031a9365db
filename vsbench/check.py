"""The comparison that decides ``correct``: every answer the window
produced, against the plain reference's answer to the same query.

Each number is judged against the limit of the same name in the cell's
``checks/<cell>.json``, which holds a limit for each number and no other.
Three numbers are every index kind's (``GENERIC``):

* ``malformed``: answers with an id outside the data, an id given twice, a
  distance that is nan or out of ascending order, or fewer results than
  the reference's (limit 0).  An entry whose distance is inf is no result,
  whatever its id: the device search pads a short answer so;
* ``dist_err``: the widest gap between a returned distance and the exact
  (float64) squared distance of the returned id, as a share of
  ``|q|^2 + |x|^2``: the scan's arithmetic;
* ``differ``: the share of answers whose k exact distances, sorted, differ
  from those of the reference's answer by more than a near-tie at any
  rank: the index, its search, the dedup and the top-k.

The rest are the index kind's own (``kinds/<index>/kind.py``'s
``NUMBERS``), each worked out by its reference (``Answers.numbers``): the
SPANN kind's is ``lists_differ``, the index the window searched against
the closure rule over its own centroids
(``reference.search.lists_differ``): the share of points not in exactly
the lists the rule puts them in, near-ties left out, with every unsound
entry counted.

A near-tie is a gap within ``NEAR_TIE · (|q|^2 + max |x|^2)``: two points
that float32 cannot tell apart there.  The port's and the reference's
float32 distances each lie within a few 1e-7 of that scale of the exact
ones (at most 4.5e-7 for the port on an H100 over 12 seeds, 2.3e-7 for
the reference on the CPU), so a pair they order apart lies within 2e-6;
TF32 rounds each operand by up to 2^-11 (4.9e-4).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

NEAR_TIE = 2e-6
GENERIC = ("malformed", "dist_err", "differ")


@dataclasses.dataclass
class Verdict:
    answers: int               # queries answered in the window
    values: dict               # name -> number compared
    limits: dict               # name -> its limit, in the checks file's order
    recall: float              # mean recall@k of every answer
    why_bad: dict              # reason -> answers malformed for it

    @property
    def correct(self) -> bool:
        return all(self.values[n] <= self.limits[n] for n in self.limits)

    def record(self) -> dict:
        return {n: {"value": self.values[n], "limit": self.limits[n]}
                for n in self.limits}


def require(names, limits: dict) -> None:
    """Raise unless ``limits`` holds a limit for each of ``names`` and no
    other."""
    missing = sorted(set(names) - set(limits))
    stray = sorted(set(limits) - set(names))
    if missing or stray:
        raise ValueError(f"numbers without a limit: {missing}; limits that "
                         f"no number uses: {stray}")


def exact_sq(data: np.ndarray, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """float64 squared distances of ``q`` (R, D) to ``data[ids]`` (R, k);
    inf where an id is outside the data."""
    ok = (ids >= 0) & (ids < len(data))
    x = data[np.where(ok, ids, 0)].astype(np.float64)
    d = ((x - q.astype(np.float64)[:, None, :]) ** 2).sum(-1)
    return np.where(ok, d, np.inf)


def _rows(ids, dists, q, ref_exact, data, max_norm):
    """Per row: (reasons it is malformed, whether it differs from the
    reference's answer, widest relative distance gap).  An entry whose
    distance is inf is no result, whatever its id."""
    n, k = len(data), ids.shape[1]
    fin = np.isfinite(dists)
    nan = np.isnan(dists)
    in_range = (ids >= 0) & (ids < n)
    srt = np.sort(np.where(fin, ids, -1 - np.arange(k)), axis=1)
    dd = np.where(nan, np.inf, dists)
    reasons = {
        "id outside the data": (fin & ~in_range).any(1),
        "id given twice": (srt[:, 1:] == srt[:, :-1]).any(1),
        "distance nan": nan.any(1),
        "distances out of order": ~(dd[:, 1:] >= dd[:, :-1]).all(1),
        "fewer results than the reference": fin.sum(1)
        < np.isfinite(ref_exact).sum(1)}
    valid = fin & in_range
    ex = exact_sq(data, q, np.where(valid, ids, -1))
    qn = (q.astype(np.float64) ** 2).sum(-1)
    xn = (data[np.where(valid, ids, 0)].astype(np.float64) ** 2).sum(-1)
    tol = NEAR_TIE * (qn + max_norm)
    with np.errstate(invalid="ignore"):
        gap = np.where(valid, np.abs(dists.astype(np.float64) - ex)
                       / (qn[:, None] + xn), 0.0)
        diff = np.abs(np.sort(ex, 1) - ref_exact)
    diff = np.where(np.isinf(np.sort(ex, 1)) & np.isinf(ref_exact), 0.0, diff)
    differ = (~(diff <= tol[:, None])).any(1)
    return reasons, differ, gap.max(1)


def judge(slots: np.ndarray, ids: np.ndarray, dists: np.ndarray,
          pool: np.ndarray, data: np.ndarray, ref_ids: np.ndarray,
          gt: np.ndarray, batch: int, limits: dict, own) -> Verdict:
    """Judge the window's answers.

    ``slots`` (nb,) is the first pool row of each batch sent, ``ids`` and
    ``dists`` (nb, batch, k) its answers as they reached the host,
    ``ref_ids`` (P, k) the reference's answer to each pool query and ``gt``
    (P, k) its exact nearest ids; ``own`` maps the index kind's own
    numbers to their values.  A bare number for ``own`` (as
    ``tools/trace_stages.py`` calls) is the one number that ``limits``
    names beside ``GENERIC``.  An answer given again with
    the same bits is judged once and counted each time.
    """
    if not isinstance(own, dict):
        own = {n: own for n in limits if n not in GENERIC}
        if len(own) != 1:
            raise ValueError(f"a bare number for limits {sorted(limits)}")
    require((*GENERIC, *own), limits)
    k = ids.shape[2]
    max_norm = float((data.astype(np.float64) ** 2).sum(-1).max())
    groups: dict[bytes, list[int]] = {}
    for b in range(len(slots)):
        h = hashlib.sha256(np.int64(slots[b]).tobytes() + ids[b].tobytes()
                           + dists[b].tobytes()).digest()
        groups.setdefault(h, []).append(b)
    ref_cache: dict[int, np.ndarray] = {}
    n_bad = n_differ = 0
    why_bad: dict[str, int] = {}
    widest = 0.0
    hits = 0.0
    for members in groups.values():
        b, w = members[0], len(members)
        s = int(slots[b])
        q = pool[s:s + batch]
        if s not in ref_cache:
            ref_cache[s] = np.sort(exact_sq(data, q, ref_ids[s:s + batch]), 1)
        reasons, differ, gap = _rows(ids[b].astype(np.int64), dists[b], q,
                                     ref_cache[s], data, max_norm)
        n_bad += w * int(np.logical_or.reduce(list(reasons.values())).sum())
        for why, rows in reasons.items():
            if rows.any():
                why_bad[why] = why_bad.get(why, 0) + w * int(rows.sum())
        n_differ += w * int(differ.sum())
        widest = max(widest, float(gap.max()))
        g = gt[s:s + batch]
        found = np.where(np.isfinite(dists[b]), ids[b], -1)
        hits += w * int((g[:, :, None] == found[:, None, :]).any(2).sum())
    answers = len(slots) * batch
    values = {"malformed": n_bad, "dist_err": widest,
              "differ": n_differ / answers, **own}
    return Verdict(answers, values, dict(limits), hits / (answers * k), why_bad)
