"""Recall-vs-QPS Pareto frontier extraction.

A point dominates another when it is at least as good on both axes and
strictly better on one.  The frontier is returned sorted by recall
ascending (so it reads as the paper's QPS–recall curves, Figs 7/18).

The port's own copy of ``repro.tuning.pareto``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from __future__ import annotations

from typing import Callable, Sequence, TypeVar

T = TypeVar("T")


def pareto_frontier(points: Sequence[T],
                    recall_of: Callable[[T], float],
                    qps_of: Callable[[T], float]) -> list[T]:
    """Maximal (recall, qps) points, sorted by recall ascending.

    Ties collapse to a single representative (the first seen), so the
    frontier never contains two points with identical coordinates.
    """
    # sort by recall desc, qps desc: a point is on the frontier iff its
    # qps strictly exceeds the best qps seen at any higher-or-equal recall.
    order = sorted(range(len(points)),
                   key=lambda i: (-recall_of(points[i]), -qps_of(points[i])))
    frontier: list[T] = []
    best_qps = float("-inf")
    for i in order:
        p = points[i]
        if qps_of(p) > best_qps:
            frontier.append(p)
            best_qps = qps_of(p)
    frontier.reverse()
    return frontier


def hypervolume(points: Sequence[T],
                recall_of: Callable[[T], float],
                qps_of: Callable[[T], float],
                ref_recall: float = 0.0, ref_qps: float = 0.0) -> float:
    """Dominated-area indicator vs a reference corner (frontier quality)."""
    front = pareto_frontier(points, recall_of, qps_of)
    area = 0.0
    prev_r = ref_recall
    for p in front:                       # recall ascending
        r, q = recall_of(p), qps_of(p)
        if r <= prev_r or q <= ref_qps:
            continue
        area += (r - prev_r) * (q - ref_qps)
        prev_r = r
    return area
