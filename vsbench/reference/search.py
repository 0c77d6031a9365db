"""The cluster index's lists, probe, scan, replica dedup and top-k in plain
PyTorch, on whatever device the tensors are on.

The lists are worked out again from the data and the centroids that the
program's build chose (its BKT's leaf centres): the centroids are the
program's state, and the reference follows it from there.  What the BKT
stage owes is checked apart: the closure rule that every point lies in its
nearest list and in each near list (``lists_differ``), and the partition's
quality through recall.

The answer to a query is the device search's as the system states it
(``device_search_batch`` in ``repro`` and in the port): the ``WINDOW · k``
nearest entries of the probed lists, replicas counted, ties in probe
order; one copy of each point among them; the ``k`` nearest of those.
Where the window holds fewer than ``k`` distinct points the answer is
short, padded with ``(-1, inf)``.

Products run in full float32 (TF32 off).  With ``tf32=True`` every product
takes its operands rounded to TF32 first (10 mantissa bits, round to
nearest even, as the tensor cores read them) and accumulates in float32:
the reference one precision below the configuration's, which the benchmark
uses as its control.  Top-k is a stable sort: lower index first on ties.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

CLOSURE_CHUNK = 4096        # points a block in the closure
QUERY_BLOCK = 512           # queries a block in the probe and the exact top-k
SCAN_ROWS = 1 << 16         # candidate rows a block in the scan
WINDOW = 4                  # entries the dedup sees, in multiples of k
# two squared distances within NEAR_TIE of (|x|^2 + max |c|^2) are a tie
# that float32 cannot order (each side lies within a few 1e-7 of it)
NEAR_TIE = 2e-6


@contextlib.contextmanager
def full_f32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & -0x2000
    return b.view(torch.float32)


def _operand(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return to_tf32(x) if tf32 else x


def sq_l2(q: torch.Tensor, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) float32: |q|^2 + |x|^2 - 2 q.x, at 0 or
    above; the norms in float32, the product at the chosen precision."""
    qn = (q * q).sum(-1)[:, None]
    xn = (x * x).sum(-1)[None, :]
    with full_f32():
        ip = _operand(q, tf32) @ _operand(x, tf32).T
    return torch.clamp_min(qn + xn - 2.0 * ip, 0.0)


def stable_topk(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return d.gather(-1, idx), idx


@dataclasses.dataclass
class Index:
    """The lists as compressed rows: list ``l`` holds point ids
    ``members[ptr[l]:ptr[l + 1]]``, ascending.  ``unsure`` marks the points
    whose set of lists rests on a near-tie."""
    centroids: torch.Tensor      # (L, D) float32
    ptr: torch.Tensor            # (L + 1,) int64
    members: torch.Tensor        # (entries,) int64
    unsure: torch.Tensor         # (N,) bool

    @property
    def lengths(self) -> torch.Tensor:
        return self.ptr[1:] - self.ptr[:-1]


def build_index(data: torch.Tensor, centroids: torch.Tensor, params: dict,
                tf32: bool = False) -> Index:
    """SPANN's closure replication over ``centroids``: a point joins its
    nearest list and each of its ``num_replica`` nearest lists within
    ``(1 + closure_eps)`` of the nearest's distance (squared:
    ``(1 + eps)^2``).  A point is unsure where its nearest two lists tie,
    where a list's distance ties the threshold, or where the
    ``num_replica``-th list kept ties the next."""
    x = data.float()
    cents = centroids.float().to(x.device)
    n, n_lists = x.shape[0], cents.shape[0]
    r = min(params["num_replica"], n_lists)
    thresh = (1.0 + params["closure_eps"]) ** 2
    cn = float((cents.double() ** 2).sum(-1).max())
    lists, points, unsure = [], [], []
    for s in range(0, n, CLOSURE_CHUNK):
        xs = x[s:s + CLOSURE_CHUNK]
        dd, idx = stable_topk(sq_l2(xs, cents, tf32), min(r + 1, n_lists))
        tol = NEAR_TIE * ((xs.double() ** 2).sum(-1) + cn)[:, None]
        dd64 = dd.double()
        bound = thresh * dd64[:, :1]
        amb = ((dd64[:, 1:r] - bound).abs() <= tol * (1 + thresh)).any(1)
        if r > 1:
            amb |= dd64[:, 1] - dd64[:, 0] <= tol[:, 0]
        if n_lists > r:
            amb |= ((dd64[:, r - 1] <= bound[:, 0] + tol[:, 0] * (1 + thresh))
                    & (dd64[:, r] - dd64[:, r - 1] <= tol[:, 0]))
        dd, idx = dd[:, :r], idx[:, :r]
        keep = dd <= thresh * dd[:, :1] + 1e-12
        keep[:, 0] = True
        rows, cols = keep.nonzero(as_tuple=True)
        lists.append(idx[rows, cols])
        points.append(rows + s)
        unsure.append(amb)
    lists_t, points_t = torch.cat(lists), torch.cat(points)
    order = torch.sort(lists_t, stable=True).indices
    counts = torch.bincount(lists_t, minlength=n_lists)
    ptr = torch.zeros(n_lists + 1, dtype=torch.int64, device=x.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return Index(cents, ptr, points_t[order], torch.cat(unsure))


def padded_lists(index: Index) -> tuple[np.ndarray, np.ndarray]:
    """``(list_ids (L, longest) int32, -1 padded; list_len (L,))``: the
    layout the program keeps its lists in."""
    lens = index.lengths.cpu().numpy()
    ids = np.full((len(lens), max(1, int(lens.max()))), -1, dtype=np.int32)
    cols = np.arange(ids.shape[1])[None, :] < lens[:, None]
    ids[cols] = index.members.cpu().numpy()
    return ids, lens.astype(np.int32)


def lists_differ(index: Index, list_ids: np.ndarray, list_len: np.ndarray,
                 n: int) -> tuple[float, float]:
    """``(differ, unsure)``: the share of the ``n`` points whose set of
    lists in ``list_ids`` (L, longest) int32, -1 padded, is not the
    reference's, among the points whose set rests on no near-tie, plus
    every entry that is no sound one (an id outside the data, a point twice
    in a list, a length that is not the list's, an id after the padding),
    as a share of ``n``; and the share of points left out as unsure."""
    ids = np.asarray(list_ids, dtype=np.int64)
    L = ids.shape[0]
    lens = np.asarray(list_len, dtype=np.int64)
    filled = ids >= 0
    bad = int((filled & (ids >= n)).sum())
    bad += int((filled.sum(1) != lens).sum())
    bad += int((filled[:, 1:] & ~filled[:, :-1]).sum())
    li, col = np.nonzero(filled & (ids < n))
    got = np.unique(ids[li, col] * L + li)
    bad += int((filled & (ids < n)).sum()) - len(got)      # repeats
    ptr = index.ptr.cpu().numpy()
    want = np.unique(index.members.cpu().numpy() * L
                     + np.repeat(np.arange(L), np.diff(ptr)))
    odd = np.setxor1d(got, want, assume_unique=True) // L
    unsure = index.unsure.cpu().numpy()
    wrong = np.unique(odd)
    wrong = wrong[~unsure[wrong]]
    return (len(wrong) + bad) / n, float(unsure.mean())


def probe(index: Index, queries: torch.Tensor, nprobe: int,
          tf32: bool = False) -> torch.Tensor:
    """(Q, nprobe) ids of each query's nearest lists, nearest first."""
    out = [stable_topk(sq_l2(queries[s:s + QUERY_BLOCK], index.centroids,
                             tf32), nprobe)[1]
           for s in range(0, queries.shape[0], QUERY_BLOCK)]
    return torch.cat(out)


def scan(index: Index, data: torch.Tensor, queries: torch.Tensor,
         probed: torch.Tensor, k: int, tf32: bool = False
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every entry of each query's probed lists, unpadded, in probe order:
    squared distances; the ``WINDOW · k`` nearest entries (distance, then
    that order); one copy of each point among them; the ``k`` nearest
    (distance, then id).  Returns ``(ids (Q, k) int64, dists (Q, k)
    float32)``, padded with ``(-1, inf)`` where fewer than ``k`` distinct
    points were in the window."""
    x = data.float()
    q = queries.float()
    nq = q.shape[0]
    dev = x.device
    xn = (x * x).sum(-1)
    qn = (q * q).sum(-1)
    lens = index.lengths[probed].reshape(-1)                  # (Q·nprobe,)
    starts = index.ptr[:-1][probed].reshape(-1)
    qid = torch.arange(nq, device=dev).repeat_interleave(probed.shape[1])
    total = int(lens.sum())
    first = torch.cumsum(lens, 0) - lens
    pos = (torch.arange(total, device=dev)
           - torch.repeat_interleave(first, lens)
           + torch.repeat_interleave(starts, lens))
    cand = index.members[pos]                                   # point ids
    cq = torch.repeat_interleave(qid, lens)                     # query ids
    d = torch.empty(total, dtype=torch.float32, device=dev)
    xo, qo = _operand(x, tf32), _operand(q, tf32)
    for s in range(0, total, SCAN_ROWS):
        c, cqq = cand[s:s + SCAN_ROWS], cq[s:s + SCAN_ROWS]
        ip = (xo[c] * qo[cqq]).sum(-1)
        d[s:s + SCAN_ROWS] = torch.clamp_min(qn[cqq] + xn[c] - 2.0 * ip, 0.0)
    # the window: (query, distance, probe order), the first WINDOW·k a query
    o = torch.sort(d, stable=True).indices
    o = o[torch.sort(cq[o], stable=True).indices]
    cq, cand, d = cq[o], cand[o], d[o]
    seg = torch.searchsorted(cq, torch.arange(nq + 1, device=dev))
    keep = torch.arange(cq.shape[0], device=dev) - seg[cq] < WINDOW * k
    cq, cand, d = cq[keep], cand[keep], d[keep]
    # one copy of each (query, point): replicas carry the same distance
    code, inv = torch.unique(cq * x.shape[0] + cand, return_inverse=True)
    du = torch.empty(code.shape[0], dtype=torch.float32, device=dev)
    du[inv] = d
    uq, up = code // x.shape[0], code % x.shape[0]
    # (query, distance, id) order: code is sorted by (query, id) already
    order = torch.sort(du, stable=True).indices
    order = order[torch.sort(uq[order], stable=True).indices]
    uq, up, du = uq[order], up[order], du[order]
    seg = torch.searchsorted(uq, torch.arange(nq + 1, device=dev))
    rank = torch.arange(uq.shape[0], device=dev) - seg[uq]
    sel = rank < k
    ids = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    dists = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    ids[uq[sel], rank[sel]] = up[sel]
    dists[uq[sel], rank[sel]] = du[sel]
    return ids, dists


def search(index: Index, data: torch.Tensor, queries: torch.Tensor,
           nprobe: int, k: int, tf32: bool = False,
           block: int = 2048
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe and scan ``queries`` in blocks: ``(ids, dists)`` as
    :func:`scan`, and the (Q, nprobe) lists each query probed."""
    nprobe = min(nprobe, index.centroids.shape[0])
    ids, dists, probed = [], [], []
    for s in range(0, queries.shape[0], block):
        p = probe(index, queries[s:s + block], nprobe, tf32)
        i, d = scan(index, data, queries[s:s + block], p, k, tf32)
        ids.append(i)
        dists.append(d)
        probed.append(p)
    return torch.cat(ids), torch.cat(dists), torch.cat(probed)


def exact_topk(data: torch.Tensor, queries: torch.Tensor, k: int
               ) -> np.ndarray:
    """Ids (Q, k) of each query's ``k`` nearest points by brute force, in
    full float32: the ground truth of recall."""
    x = data.float()
    out = [torch.topk(sq_l2(queries[s:s + QUERY_BLOCK].float(), x), k,
                      largest=False, sorted=True).indices
           for s in range(0, queries.shape[0], QUERY_BLOCK)]
    return torch.cat(out).cpu().numpy()
