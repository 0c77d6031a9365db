"""Distributed (sharded) vector search on ``torch.distributed``.

Counterpart of ``repro.core.distributed``.  The cluster index's posting
lists are sharded across the ranks of a process group; a query fans out to
every shard (each probes its local top-``nprobe_local`` lists and scans
them), and the per-shard top-k results are merged with one small
all-gather.  The distributed k-means step all-reduces each rank's centroid
sums and counts.

Where the reference takes a device mesh and ``shard_map``s the step over
it, each function here takes a process group (default: the world) and
returns the step this rank runs on its own shard.  The caller has set up
the group (``torch.distributed.init_process_group``): ``nccl`` for tensors
on the card, ``gloo`` on the CPU.  With one rank the collectives still run,
as one-rank collectives.

The centroid probe goes through :func:`repro_torch.core.distances.
pairwise_sq_l2`, which is the hand-written ``l2_distance`` kernel on the
card.  The scan's products run in full float32 (no TF32), and top-k puts
the lower index first on ties, as ``jax.lax.top_k`` does.
(``dryrun_distributed_search`` compiles with XLA for a production mesh and
is not part of the port.)
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distances import pairwise_sq_l2, topk_smallest
from repro_torch.kernels.ref import full_f32_matmul


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(S, *t.shape): every rank's ``t``, in rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def sharded_search_step(group=None, *, nprobe_local: int, k: int):
    """The fan-out/merge search step over ``group``'s shards.

    This rank's shard (dim 0 = its posting lists):
      centroids (L_loc, D) f32, list_vecs (L_loc, M, D), list_ids (L_loc, M)
      int32 (-1 = padding), list_norms (L_loc, M) f32 (squared row norms);
      queries (B, D), the same on every rank.
    Returns fn(centroids, list_vecs, list_ids, list_norms, queries) ->
    (ids (B, k), dists (B, k) f32), the merged result on every rank.
    """

    def local_search(cent, vecs, ids, norms, q):
        # per-shard: probe the local top-nprobe lists, scan them with the
        # precomputed row norms, local top-k
        d_c = pairwise_sq_l2(q, cent)                    # (B, L_loc)
        _, probe = topk_smallest(d_c, nprobe_local)      # (B, np)
        pv = vecs[probe]                                 # (B, np, M, D)
        B = q.shape[0]
        pi = ids[probe].reshape(B, -1)                   # (B, np*M)
        pn = norms[probe].reshape(B, -1)                 # (B, np*M) f32
        qf = q.float()
        qn = (qf * qf).sum(-1, keepdim=True)             # (B, 1)
        if pv.dtype == torch.int8:
            # exact: float64 holds every int32 product sum of int8 rows
            ip = torch.einsum("bd,bpmd->bpm", q.double(), pv.double())
        else:
            with full_f32_matmul():
                ip = torch.einsum("bd,bpmd->bpm", qf, pv.float())
        d = qn + pn - 2.0 * ip.reshape(B, -1).float()
        d = torch.where(pi < 0, torch.inf, d)
        vals, sel = topk_smallest(d, k)                  # (B, k) local
        out_ids = pi.gather(1, sel)
        # merge across every shard: one small all-gather of each
        av = _all_gather(vals, group)                    # (S, B, k)
        ai = _all_gather(out_ids, group)
        S = av.shape[0]
        av = av.transpose(0, 1).reshape(B, S * k)
        ai = ai.transpose(0, 1).reshape(B, S * k)
        gvals, gsel = topk_smallest(av, k)
        return ai.gather(1, gsel), gvals

    return local_search


def sharded_kmeans_step(group=None):
    """One distributed Lloyd iteration: local assign + all-reduced sums.

    This rank's data (N_loc, D); centroids (K, D), the same on every rank.
    Returns fn(data, centroids) -> new centroids (K, D) f32; a centroid that
    no point chose keeps its place.
    """

    def step(x, cent):
        d = pairwise_sq_l2(x, cent)                      # (N_loc, K)
        a = d.argmin(dim=1)                              # first minimum
        K = cent.shape[0]
        # the one-hot sums onehot.T @ x and counts onehot.sum(0), as a
        # scatter-add: the (N_loc, K) one-hot is never materialised
        sums = torch.zeros((K, x.shape[1]), dtype=torch.float32,
                           device=x.device).index_add_(0, a, x.float())
        counts = torch.bincount(a, minlength=K).float()
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
        return torch.where(counts[:, None] > 0,
                           sums / counts.clamp_min(1.0)[:, None], cent)

    return step
