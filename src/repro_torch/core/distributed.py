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
card (the ``repro_torch::l2_distance`` op).  The scan's products run in
full float32 (no TF32), and top-k puts the lower index first on ties, as
``jax.lax.top_k`` does.  :func:`dryrun_distributed_search` runs the step
once at production scale on a fake world (``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distances import pairwise_sq_l2, topk_smallest
from repro_torch.kernels.ref import full_f32_matmul


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(S, *t.shape): every rank's ``t``, in rank order (one functional
    all-gather, which a profiler records with its dtype and group size)."""
    g = group if group is not None else dist.group.WORLD
    n = dist.get_world_size(g)
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        t.contiguous(), n, g.group_name)
    return torch.ops._c10d_functional.wait_tensor(out).reshape(n, *t.shape)


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


# --------------------------------------------------------- dry-run cell --

def dryrun_distributed_search(
    mesh, *,
    n_lists: int = 1 << 21,       # 2M posting lists (BIGANN-1B-scale SPANN)
    max_len: int = 128,
    dim: int = 128,
    batch: int = 256,
    nprobe_local: int = 8,
    k: int = 10,
    device: str = "cuda",
) -> dict:
    """Run the production-scale sharded search step once, as rank 0 of
    ``mesh``'s world (a fake process group), on fake tensors: each rank's
    shard is ``n_lists / chips`` int8 lists with their f32 centroids and
    norms and int32 ids.  Returns the dry-run record (memory, cost,
    collective bytes; the reference's keys).

    ``bytes_per_device`` counts what the step must read and write once: the
    rank's centroids, the probed lists' rows, ids and norms, the queries
    and the merged result (the reference reads XLA's "bytes accessed")."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import roofline as rf
    from repro_torch.launch.dryrun import local_bytes, trace

    chips = mesh.size()
    L = n_lists // chips
    with FakeTensorMode(allow_non_fake_inputs=True):
        shard = (torch.empty((L, dim), dtype=torch.float32, device=device),
                 torch.empty((L, max_len, dim), dtype=torch.int8,
                             device=device),
                 torch.empty((L, max_len), dtype=torch.int32, device=device),
                 torch.empty((L, max_len), dtype=torch.float32,
                             device=device))
        q = torch.empty((batch, dim), dtype=torch.float32, device=device)
        step = sharded_search_step(nprobe_local=nprobe_local, k=k)
        arg_bytes = local_bytes((shard, q))
        wall, flops_dev, peak, colls = trace(lambda: step(*shard, q))
    coll = rf.collective_bytes(colls)
    links = rf.link_bytes(colls)
    read = (L * dim * 4 + batch * nprobe_local * max_len * (dim + 4 + 4)
            + batch * dim * 4 + batch * k * 8)
    # analytic "model flops": distance comps actually requested
    lists_scanned = chips * nprobe_local * batch
    model_flops = 2.0 * lists_scanned * max_len * dim \
        + 2.0 * batch * n_lists * dim          # centroid matmul
    roof = rf.Roofline(chips=chips, flops_per_device=float(flops_dev),
                       bytes_per_device=float(read),
                       coll_bytes_per_device=float(sum(coll.values())),
                       coll_breakdown=coll, model_flops=model_flops,
                       coll_link_bytes=links)
    return dict(
        status="ok", chips=chips, trace_s=round(wall, 1),
        shape=dict(n_lists=n_lists, max_len=max_len, dim=dim,
                   batch=batch, nprobe_local=nprobe_local, k=k),
        memory=dict(argument_size_in_bytes=arg_bytes,
                    temp_size_in_bytes=int(peak),
                    peak_size_in_bytes=arg_bytes + int(peak)),
        cost=dict(flops_per_device=float(flops_dev),
                  bytes_per_device=float(read)),
        collective_bytes=coll,
        collective_counts=rf.count_collectives(colls),
        roofline=dict(
            compute_s=roof.compute_s,
            memory_s=roof.memory_s,
            collective_s=roof.collective_s,
            model_flops=model_flops,
            useful_flops_ratio=(model_flops / (flops_dev * chips)
                                if flops_dev else 0.0),
        ),
    )
