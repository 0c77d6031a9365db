"""Sharded search and k-means of the port on ``torch.distributed`` (gloo),
against ``repro.core.distributed`` on a 1-device mesh.

The reference's three tests (``tests/test_distributed.py``) run on one
rank; the one-rank step is held to the reference's on the same arrays;
then two ranks, each holding half of the posting lists (and of the
k-means points), are held to the reference run on each half and merged,
and to its k-means step over all the points.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.core.distances import topk_smallest as ref_topk_smallest  # noqa: E402
from repro.core.distributed import (  # noqa: E402
    sharded_kmeans_step as ref_kmeans_step,
    sharded_search_step as ref_search_step)
from repro_torch.core.distributed import (sharded_kmeans_step,  # noqa: E402
                                          sharded_search_step)
from repro_torch.core.flat import exact_topk  # noqa: E402
from torch_dist_worker import run as worker_run  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4      # distances (f32 sums in another order)
KM_RTOL, KM_ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT_S = 90
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """This process as the only rank of a gloo group."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _lists(seed, L=64, M=8, D=16, B=8, pad=True, dtype=np.float32):
    """Posting lists around L centroids, some slots padded with id -1."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(L, D)).astype(np.float32)
    vecs = (cents[:, None, :]
            + rng.normal(0, 0.1, size=(L, M, D))).astype(np.float32)
    ids = np.arange(L * M, dtype=np.int32).reshape(L, M)
    if pad:
        ids[rng.random((L, M)) < 0.2] = -1
    queries = (cents[rng.choice(L, B)]
               + rng.normal(0, 0.05, size=(B, D))).astype(np.float32)
    if dtype == np.int8:
        cents, vecs, queries = (np.clip(np.round(a * 20), -127, 127)
                                .astype(np.int8)
                                for a in (cents, vecs, queries))
    norms = (vecs.astype(np.float32) ** 2).sum(-1)
    return cents, vecs, ids, norms, queries


def _ref_search(mesh, arrays, nprobe, k):
    fn = jax.jit(ref_search_step(mesh, nprobe_local=nprobe, k=k))
    with mesh:
        ids, d = fn(*(jnp.asarray(a) for a in arrays))
    return np.asarray(ids), np.asarray(d)


def _kmeans_data(seed):
    rng = np.random.default_rng(seed)
    true = rng.normal(size=(8, 8)).astype(np.float32) * 5
    x = (true[rng.integers(0, 8, 512)]
         + rng.normal(0, 0.3, size=(512, 8))).astype(np.float32)
    return x, x[rng.choice(512, 8, replace=False)]


# ------------------------------------------- the reference's three tests --

def test_sharded_search_matches_flat(one_rank):
    rng = np.random.default_rng(0)
    L, M, D, B = 64, 8, 16, 4
    cents = rng.normal(size=(L, D)).astype(np.float32)
    vecs = (cents[:, None, :]
            + rng.normal(0, 0.1, size=(L, M, D))).astype(np.float32)
    ids = np.arange(L * M, dtype=np.int32).reshape(L, M)
    queries = (cents[rng.choice(L, B)]
               + rng.normal(0, 0.05, size=(B, D))).astype(np.float32)
    norms = (vecs ** 2).sum(-1)
    fn = sharded_search_step(nprobe_local=L, k=5)
    got_ids, got_d = fn(*_t(cents, vecs, ids, norms, queries))
    want_ids, want_d = exact_topk(vecs.reshape(-1, D), queries, 5,
                                  device="cpu")
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-4, atol=1e-4)
    for b in range(B):
        assert len(np.intersect1d(got_ids[b].numpy(), want_ids[b])) >= 4


def test_sharded_search_respects_nprobe(one_rank):
    rng = np.random.default_rng(1)
    L, M, D, B = 32, 4, 8, 2
    cents = rng.normal(size=(L, D)).astype(np.float32) * 10
    vecs = (cents[:, None, :]
            + rng.normal(0, 0.1, size=(L, M, D))).astype(np.float32)
    ids = np.arange(L * M, dtype=np.int32).reshape(L, M)
    q = (cents[:B] + 0.01).astype(np.float32)
    norms = (vecs ** 2).sum(-1)
    fn = sharded_search_step(nprobe_local=1, k=3)
    got_ids, _ = fn(*_t(cents, vecs, ids, norms, q))
    # probing only the nearest list still finds its members
    for b in range(B):
        assert set(got_ids[b].tolist()) <= set(ids[b].tolist())


def test_sharded_kmeans_step_improves(one_rank):
    x, cents = _kmeans_data(2)
    step = sharded_kmeans_step()

    def inertia(c):
        d = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        return d.min(1).mean()

    c1 = step(*_t(x, cents))
    c2 = step(torch.from_numpy(x), c1)
    assert inertia(c2.numpy()) <= inertia(cents) + 1e-5


# ------------------------------------------ one rank against the mesh ----

@pytest.mark.parametrize("dtype", [np.float32, np.int8],
                         ids=["float32", "int8"])
@pytest.mark.parametrize("nprobe", [8, 64])
def test_one_rank_matches_the_reference_mesh(one_rank, mesh, dtype, nprobe):
    arrays = _lists(3, dtype=dtype)
    want_ids, want_d = _ref_search(mesh, arrays, nprobe, 10)
    got_ids, got_d = sharded_search_step(nprobe_local=nprobe, k=10)(
        *_t(*arrays))
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=RTOL, atol=ATOL)


def test_one_rank_kmeans_matches_the_reference_mesh(one_rank, mesh):
    x, cents = _kmeans_data(4)
    cents[3] = 1e3                       # a centroid no point chooses
    with mesh:
        want = np.asarray(jax.jit(ref_kmeans_step(mesh))(
            jnp.asarray(x), jnp.asarray(cents)))
    got = sharded_kmeans_step()(*_t(x, cents)).numpy()
    np.testing.assert_array_equal(got[3], cents[3])
    np.testing.assert_allclose(got, want, rtol=KM_RTOL, atol=KM_ATOL)


# --------------------------------------------------------- two ranks -----

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two gloo ranks (spawned processes), each with half of the lists and
    of the k-means points: their results and the inputs."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    cents, vecs, ids, norms, queries = _lists(5, L=64, B=12)
    x, init = _kmeans_data(6)
    inp = tmp / "inputs.npz"
    np.savez(inp, cents=cents, vecs=vecs, ids=ids, norms=norms,
             queries=queries, x=x, init=init, nprobe=4, k=10)
    ctx = mp.start_processes(
        worker_run, args=(2, str(tmp / "store"), str(inp), str(tmp / "out")),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the two ranks timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    assert not any(p.is_alive() for p in ctx.processes)
    out = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(2)]
    return out, dict(np.load(inp))


def test_two_ranks_merge_the_reference_halves(two_ranks, mesh):
    out, d = two_ranks
    halves = [_ref_search(mesh, [d[key][lo:lo + 32] for key in
                                 ("cents", "vecs", "ids", "norms")]
                          + [d["queries"]], 4, 10)
              for lo in (0, 32)]
    # the reference's own merge: (S, B, k) -> (B, S*k) -> top-k
    av = np.concatenate([h[1] for h in halves], axis=1)
    ai = np.concatenate([h[0] for h in halves], axis=1)
    vals, sel = ref_topk_smallest(jnp.asarray(av), 10)
    want_ids = np.take_along_axis(ai, np.asarray(sel), axis=1)
    for rank in range(2):
        np.testing.assert_array_equal(out[rank]["ids"], want_ids)
        np.testing.assert_allclose(out[rank]["dists"], np.asarray(vals),
                                   rtol=RTOL, atol=ATOL)


def test_two_rank_kmeans_matches_the_reference_on_all_points(two_ranks,
                                                            mesh):
    out, d = two_ranks
    with mesh:
        want = np.asarray(jax.jit(ref_kmeans_step(mesh))(
            jnp.asarray(d["x"]), jnp.asarray(d["init"])))
    for rank in range(2):
        np.testing.assert_allclose(out[rank]["cents"], want, rtol=KM_RTOL,
                                   atol=KM_ATOL)


def test_sharded_search_ranks_tool_runs_on_two_gloo_ranks(tmp_path):
    """``tools/sharded_search_ranks.py``, the several-card check of the
    sharded step's top-k, on two gloo ranks at a small size: it runs the
    step with both top-k (on the CPU both are the plain sort), every rank
    holds the same answer, and it launches no kernel."""
    out = tmp_path / "line.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "sharded_search_ranks.py"),
         "--device", "cpu", "--world", "2", "--lists", "600", "--max-len", "6",
         "--dim", "8", "--queries", "16", "--nprobe", "4", "--steps", "1",
         "--out", str(out)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(out.read_text())
    assert line["ok"] and line["world"] == 2
    assert [(r["rank"], r["lists"], r["same_bits"], r["kernel_launches"])
            for r in line["ranks"]] == [(0, 300, True, [0, 0]), (1, 300, True, [0, 0])]
