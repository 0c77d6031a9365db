"""``repro_torch.exec.batched`` on the CPU (mirrors ``tests/test_exec.py``'s
pad-to-tile section, and holds the port's batched ids to the JAX
package's)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.exec import batched as jbatched  # noqa: E402
from repro_torch.exec import (QUERY_TILE, batched_topk,  # noqa: E402
                              coalesce_scan, pad_amount, scan_topk_oracle)
from repro_torch.kernels import fused_topk  # noqa: E402


def _mk(b, n, d, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    if integer:      # small integers: float32 sums exact -> bit-exactness
        q = rng.integers(-8, 8, (b, d)).astype(np.float32)
        x = rng.integers(-8, 8, (n, d)).astype(np.float32)
    else:
        q = rng.standard_normal((b, d)).astype(np.float32)
        x = rng.standard_normal((n, d)).astype(np.float32)
    return q, x


@pytest.mark.parametrize("b", [1, 2, 5, 7, 8, 9])
def test_batched_topk_ragged_batch_ids_match_oracle_and_jax(b):
    q, x = _mk(b, 200, 32, seed=b)
    vk, ik = batched_topk(q, x, 10, device="cpu")
    vo, io = scan_topk_oracle(q, x, 10)
    assert vk.shape == (b, 10) and ik.shape == (b, 10)
    np.testing.assert_array_equal(ik, io)
    np.testing.assert_allclose(vk, vo, rtol=1e-5, atol=1e-5)
    vj, ij = jbatched.batched_topk(q, x, 10, interpret=True)
    np.testing.assert_array_equal(ik, ij)
    np.testing.assert_allclose(vk, vj, rtol=1e-5, atol=1e-5)


def test_batched_topk_k_exceeds_candidates():
    q, x = _mk(3, 5, 16, seed=1)
    vk, ik = batched_topk(q, x, 8, device="cpu")
    vo, io = scan_topk_oracle(q, x, 8)
    assert ik.shape == (3, 8)
    np.testing.assert_array_equal(ik, io)
    assert (ik[:, 5:] == -1).all() and np.isinf(vk[:, 5:]).all()
    np.testing.assert_allclose(vk[:, :5], vo[:, :5], rtol=1e-5, atol=1e-5)


def test_batched_topk_duplicate_distances_bit_exact():
    q, x = _mk(6, 80, 32, seed=2, integer=True)
    x = np.concatenate([x, x[:40]])          # 40 exact duplicates
    vk, ik = batched_topk(q, x, 10, device="cpu")
    vo, io = scan_topk_oracle(q, x, 10)
    np.testing.assert_array_equal(ik, io)
    np.testing.assert_array_equal(vk, vo)
    vj, ij = jbatched.scan_topk_oracle(q, x, 10)
    np.testing.assert_array_equal(ik, ij)
    np.testing.assert_array_equal(vk, vj)


def test_batched_topk_rows_independent_of_batchmates():
    q, x = _mk(5, 96, 16, seed=3, integer=True)
    vb, ib = batched_topk(q, x, 6, device="cpu")
    for i in range(len(q)):
        v1, i1 = batched_topk(q[i:i + 1], x, 6, device="cpu")
        np.testing.assert_array_equal(i1[0], ib[i])
        np.testing.assert_array_equal(v1[0], vb[i])


def test_batched_topk_empty_edges():
    q, x = _mk(2, 50, 16, seed=4)
    v, i = batched_topk(np.empty((0, 16), np.float32), x, 5, device="cpu")
    assert v.shape == (0, 5) and i.shape == (0, 5)
    v, i = batched_topk(q, x, 0, device="cpu")
    assert v.shape == (2, 0) and i.shape == (2, 0)
    v, i = batched_topk(q, np.empty((0, 16), np.float32), 5, device="cpu")
    assert (i == -1).all() and np.isinf(v).all()


def test_coalesce_scan_maps_global_ids():
    q, x = _mk(4, 60, 16, seed=5)
    gids = np.arange(1000, 1060, dtype=np.int64)
    out = coalesce_scan(list(q), x, gids, 7, device="cpu")
    assert len(out) == 4
    _, io = scan_topk_oracle(q, x, 7)
    jout = jbatched.coalesce_scan(list(q), x, gids, 7, interpret=True)
    for j, (dists, ids) in enumerate(out):
        np.testing.assert_array_equal(ids, gids[io[j]])
        np.testing.assert_array_equal(ids, jout[j][1])


def test_pad_amount_and_tiles():
    assert pad_amount(0, 8) == 0
    assert pad_amount(1, 8) == 7
    assert pad_amount(9, 8) == 7
    assert pad_amount(120, 128) == 8
    # the query tile is the CUDA kernel's query block
    assert QUERY_TILE == fused_topk.BLOCK_Q
    assert pad_amount(33, QUERY_TILE) == 31
