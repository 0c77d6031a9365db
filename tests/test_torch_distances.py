"""``repro_torch.core.distances`` on the CPU against ``repro.core.distances``
(mirrors ``tests/test_distances.py``, plus the tie order of top-k and the
routing of ``ops.topk_smallest``: a CPU tensor to the plain stable sort, a
fake tensor to the custom op's shapes)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import distances as jd  # noqa: E402
from repro_torch.core.distances import (np_sq_l2, pairwise,  # noqa: E402
                                        pairwise_neg_ip, pairwise_sq_l2,
                                        topk_smallest)
from repro_torch.kernels import ops, ref, topk_select  # noqa: E402


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("q,n,d", [(4, 64, 16), (1, 7, 960), (8, 128, 100)])
def test_pairwise_matches_numpy_and_jax(dtype, q, n, d):
    rng = np.random.default_rng(0)
    if dtype == np.int8:
        qs = rng.integers(-127, 128, size=(q, d)).astype(np.int8)
        xs = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    else:
        qs = rng.normal(size=(q, d)).astype(np.float32)
        xs = rng.normal(size=(n, d)).astype(np.float32)
    got = pairwise_sq_l2(torch.from_numpy(qs), torch.from_numpy(xs)).numpy()
    rtol = 1e-5 if dtype == np.float32 else 0.0
    np.testing.assert_allclose(got, np_sq_l2(qs, xs), rtol=rtol, atol=1e-2)
    want = np.asarray(jd.pairwise_sq_l2(jnp.asarray(qs), jnp.asarray(xs)))
    if dtype == np.int8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)


def test_int8_exact_integer_arithmetic():
    rng = np.random.default_rng(1)
    qs = rng.integers(-127, 128, size=(3, 200)).astype(np.int8)
    xs = rng.integers(-127, 128, size=(50, 200)).astype(np.int8)
    got = pairwise_sq_l2(torch.from_numpy(qs), torch.from_numpy(xs)).numpy()
    want = ((qs.astype(np.int64)[:, None, :]
             - xs.astype(np.int64)[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_mixed_float_dtypes_widen_and_int8_pairs_refuse():
    rng = np.random.default_rng(5)
    qs = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(9, 16)).astype(np.float32))
    xb = xs.bfloat16()
    np.testing.assert_array_equal(pairwise_sq_l2(qs, xb).numpy(),
                                  pairwise_sq_l2(qs, xb.float()).numpy())
    with pytest.raises(TypeError):
        pairwise_sq_l2(qs, xs.to(torch.int8))


def test_neg_ip():
    rng = np.random.default_rng(2)
    qs = rng.normal(size=(5, 32)).astype(np.float32)
    xs = rng.normal(size=(11, 32)).astype(np.float32)
    got = pairwise_neg_ip(torch.from_numpy(qs), torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, -(qs @ xs.T), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jd.pairwise_neg_ip(jnp.asarray(qs), jnp.asarray(xs))),
        rtol=1e-5, atol=1e-5)


def test_pairwise_dispatches_on_metric():
    rng = np.random.default_rng(6)
    qs = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    assert torch.equal(pairwise(qs, qs, "l2"), pairwise_sq_l2(qs, qs))
    assert torch.equal(pairwise(qs, qs, "ip"), pairwise_neg_ip(qs, qs))
    with pytest.raises(ValueError):
        pairwise(qs, qs, "cos")


def test_topk_smallest():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(6, 40)).astype(np.float32)
    vals, idx = topk_smallest(torch.from_numpy(d), 5)
    want = np.sort(d, axis=1)[:, :5]
    np.testing.assert_allclose(vals.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(
        np.take_along_axis(d, idx.numpy(), axis=1), vals.numpy())
    jvals, jidx = jd.topk_smallest(jnp.asarray(d), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_topk_smallest_ties_take_lower_index_first():
    # equal distances at indices 1, 2, 3 and 5: jax.lax.top_k gives the
    # lower indices first; torch.topk's tie order is unspecified
    d = np.array([[9.0, 1.0, 1.0, 1.0, 7.0, 1.0, 8.0],
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    vals, idx = topk_smallest(torch.from_numpy(d), 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2]]
    _, jidx = jd.topk_smallest(jnp.asarray(d), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert vals.tolist() == [[1.0] * 3, [2.0] * 3]


@pytest.mark.parametrize("shape,k", [((6, 40), 5), ((3, 4, 70), 16), ((9,), 9),
                                     ((2, 640), 40), ((1, 1), 1)])
def test_ops_topk_smallest_on_the_cpu_is_the_plain_version(shape, k):
    # small integers: ties everywhere, lower index first as jax.lax.top_k
    rng = np.random.default_rng(sum(shape) + k)
    d = rng.integers(0, 4, size=shape).astype(np.float32)
    d[..., ::7] = np.inf
    before = topk_select.topk_smallest.launches
    vals, idx = ops.topk_smallest(torch.from_numpy(d), k)
    assert topk_select.topk_smallest.launches == before
    want_v, want_i = ref.stable_topk_smallest(torch.from_numpy(d), k)
    assert idx.dtype == torch.int64 and torch.equal(idx, want_i)
    assert torch.equal(vals, want_v)
    assert topk_smallest is ops.topk_smallest
    jvals, jidx = jd.topk_smallest(jnp.asarray(d), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_ops_topk_smallest_on_fake_tensors_launches_nothing(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def boom(*a, **kw):
        raise AssertionError("a fake tensor reached a top-k")
    monkeypatch.setattr(topk_select, "topk_smallest", boom)
    monkeypatch.setattr(ref, "stable_topk_smallest", boom)
    with FakeTensorMode(allow_non_fake_inputs=True):
        for device in ("cpu", "cuda"):
            d = torch.empty((500, 19_700), device=device)
            vals, idx = ops.topk_smallest(d, 16)
            assert (vals.shape, vals.dtype, idx.shape, idx.dtype) == (
                (500, 16), torch.float32, (500, 16), torch.int64)
            vals, idx = ops.topk_smallest(torch.empty((2, 3, 40), device=device), 10)
            assert vals.shape == idx.shape == (2, 3, 10)
        with pytest.raises(TypeError):       # the kernel takes float32 only
            ops.topk_smallest(torch.empty((4, 9), device="cuda",
                                          dtype=torch.float64), 3)
        with pytest.raises(ValueError):      # nor k past N on the card
            ops.topk_smallest(torch.empty((4, 9), device="cuda"), 10)


def test_ops_topk_smallest_refuses_other_devices():
    with pytest.raises(ValueError):
        ops.topk_smallest(torch.empty((3, 8), device="meta"), 2)
    with pytest.raises(ValueError):
        topk_select.topk_smallest(torch.zeros((3, 8)), 2)


def test_self_distance_zero():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(10, 64)).astype(np.float32))
    d = pairwise_sq_l2(x, x).numpy()
    np.testing.assert_allclose(np.diag(d), 0.0, atol=1e-3)
    assert (d >= 0).all()


def test_np_sq_l2_copy_is_the_reference_to_the_bit():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(4, 33)).astype(np.float32)
    x = rng.normal(size=(20, 33)).astype(np.float32)
    np.testing.assert_array_equal(np_sq_l2(q, x), jd.np_sq_l2(q, x))
    np.testing.assert_array_equal(np_sq_l2(q[0], x), jd.np_sq_l2(q[0], x))
