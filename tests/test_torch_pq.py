"""The port's PQ training and ADC (``repro_torch.core.{kmeans,pq}``) on the
CPU against the JAX package's.

The reference initialises ``kmeans_batched`` with ``jax.random.choice``;
the port draws the same rows in numpy (``repro_torch.core.threefry``) by
default, and the tests also hand it indices recomputed with ``jax.random``.
On integer-valued data the products are exact, so both sides give equal
assignments and centroids within 1e-5; on random data the codebooks agree
within f32 rtol 1e-5.  Mirrors ``tests/test_pq.py``'s properties on the
port's own training.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kmeans as jkm  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro_torch.core.distances import np_sq_l2  # noqa: E402
from repro_torch.core.kmeans import kmeans_batched  # noqa: E402
from repro_torch.core.pq import (KSUB, ProductQuantizer,  # noqa: E402
                                 default_pq_dims, train_pq)


def _jax_init_idx(seed: int, m: int, n: int, k: int) -> np.ndarray:
    """The reference's init draw (``repro/core/kmeans.py:112-115``)."""
    key = jax.random.PRNGKey(seed)
    return np.asarray(jax.vmap(
        lambda kk: jax.random.choice(kk, n, shape=(k,), replace=False)
    )(jax.random.split(key, m)))


def _int_data(shape, seed=0):
    return np.random.default_rng(seed).integers(-8, 8, shape).astype(np.float32)


@pytest.mark.parametrize("m,n,d,k,iters", [(4, 300, 4, 16, 5),
                                           (3, 50, 2, 64, 3),
                                           (2, 1000, 8, 256, 4)])
def test_kmeans_batched_matches_jax_given_its_init(m, n, d, k, iters):
    x = _int_data((m, n, d), seed=n)
    cj, aj = jkm.kmeans_batched(jax.random.PRNGKey(7), jnp.asarray(x), k,
                                iters=iters)
    init = _jax_init_idx(7, m, n, min(k, n))
    ct, at = kmeans_batched(torch.from_numpy(x), k, iters=iters,
                            init_idx=init)
    assert ct.shape == (m, min(k, n), d) and at.shape == (m, n)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)


def test_kmeans_batched_generator_draw_is_seeded_and_keeps_empty_clusters():
    """The default draw (the reference's, from ``seed``) repeats."""
    x = np.zeros((2, 40, 3), np.float32)
    x[:, 20:] = 1.0                       # two distinct points, k = 8
    xt = torch.from_numpy(x)
    c1, a1 = kmeans_batched(xt, 8, iters=3, seed=3)
    c2, a2 = kmeans_batched(xt, 8, iters=3, seed=3)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    # every centroid is one of the two points: the ones that lost all
    # members kept their init row
    assert set(np.unique(c1.numpy())) <= {0.0, 1.0}
    with pytest.raises(ValueError):
        kmeans_batched(xt, 8, init_idx=np.zeros((2, 7), np.int64))


@pytest.mark.parametrize("m,n,d,k,iters,seed", [(4, 300, 4, 16, 5, 7),
                                                (3, 50, 2, 64, 3, 0),
                                                (2, 1000, 8, 256, 4, 2**31 + 3)])
def test_kmeans_batched_default_draw_is_the_reference_draw(m, n, d, k, iters,
                                                           seed):
    x = _int_data((m, n, d), seed=n)
    cj, aj = jkm.kmeans_batched(jax.random.PRNGKey(seed), jnp.asarray(x), k,
                                iters=iters)
    ct, at = kmeans_batched(torch.from_numpy(x), k, iters=iters, seed=seed)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,dim,m,seed", [(3000, 96, 48, 0), (800, 100, 48, 1),
                                          (25000, 32, 8, 5)])
def test_train_pq_default_draw_gives_the_reference_codebooks(n, dim, m, seed):
    """Random (not integer-valued) rows: the Lloyd steps round in f32 on
    both sides, so the codebooks agree within f32 rtol 1e-5 and the codes
    are equal."""
    x = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    ref = jpq.train_pq(x, m, iters=6, seed=seed)
    got = train_pq(x, m, iters=6, seed=seed, device="cpu")
    np.testing.assert_allclose(got.codebooks, ref.codebooks, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.encode(x[:500]), ref.encode(x[:500]))


@pytest.mark.parametrize("n,dim,m,sample", [(600, 16, 8, 500),
                                            (300, 20, 8, 20000)])
def test_train_pq_matches_jax_given_its_init(n, dim, m, sample):
    x = _int_data((n, dim), seed=dim)
    ref = jpq.train_pq(x, m, iters=4, sample=sample, seed=5)
    init = _jax_init_idx(5, m, min(n, sample), min(KSUB, n, sample))
    got = train_pq(x, m, iters=4, sample=sample, seed=5, device="cpu",
                   init_idx=init)
    assert got.dim == ref.dim and got.codebooks.shape == ref.codebooks.shape
    np.testing.assert_allclose(got.codebooks, ref.codebooks,
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def converted():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(800, 96)).astype(np.float32)
    ref = jpq.train_pq(x, m=48, iters=4, seed=0)
    port = ProductQuantizer(codebooks=np.array(ref.codebooks), dim=ref.dim)
    return x, ref, port


def test_encode_decode_adc_to_the_bit_on_a_converted_quantizer(converted):
    x, ref, port = converted
    codes = port.encode(x)
    np.testing.assert_array_equal(codes, ref.encode(x))
    np.testing.assert_array_equal(port.decode(codes), ref.decode(codes))
    for q in x[:5]:
        table = port.adc_table(q)
        np.testing.assert_array_equal(table, ref.adc_table(q))
        np.testing.assert_array_equal(port.adc_lookup(codes, table),
                                      ref.adc_lookup(codes, table))


def test_adc_lookup_dev_matches_host_lookup(converted):
    x, ref, port = converted
    codes = port.encode(x)
    table = port.adc_table(x[3])
    got = port.adc_lookup_dev(torch.from_numpy(codes), torch.from_numpy(table))
    assert got.dtype == torch.float32 and got.shape == (len(x),)
    np.testing.assert_allclose(got.numpy(), ref.adc_lookup(codes, table),
                               rtol=1e-5, atol=1e-4)


# ------------------------------------------- test_pq.py's properties --

@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 64))
    x = (centers[rng.integers(0, 16, 2000)]
         + rng.normal(0, 0.2, size=(2000, 64))).astype(np.float32)
    return x, train_pq(x, m=8, iters=8, seed=0, device="cpu")


def test_pq_shapes(trained):
    x, pq = trained
    assert pq.m == 8 and pq.dsub == 8
    codes = pq.encode(x[:100])
    assert codes.shape == (100, 8) and codes.dtype == np.uint8


def test_pq_reconstruction_beats_mean(trained):
    x, pq = trained
    rec = pq.decode(pq.encode(x))
    err = ((x - rec) ** 2).sum(1).mean()
    base = ((x - x.mean(0)) ** 2).sum(1).mean()
    assert err < 0.35 * base


def test_adc_equals_distance_to_reconstruction(trained):
    x, pq = trained
    codes = pq.encode(x[:200])
    rec = pq.decode(codes)
    q = x[500]
    table = pq.adc_table(q)
    exact = np_sq_l2(q, rec)
    np.testing.assert_allclose(pq.adc_lookup(codes, table), exact,
                               rtol=1e-4, atol=1e-3)
    dev = pq.adc_lookup_dev(torch.from_numpy(codes), torch.from_numpy(table))
    np.testing.assert_allclose(dev.numpy(), exact, rtol=1e-4, atol=1e-3)


def test_adc_preserves_global_ordering(trained):
    x, pq = trained
    codes = pq.encode(x)
    q = x[123] + np.random.default_rng(1).normal(0, 0.05, 64).astype(np.float32)
    adc = pq.adc_lookup(codes, pq.adc_table(q))
    exact = np_sq_l2(q, x)
    r_adc = np.argsort(np.argsort(adc)).astype(np.float64)
    r_ex = np.argsort(np.argsort(exact)).astype(np.float64)
    assert np.corrcoef(r_adc, r_ex)[0, 1] > 0.9
    top100 = set(np.argsort(adc)[:100].tolist())
    top20 = set(np.argsort(exact)[:20].tolist())
    assert len(top100 & top20) >= 14


def test_pq_padding_non_divisible_dim():
    x = np.random.default_rng(0).normal(size=(500, 100)).astype(np.float32)
    pq = train_pq(x, m=48, iters=3, seed=0, device="cpu")
    assert pq.decode(pq.encode(x[:10])).shape == (10, 100)


def test_tiny_dataset_codebook_is_padded_to_256():
    x = _int_data((40, 8))
    pq = train_pq(x, m=4, iters=2, seed=0, device="cpu")
    assert pq.codebooks.shape == (4, KSUB, 2)


def test_default_pq_dims():
    for dim in (960, 96, 128, 32, 100):
        assert default_pq_dims(dim) == jpq.default_pq_dims(dim)
    assert default_pq_dims(960) == 120
