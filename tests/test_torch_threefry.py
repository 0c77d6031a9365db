"""The port's numpy ``jax.random`` draws (``repro_torch.core.threefry``)
against ``jax.random`` itself, bit for bit.

Each piece is held on its own before the whole draw: the key from a seed,
the Threefry-2x32 hash, ``split``, 32-bit random bits, ``choice`` without
replacement, and the PQ trainer's (m, k) init rows.  The sweep covers
n = k, k = 1, the two shuffle rounds from n = 2**11 up, and seeds at and
above 2**31 and 2**32 and below zero.  Only this test imports JAX.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro_torch.core import threefry as tf  # noqa: E402

SEEDS = [0, 1, 5, 42, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1, 2**32 + 7,
         -1, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_seed_is_prng_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    got = tf.threefry_seed(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", [(0, 0), (0, 42), (123456789, 987654321),
                                 (0xFFFFFFFF, 0xFFFFFFFF)])
def test_threefry2x32_is_the_hash(key):
    k = np.asarray(key, np.uint32)
    x0 = np.arange(37, dtype=np.uint32) * np.uint32(2654435761)
    x1 = np.arange(37, dtype=np.uint32)[::-1].copy()
    want = jprng.threefry2x32_p.bind(k[0], k[1], x0, x1)
    got = tf.threefry2x32(k, x0, x1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed", SEEDS[:6])
@pytest.mark.parametrize("num", [1, 2, 3, 48, 120])
def test_split_is_jax_split(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    np.testing.assert_array_equal(tf.split(tf.threefry_seed(seed), num), want)


@pytest.mark.parametrize("seed", SEEDS[:6])
@pytest.mark.parametrize("size", [1, 2, 7, 1000, 20000])
def test_random_bits_are_jax_bits(seed, size):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.bits(key, (size,), dtype=np.uint32))
    got = tf.random_bits(tf.threefry_seed(seed), size)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,k", [(1, 1), (5, 1), (5, 5), (50, 50),
                                 (300, 16), (2047, 256), (2048, 256),
                                 (20000, 256), (20000, 1)])
def test_choice_without_replacement_is_jax_choice(seed, n, k):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.choice(key, n, shape=(k,), replace=False))
    got = tf.choice_without_replacement(tf.threefry_seed(seed), n, k)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == k


def test_choice_refuses_more_than_n():
    with pytest.raises(ValueError):
        tf.choice_without_replacement(tf.threefry_seed(0), 3, 4)


@pytest.mark.parametrize("seed,m,n,k", [(0, 48, 20000, 256), (7, 4, 300, 16),
                                        (3, 3, 50, 50), (2**31 + 1, 8, 600, 1),
                                        (5, 1, 256, 256)])
def test_pq_init_idx_is_the_reference_kmeans_init(seed, m, n, k):
    """``repro/core/kmeans.py:112-114``: vmap(choice) over split(key, m)."""
    want = np.asarray(jax.vmap(
        lambda kk: jax.random.choice(kk, n, shape=(k,), replace=False)
    )(jax.random.split(jax.random.PRNGKey(seed), m)))
    got = tf.pq_init_idx(seed, m, n, k)
    assert got.shape == (m, k) and got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
