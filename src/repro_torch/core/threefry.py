"""The reference's ``jax.random`` draws, in numpy uint32 arithmetic.

The JAX package seeds its PQ k-means init with ``jax.random``
(``repro.core.kmeans.kmeans_batched``: ``split(PRNGKey(seed), m)``, then
``choice(kk, n, (k,), replace=False)`` under ``vmap``).  This module
computes the same numbers without JAX, following jax 0.9.0's defaults:
the ``threefry2x32`` implementation, ``jax_threefry_partitionable`` on and
64-bit mode off.

* :func:`threefry_seed` — ``PRNGKey(seed)``'s two words.
* :func:`threefry2x32` — the Threefry-2x32 block cipher, 20 rounds.
* :func:`split` — ``jax.random.split`` (the partitionable, fold-like form:
  the key hashes the hi and lo words of a uint64 iota).
* :func:`random_bits` — 32-bit ``_random_bits`` (``bits1 ^ bits2`` over the
  same counters).
* :func:`choice_without_replacement` — ``choice(key, n, (k,),
  replace=False)``: ``permutation(key, n)[:k]``, whose shuffle sorts by
  fresh 32-bit keys, stably, ``ceil(3 ln n / ln(2^32 - 1))`` times.
* :func:`pq_init_idx` — the PQ trainer's (m, k) init rows.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry_seed(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as a (2,) uint32 key.

    With 64-bit mode off the seed is taken as an int32, so the high word is
    0 and the low word is ``seed mod 2**32``.
    """
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=_U32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs ``(x0, x1)`` under
    ``key``: five groups of four rounds, a key injection after each."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(_PARITY))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _iota_2x32(size: int) -> tuple[np.ndarray, np.ndarray]:
    """The hi and lo words of ``arange(size, dtype=uint64)``."""
    c = np.arange(size, dtype=np.uint64)
    return (c >> np.uint64(32)).astype(_U32), c.astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: a (num, 2) uint32 array of keys."""
    b0, b1 = threefry2x32(key, *_iota_2x32(num))
    return np.stack([b0, b1], axis=1)


def random_bits(key: np.ndarray, size: int) -> np.ndarray:
    """32-bit ``jax.random.bits(key, (size,))``."""
    b0, b1 = threefry2x32(key, *_iota_2x32(size))
    return b0 ^ b1


def choice_without_replacement(key: np.ndarray, n: int, k: int) -> np.ndarray:
    """``jax.random.choice(key, n, (k,), replace=False)`` as int32."""
    if not 0 < k <= n:
        raise ValueError(f"cannot draw {k} of {n} without replacement")
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(_U32).max)))
    x = np.arange(n, dtype=np.int32)
    for _ in range(rounds):
        key, subkey = split(key)
        x = x[np.argsort(random_bits(subkey, n), kind="stable")]
    return x[:k]


def pq_init_idx(seed: int, m: int, n: int, k: int) -> np.ndarray:
    """The reference PQ trainer's init rows: one draw of k of n for each of
    m subquantizers, from ``split(PRNGKey(seed), m)``.  (m, k) int64."""
    keys = split(threefry_seed(seed), m)
    return np.stack([choice_without_replacement(kk, n, k)
                     for kk in keys]).astype(np.int64)

