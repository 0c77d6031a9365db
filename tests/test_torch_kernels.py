"""The port's kernel entry points on the CPU against the JAX package's.

Replays ``tests/test_kernels.py``'s distance, fused top-k and ADC sweeps:
the same numpy inputs go through ``repro_torch.kernels.ops`` (CPU tensors,
so the plain PyTorch versions) and through ``repro.kernels.ops`` with
``interpret=True`` and ``repro.kernels.ref``.  Tolerances are the
reference's own: f32 rtol 1e-5/atol 1e-2, bf16 rtol 2e-2, int8 exact;
top-k values rtol 1e-4/atol 1e-3 with ids checked through distances; ADC
rtol 1e-5/atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import distance, fused_topk, ops, pq_adc  # noqa: E402
from repro_torch.kernels.ref import BIG, l2_distance_ref  # noqa: E402


def _mk(q, n, d, dtype, seed=0):
    """(numpy for JAX, torch CPU tensors) with test_kernels.py's draws."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        qs = rng.integers(-127, 128, size=(q, d)).astype(np.int8)
        xs = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        return (qs, xs), (torch.from_numpy(qs), torch.from_numpy(xs))
    if dtype == "bfloat16":
        qs = rng.normal(size=(q, d)).astype(jnp.bfloat16)
        xs = rng.normal(size=(n, d)).astype(jnp.bfloat16)
        return (qs, xs), (torch.from_numpy(qs.astype(np.float32)).bfloat16(),
                          torch.from_numpy(xs.astype(np.float32)).bfloat16())
    qs = rng.normal(size=(q, d)).astype(np.float32)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    return (qs, xs), (torch.from_numpy(qs), torch.from_numpy(xs))


def _close(got, want, dtype):
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        rtol = 2e-2 if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-2)


# ------------------------------------------------------------- distance --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("q,n,d", [
    (4, 16, 8),          # tiny, everything padded
    (128, 256, 256),     # exact tile multiples
    (100, 300, 96),      # deep-analog dims, ragged tiles
    (7, 513, 960),       # gist-analog dims, ragged everywhere
])
def test_l2_distance_matches_jax(dtype, q, n, d):
    (qj, xj), (qt, xt) = _mk(q, n, d, dtype)
    got = ops.l2_distance(qt, xt)
    assert got.shape == (q, n) and got.dtype == torch.float32
    got = got.numpy()
    _close(got, np.asarray(jops.l2_distance(jnp.asarray(qj), jnp.asarray(xj),
                                            interpret=True)), dtype)
    _close(got, np.asarray(jref.l2_distance_ref(jnp.asarray(qj),
                                                jnp.asarray(xj))), dtype)


@pytest.mark.parametrize("blocks", [(32, 32, 32), (64, 128, 64)])
def test_l2_distance_block_kwargs_do_not_change_results(blocks):
    bq, bn, bd = blocks
    (qj, xj), (qt, xt) = _mk(50, 130, 100, "float32")
    got = ops.l2_distance(qt, xt, block_q=bq, block_n=bn, block_d=bd)
    assert torch.equal(got, ops.l2_distance(qt, xt))
    want = jops.l2_distance(jnp.asarray(qj), jnp.asarray(xj), interpret=True,
                            block_q=bq, block_n=bn, block_d=bd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3)


# ----------------------------------------------------------- fused topk --

@pytest.mark.parametrize("q,n,d,k", [
    (4, 64, 32, 5),
    (128, 1024, 96, 10),
    (33, 700, 960, 10),
    (1, 2048, 128, 20),
])
def test_l2_topk_matches_jax(q, n, d, k):
    (qj, xj), (qt, xt) = _mk(q, n, d, "float32")
    vals, ids = ops.l2_topk(qt, xt, k)
    assert vals.shape == (q, k) and ids.shape == (q, k)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    jvals, _ = jops.l2_topk(jnp.asarray(qj), jnp.asarray(xj), k,
                            interpret=True)
    rvals, _ = jref.l2_topk_ref(jnp.asarray(qj), jnp.asarray(xj), k)
    for want in (jvals, rvals):
        np.testing.assert_allclose(vals.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-3)
    # ids may differ only on exact distance ties; check via distances
    d_by_id = np.take_along_axis(
        np.asarray(jref.l2_distance_ref(jnp.asarray(qj), jnp.asarray(xj))),
        ids.numpy().astype(np.int64), axis=1)
    np.testing.assert_allclose(d_by_id, np.asarray(rvals),
                               rtol=1e-4, atol=1e-3)


def test_l2_topk_ids_unique_and_sorted():
    _, (qt, xt) = _mk(16, 512, 64, "float32", seed=3)
    vals, ids = ops.l2_topk(qt, xt, 10)
    vals, ids = vals.numpy(), ids.numpy()
    for r in range(16):
        assert len(np.unique(ids[r])) == 10
        assert (np.diff(vals[r]) >= -1e-6).all()


def test_l2_topk_block_sweep():
    (qj, xj), (qt, xt) = _mk(40, 333, 100, "float32", seed=4)
    rvals, _ = jref.l2_topk_ref(jnp.asarray(qj), jnp.asarray(xj), 10)
    for bq, bn in [(16, 64), (64, 128), (128, 512)]:
        vals, _ = ops.l2_topk(qt, xt, 10, block_q=bq, block_n=bn)
        np.testing.assert_allclose(vals.numpy(), np.asarray(rvals),
                                   rtol=1e-4, atol=1e-3)


def test_l2_topk_duplicate_rows_take_lower_ids_first():
    x = np.ones((6, 16), np.float32)
    q = np.ones((2, 16), np.float32)
    _, ids = ops.l2_topk(torch.from_numpy(q), torch.from_numpy(x), 4)
    _, jids = jops.l2_topk(jnp.asarray(q), jnp.asarray(x), 4, interpret=True)
    assert ids.tolist() == [[0, 1, 2, 3]] * 2
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_l2_topk_k_exceeds_n_tail_matches_pallas():
    (qj, xj), (qt, xt) = _mk(3, 5, 8, "float32", seed=5)
    vals, ids = ops.l2_topk(qt, xt, 10)
    jvals, jids = jops.l2_topk(jnp.asarray(qj), jnp.asarray(xj), 10,
                               interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert (ids[:, 5:] == -1).all()
    assert (vals[:, 5:] == torch.tensor(BIG, dtype=torch.float32)).all()
    np.testing.assert_array_equal(vals.numpy()[:, 5:], np.asarray(jvals)[:, 5:])
    np.testing.assert_allclose(vals.numpy()[:, :5], np.asarray(jvals)[:, :5],
                               rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------------ ADC --

@pytest.mark.parametrize("codes_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,m", [(10, 8), (1024, 48), (2000, 112), (3, 120)])
def test_adc_lookup_matches_jax(n, m, codes_dtype):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, size=(n, m)).astype(codes_dtype)
    table = rng.random((m, 256)).astype(np.float32)
    got = ops.adc_lookup(torch.from_numpy(codes), torch.from_numpy(table))
    assert got.shape == (n,) and got.dtype == torch.float32
    for want in (jops.adc_lookup(jnp.asarray(codes), jnp.asarray(table),
                                 interpret=True),
                 jref.adc_lookup_ref(jnp.asarray(codes), jnp.asarray(table))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


def test_adc_lookup_block_n_ignored_and_empty():
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 256, (300, 16)).astype(np.uint8))
    table = torch.from_numpy(rng.random((16, 256)).astype(np.float32))
    assert torch.equal(ops.adc_lookup(codes, table, block_n=64),
                       ops.adc_lookup(codes, table))
    out = ops.adc_lookup(codes[:0], table)
    assert out.shape == (0,) and out.dtype == torch.float32


def test_adc_lookup_integer_table_is_exact():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 256, (500, 48)).astype(np.uint8)
    table = rng.integers(0, 1000, (48, 256)).astype(np.float32)
    got = ops.adc_lookup(torch.from_numpy(codes), torch.from_numpy(table))
    want = table[np.arange(48)[None, :], codes.astype(np.int64)].astype(
        np.int64).sum(1)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


# ------------------------------------------------------------ dispatch --

def test_l2_topk_k_bounds_raise():
    _, (qt, xt) = _mk(2, 8, 4, "float32")
    for k in (0, fused_topk.K_MAX + 1):
        with pytest.raises(ValueError):
            ops.l2_topk(qt, xt, k)


def test_ops_raise_for_tensors_neither_cuda_nor_cpu():
    q = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError):
        ops.l2_distance(q, q)
    with pytest.raises(ValueError):
        ops.l2_topk(q, q, 1)
    with pytest.raises(TypeError):
        ops.l2_distance(torch.zeros(2, 4), torch.zeros(2, 4), tile=8)
    with pytest.raises(ValueError):
        ops.adc_lookup(torch.zeros((2, 4), dtype=torch.uint8, device="meta"),
                       torch.zeros((4, 256), device="meta"))
    with pytest.raises(ValueError):   # mixed devices
        ops.adc_lookup(torch.zeros((2, 4), dtype=torch.uint8),
                       torch.zeros((4, 256), device="meta"))
    with pytest.raises(TypeError):
        ops.adc_lookup(torch.zeros((2, 4), dtype=torch.uint8),
                       torch.zeros((4, 256)), block_m=8)


def test_kernel_wrappers_refuse_cpu_tensors():
    # on a CPU tensor only ops routes to the plain version; the CUDA
    # wrappers themselves launch or raise, and never count a launch
    _, (qt, xt) = _mk(2, 8, 4, "float32")
    codes = torch.zeros((3, 4), dtype=torch.uint8)
    table = torch.zeros((4, 256))
    before = (distance.l2_distance.launches, fused_topk.l2_topk.launches,
              pq_adc.adc_lookup.launches)
    with pytest.raises(ValueError):
        distance.l2_distance(qt, xt)
    with pytest.raises(ValueError):
        fused_topk.l2_topk(qt, xt, 2)
    with pytest.raises(ValueError):
        pq_adc.adc_lookup(codes, table)
    ops.l2_distance(qt, xt)
    ops.l2_topk(qt, xt, 2)
    ops.adc_lookup(codes, table)
    assert (distance.l2_distance.launches, fused_topk.l2_topk.launches,
            pq_adc.adc_lookup.launches) == before


def test_plain_int8_distance_is_exact():
    rng = np.random.default_rng(1)
    qs = rng.integers(-127, 128, size=(3, 200)).astype(np.int8)
    xs = rng.integers(-127, 128, size=(50, 200)).astype(np.int8)
    got = l2_distance_ref(torch.from_numpy(qs), torch.from_numpy(xs))
    want = ((qs.astype(np.int64)[:, None, :]
             - xs.astype(np.int64)[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("Q,N,k,sms,want_s", [
    # closure step, wide: 32 query blocks; 2 x 132 resident / 32 = 8
    (4096, 214_000, 8, 132, 8),
    # ground truth, wide: 4 query blocks; 264 / 4 = 66, capped at MAX_SPLIT
    (512, 1_000_000, 10, 132, 64),
    # batched_topk, narrow: 100 rows are one 256-row tile
    (8, 100, 10, 132, 1),
    # many query blocks: no split
    (100_000, 50, 10, 132, 1),
    # no rows
    (4, 0, 10, 132, 1),
])
def test_split_count_fills_one_wave_and_covers_every_row(Q, N, k, sms, want_s):
    v = fused_topk.pick_variant(Q, 96, k)
    s, span = fused_topk.split_count(Q, N, sms, v)
    assert s == want_s
    assert span % v.block_n == 0 and s <= fused_topk.MAX_SPLIT
    assert s * span >= N and (s - 1) * span < max(N, 1)


@pytest.mark.parametrize("Q,D,k,want", [
    (128, 96, 8, "wide"),      # a full wide query block
    (127, 96, 8, "narrow"),    # below it: 32-query blocks pad less
    (4096, 96, 33, "narrow"),  # k above the wide lists
    (4096, 256, 32, "wide"),   # the wide variant's largest D and k
    (4096, 257, 8, "narrow"),  # D too large for resident wide queries
    (8, 960, 128, "narrow"),   # a small batch at GIST's D and K_MAX
    (4096, 2000, 8, "narrow"),  # past the resident depth: streamed queries
])
def test_pick_variant_by_q_d_and_k(Q, D, k, want):
    v = fused_topk.pick_variant(Q, D, k)
    assert v is {"wide": fused_topk.WIDE, "narrow": fused_topk.NARROW}[want]
    # only the narrow variant takes a D past its resident depth
    assert k <= v.k_max and (D <= v.max_d or v is fused_topk.NARROW)
    # the wide block is whole narrow blocks, so a batch padded to the
    # narrow tile never pads again for the wide one
    assert fused_topk.WIDE.block_q % fused_topk.NARROW.block_q == 0


def test_split_count_per_variant_at_small_and_large_q():
    # narrow at Q = 127: 4 query blocks, 264 / 4 = 66 -> 64 ranges of
    # 256-row tiles; wide at Q = 128: 1 query block -> 64 ranges
    for Q, v in ((127, fused_topk.NARROW), (128, fused_topk.WIDE)):
        s, span = fused_topk.split_count(Q, 1_000_000, 132, v)
        assert (s, span % v.block_n) == (64, 0)
        assert s * span >= 1_000_000 > (s - 1) * span


@pytest.mark.parametrize("per_sm,want_s", [
    (None, 33),   # the variant's 2 blocks an SM: 264 / 8 query blocks
    (2, 33),
    (1, 16),      # one block an SM (large resident queries): 132 / 8
])
def test_split_count_follows_the_blocks_an_sm_holds(per_sm, want_s):
    # 256 queries at k = 33 run narrow: 8 query blocks over 3,907 row tiles
    v = fused_topk.pick_variant(256, 96, 33)
    assert v is fused_topk.NARROW
    s, span = fused_topk.split_count(256, 1_000_000, 132, v, per_sm)
    assert s == want_s and span % v.block_n == 0
    assert s * span >= 1_000_000 > (s - 1) * span


# ------------------------------------------------- l2_distance variants --

@pytest.mark.parametrize("Q,D,dtype,want", [
    (512, 96, torch.float32, "wide"),       # the centroid probe
    (128, 96, torch.float32, "wide"),       # one full wide query block
    (127, 96, torch.float32, "simple"),     # below it: 64-query tiles pad less
    (4096, 256, torch.bfloat16, "wide"),    # bf16 is widened; the largest resident D
    (4096, 1, torch.float32, "wide"),       # the smallest D
    (4096, 257, torch.float32, "simple"),   # past the resident depth
    (4096, 0, torch.float32, "simple"),     # no depth at all
    (4096, 96, torch.int8, "simple"),       # int8 stays exact in int32
])
def test_l2_distance_pick_variant_by_q_d_and_dtype(Q, D, dtype, want):
    v = distance.pick_variant(Q, D, dtype)
    assert v is distance.VARIANTS[want]
    assert distance.takes(v, D, dtype)


@pytest.mark.parametrize("Q,N,sms,per_sm,want_s", [
    (512, 214_790, 132, 2, 65),    # the probe: 4 query blocks, 66 ranges of 26 tiles cover N in 65
    (512, 214_790, 132, 1, 33),    # one block an SM: 132 / 4 query blocks
    (4096, 214_790, 132, 2, 8),    # 32 query blocks: 264 / 32
    (128, 1000, 132, 2, 8),        # fewer tiles than the wave: a range a tile
    (256, 129, 132, 2, 2),         # a ragged last tile
    (100_000, 5000, 132, 2, 1),    # more query blocks than a wave holds
])
def test_l2_distance_ranges_cover_every_row_once(Q, N, sms, per_sm, want_s):
    s, span = distance.split_count(Q, N, sms, per_sm)
    assert s == want_s and span % distance.WIDE.block_n == 0
    seen = np.zeros(N, dtype=np.int64)
    for r in range(s):
        lo, hi = r * span, min(N, (r + 1) * span)
        assert hi > lo                      # no range is empty
        seen[lo:hi] += 1
    assert (seen == 1).all()
    q_blocks = -(-Q // distance.WIDE.block_q)
    assert s == 1 or q_blocks * s <= per_sm * sms   # one wave at most


def test_l2_distance_plan_forces_and_refuses_variants():
    # the simple kernel's plan needs no card: one grid over all rows
    assert distance.plan(512, 1000, 96, 0, variant="simple") == distance.Plan(
        distance.SIMPLE, 1, 1000)
    assert distance.plan(4, 1000, 960, 0) == distance.Plan(distance.SIMPLE, 1, 1000)
    with pytest.raises(ValueError):      # past the wide variant's resident depth
        distance.plan(512, 1000, 257, 0, variant="wide")
    with pytest.raises(ValueError):      # int8 runs only the exact int32 body
        distance.plan(512, 1000, 96, 0, torch.int8, variant="wide")
    with pytest.raises(ValueError):
        distance.plan(512, 1000, 96, 0, variant="tiled")
