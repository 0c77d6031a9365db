"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device these skip (CPU parity lives in
``test_torch_kernels.py``).  Run on a machine with an H100 and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (_build, distance, fused_topk, ops,  # noqa: E402
                                 pq_adc, topk_select)
from repro_torch.kernels.ref import (adc_lookup_ref, l2_distance_ref,  # noqa: E402
                                     l2_topk_ref, stable_topk_smallest)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    _build.build_all()
    return torch.device("cuda")


def _mk(q, n, d, dtype, dev, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        qs = rng.integers(-127, 128, size=(q, d)).astype(np.int8)
        xs = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
        return torch.from_numpy(qs).to(dev), torch.from_numpy(xs).to(dev)
    if integer:
        qs = rng.integers(-8, 8, size=(q, d)).astype(np.float32)
        xs = rng.integers(-8, 8, size=(n, d)).astype(np.float32)
    else:
        qs = rng.normal(size=(q, d)).astype(np.float32)
        xs = rng.normal(size=(n, d)).astype(np.float32)
    qt, xt = torch.from_numpy(qs).to(dev), torch.from_numpy(xs).to(dev)
    if dtype == "bfloat16":
        qt, xt = qt.bfloat16(), xt.bfloat16()
    return qt, xt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("q,n,d", [(4, 16, 8), (128, 256, 256),
                                   (100, 300, 96), (7, 513, 960),
                                   (1, 1, 1), (65, 130, 17)])
def test_l2_distance_kernel_matches_plain(dev, dtype, q, n, d):
    qs, xs = _mk(q, n, d, dtype, dev)
    before = distance.l2_distance.launches
    got = ops.l2_distance(qs, xs)
    torch.cuda.synchronize()
    assert distance.l2_distance.launches == before + 1
    want = l2_distance_ref(qs, xs)
    assert got.shape == (q, n) and got.dtype == torch.float32
    if dtype == "int8":
        assert torch.equal(got, want)
    else:
        # bf16 is widened to f32 on both sides: the same f32 tolerance
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


_DIST_SHAPES = [(4, 16, 8), (128, 256, 256), (100, 300, 96), (7, 513, 960),
                (1, 1, 1), (65, 130, 17)]
# Q on both sides of the wide query block (128) and two of them; N on both
# sides of a row tile; D from 1 past one and two depth slices to the wide
# variant's largest resident depth
_DIST_EDGES = [(q, n, d) for q in (127, 128, 129, 255) for n in (127, 128, 129)
               for d in (1, 16, 17, 96, 256)]


@pytest.mark.parametrize("variant", ["wide", "simple"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,n,d", [s for s in _DIST_SHAPES if s[2] <= 256]
                         + _DIST_EDGES)
def test_l2_distance_kernel_variants_match_plain(dev, variant, dtype, q, n, d):
    qs, xs = _mk(q, n, d, dtype, dev, seed=q + n + d)
    before = distance.l2_distance.launches
    got = distance.l2_distance(qs, xs, variant=variant)
    torch.cuda.synchronize()
    assert distance.l2_distance.launches == before + 1
    assert got.shape == (q, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, l2_distance_ref(qs, xs), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q,n,d", [(128, 1000, 96), (300, 5000, 96),
                                   (512, 20000, 96), (129, 777, 17),
                                   (256, 4099, 256), (200, 3001, 1)])
def test_l2_distance_kernel_variants_give_the_same_bits(dev, dtype, q, n, d):
    # one fmaf chain a product over d in order, the same sequential norms
    # and the same combine: random inputs give identical f32 bits
    qs, xs = _mk(q, n, d, dtype, dev, seed=11)
    assert distance.pick_variant(q, d, qs.dtype) is distance.WIDE
    wide = distance.l2_distance(qs, xs)
    assert torch.equal(wide, distance.l2_distance(qs, xs, variant="simple"))
    assert torch.equal(wide, distance.l2_distance(qs, xs, variant="wide"))


@pytest.mark.parametrize("variant", ["wide", "simple"])
@pytest.mark.parametrize("q,n,d", [(130, 1037, 96), (512, 3000, 256),
                                   (128, 129, 17), (255, 700, 1)])
def test_l2_distance_kernel_integer_inputs_bit_exact(dev, variant, q, n, d):
    # integer-valued f32: every product, norm and sum is exact, so the
    # kernel equals the plain version bit for bit
    qs, xs = _mk(q, n, d, "float32", dev, seed=5, integer=True)
    assert torch.equal(distance.l2_distance(qs, xs, variant=variant),
                       l2_distance_ref(qs, xs))


@pytest.mark.parametrize("q,n,d,k", [(4, 64, 32, 5), (128, 1024, 96, 10),
                                     (33, 700, 960, 10), (1, 2048, 128, 20),
                                     (512, 20000, 96, 10), (3, 5000, 16, 128),
                                     (70, 1, 8, 1)])
def test_l2_topk_kernel_matches_plain(dev, q, n, d, k):
    qs, xs = _mk(q, n, d, "float32", dev)
    before = fused_topk.l2_topk.launches
    vals, ids = ops.l2_topk(qs, xs, k)
    torch.cuda.synchronize()
    assert fused_topk.l2_topk.launches == before + 1
    rvals, rids = l2_topk_ref(qs, xs, k)
    torch.testing.assert_close(vals, rvals, rtol=1e-4, atol=1e-3)
    real = rids >= 0
    assert torch.equal(ids < 0, ~real)
    d_by_id = torch.gather(l2_distance_ref(qs, xs), 1,
                           ids.clamp_min(0).long())
    torch.testing.assert_close(d_by_id[real], rvals[real],
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("q,n,k", [(6, 120, 10), (40, 3000, 64),
                                   (1, 9000, 128)])
def test_l2_topk_kernel_integer_inputs_bit_exact(dev, q, n, k):
    # integer-valued vectors with duplicate rows: exact sums and exact
    # ties, so ids (lower id first) and values must be identical
    qs, xs = _mk(q, n, 24, "float32", dev, seed=2, integer=True)
    xs = torch.cat([xs, xs[: n // 2]])
    vals, ids = ops.l2_topk(qs, xs, k)
    rvals, rids = l2_topk_ref(qs, xs, k)
    assert torch.equal(ids, rids)
    assert torch.equal(vals, rvals)


def test_l2_topk_kernel_duplicates_and_short_tail(dev):
    row = torch.ones((1, 16), device=dev)
    vals, ids = ops.l2_topk(row, row.repeat(6, 1), 4)
    assert ids.tolist() == [[0, 1, 2, 3]]
    vals, ids = ops.l2_topk(row, row.repeat(5, 1), 10)
    assert ids[0, 5:].tolist() == [-1] * 5
    assert torch.all(vals[0, 5:] == torch.tensor(3.4e38))


def _check_topk(qs, xs, k, vals, ids):
    """Values within the f32 tolerance of the plain version; ids through
    the plain distances (near-ties may pick either row)."""
    rvals, rids = l2_topk_ref(qs, xs, k)
    torch.testing.assert_close(vals, rvals, rtol=1e-4, atol=1e-3)
    real = rids >= 0
    assert torch.equal(ids < 0, ~real)
    d_by_id = torch.gather(l2_distance_ref(qs, xs), 1, ids.clamp_min(0).long())
    torch.testing.assert_close(d_by_id[real], rvals[real], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("k", [1, 8, 32, 33, 128])
@pytest.mark.parametrize("q", [31, 32, 33, 127, 128, 129])
def test_l2_topk_kernel_at_tile_boundaries(dev, q, k):
    # Q on both sides of the narrow (32) and wide (128) query blocks, k on
    # both sides of the wide lists (32); 1000 rows are no whole row tile
    qs, xs = _mk(q, 1000, 96, "float32", dev, seed=q + k)
    vals, ids = ops.l2_topk(qs, xs, k)
    _check_topk(qs, xs, k, vals, ids)
    assert fused_topk.pick_variant(q, 96, k) is (
        fused_topk.WIDE if q >= 128 and k <= 32 else fused_topk.NARROW)


@pytest.mark.parametrize("d", [8, 16, 96, 960])
@pytest.mark.parametrize("q", [40, 130])
def test_l2_topk_kernel_depths_and_ragged_rows(dev, q, d):
    # N = 1037 fills neither variant's row tile; D = 8 is half a depth
    # slice, 960 is GIST's (narrow only)
    qs, xs = _mk(q, 1037, d, "float32", dev, seed=d)
    vals, ids = ops.l2_topk(qs, xs, 10)
    _check_topk(qs, xs, 10, vals, ids)


@pytest.mark.parametrize("d", [8, 96, 256])
def test_l2_topk_kernel_variants_give_the_same_bits(dev, d):
    # 300 queries run wide, 100 at a time narrow: both run the same FMA
    # chain per (query, row) and the same norms, so random inputs give
    # identical values and ids
    qs, xs = _mk(300, 5000, d, "float32", dev, seed=7)
    assert fused_topk.pick_variant(300, d, 16) is fused_topk.WIDE
    assert fused_topk.pick_variant(100, d, 16) is fused_topk.NARROW
    wv, wi = ops.l2_topk(qs, xs, 16)
    parts = [ops.l2_topk(qs[s:s + 100], xs, 16) for s in (0, 100, 200)]
    assert torch.equal(wv, torch.cat([p[0] for p in parts]))
    assert torch.equal(wi, torch.cat([p[1] for p in parts]))


@pytest.mark.parametrize("q,k,variant", [(160, 8, "WIDE"), (160, 32, "WIDE"),
                                         (40, 8, "NARROW"), (160, 128, "NARROW")])
def test_l2_topk_kernel_integer_inputs_bit_exact_per_variant(dev, q, k, variant):
    # exact sums and exact ties (duplicate rows): each variant gives the
    # plain version's values and ids, lower id first on ties
    assert fused_topk.pick_variant(q, 24, k) is getattr(fused_topk, variant)
    qs, xs = _mk(q, 3000, 24, "float32", dev, seed=4, integer=True)
    xs = torch.cat([xs, xs[:1500]])
    vals, ids = ops.l2_topk(qs, xs, k)
    rvals, rids = l2_topk_ref(qs, xs, k)
    assert torch.equal(ids, rids)
    assert torch.equal(vals, rvals)


@pytest.mark.parametrize("d", [1040, 2000])
@pytest.mark.parametrize("q,k", [(40, 10), (130, 10), (40, 128)])
def test_l2_topk_kernel_streams_queries_past_the_resident_depth(dev, q, d, k):
    # past NARROW.max_d the queries come through the ring beside the rows;
    # integer inputs keep every sum exact, so values and ids are the plain
    # version's bit for bit
    assert d > fused_topk.NARROW.max_d
    assert fused_topk.pick_variant(q, d, k) is fused_topk.NARROW
    qs, xs = _mk(q, 700, d, "float32", dev, seed=d + k, integer=True)
    xs = torch.cat([xs, xs[:300]])
    vals, ids = ops.l2_topk(qs, xs, k)
    rvals, rids = l2_topk_ref(qs, xs, k)
    assert torch.equal(ids, rids)
    assert torch.equal(vals, rvals)


@pytest.mark.parametrize("q,d,k", [(4096, 96, 8), (512, 96, 10), (256, 256, 32),
                                   (8, 960, 10), (8, 960, 128), (40, 2000, 10)])
def test_l2_topk_plan_follows_the_occupancy(dev, q, d, k):
    # the split fills one wave of the blocks that the call's shared memory
    # lets an SM hold: at least two at the main path's shapes and with
    # streamed queries, one where the resident queries or lists take more
    # than half of an SM's 228 KB
    v, s, span = fused_topk.plan(q, 10 ** 6, d, k, torch.cuda.current_device())
    per_sm = fused_topk._blocks_per_sm(fused_topk._lib(), v, d, k,
                                       torch.cuda.current_device())
    small = (q, d) in ((4096, 96), (512, 96), (40, 2000))
    assert per_sm >= 2 if small else per_sm == 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (s, span) == fused_topk.split_count(q, 10 ** 6, sms, v, per_sm)


def test_kernel_wrappers_reject_what_they_cannot_take(dev):
    qs, xs = _mk(4, 8, 16, "float32", dev)
    with pytest.raises(ValueError):
        ops.l2_topk(qs, xs, fused_topk.K_MAX + 1)
    with pytest.raises(ValueError):
        distance.l2_distance(qs.cpu(), xs.cpu())
    with pytest.raises(ValueError):
        ops.l2_distance(qs, xs.cpu())
    with pytest.raises(TypeError):
        distance.l2_distance(qs, xs.double())


# ------------------------------------------------------- top-k selection --

def _rows(r, n, kind, seed=0):
    """(r, n) float32 rows of one kind, made with numpy."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(r, n)).astype(np.float32)
    if kind == "ties":                      # small integers: ties everywhere
        return rng.integers(0, 5, size=(r, n)).astype(np.float32)
    if kind == "inf_part":                  # the merge's padded entries
        d = (rng.normal(size=(r, n)) ** 2 * 100).astype(np.float32)
        d[rng.random((r, n)) < 0.75] = np.inf
        return d
    if kind == "inf_all":
        return np.full((r, n), np.inf, np.float32)
    if kind == "bimodal":                   # the probe: a few near centroids
        d = rng.uniform(2800, 4500, size=(r, n))
        near = rng.random((r, n)) < 20 / n
        d[near] = rng.uniform(50, 150, size=int(near.sum()))
        return d.astype(np.float32)
    if kind == "zeros":                     # signed zeros and infinities
        return rng.choice(np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf],
                                   np.float32), size=(r, n))
    raise ValueError(kind)


def _same_as_the_sort(d, k):
    """ops.topk_smallest on the card, in one launch, gives the stable
    sort's values (to the bit) and indices."""
    before = topk_select.topk_smallest.launches
    vals, idx = ops.topk_smallest(d, k)
    torch.cuda.synchronize()
    assert topk_select.topk_smallest.launches == before + 1
    want_v, want_i = stable_topk_smallest(d, k)
    assert vals.shape == want_v.shape == (*d.shape[:-1], k)
    assert (vals.dtype, idx.dtype) == (torch.float32, torch.int64)
    assert torch.equal(idx, want_i)
    assert torch.equal(vals.view(torch.int32), want_v.view(torch.int32))


@pytest.mark.parametrize("kind", ["normal", "ties", "inf_part", "inf_all",
                                  "bimodal", "zeros"])
@pytest.mark.parametrize("r,n,k", [(500, 19700, 16), (500, 640, 40), (500, 40, 10),
                                   (64, 1000, 1), (8, 5000, 256), (4, 1024, 1024),
                                   (16, 300, 300), (3, 1, 1), (7, 33, 33),
                                   (32, 2048, 40), (2, 100_000, 10)])
def test_topk_select_matches_the_stable_sort(dev, r, n, k, kind):
    _same_as_the_sort(torch.from_numpy(_rows(r, n, kind, seed=r + n + k)).to(dev), k)


@pytest.mark.parametrize("n", [8, 40, 129, 640, 4097, 19700])
def test_topk_select_orders_signed_zeros_and_nans_as_the_sort(dev, n):
    rng = np.random.default_rng(n)
    bits = np.array([0x00000000, 0x80000000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                     0xFFFFFFFF, 0x7F800000, 0xFF800000, 0x3F800000, 0xBF800000],
                    np.uint32)
    d = rng.choice(bits, size=(6, n)).view(np.float32)
    d[:, : n // 2] = rng.integers(-2, 3, size=(6, n // 2))
    rng.permuted(d, axis=1, out=d)
    d = torch.from_numpy(d).to(dev)
    for k in sorted({1, min(n, 10), min(n, 40), min(n, topk_select.K_MAX)}):
        _same_as_the_sort(d, k)


@pytest.mark.parametrize("k", [16, 1024])
@pytest.mark.parametrize("off", [-1, 0, 1])
def test_topk_select_around_the_shared_memory_threshold(dev, k, off):
    n = topk_select.max_staged(10 ** 6, k, torch.cuda.current_device()) + off
    assert 50_000 < n < 60_000
    for kind in ("normal", "ties"):
        _same_as_the_sort(torch.from_numpy(_rows(3, n, kind, seed=k + off)).to(dev), k)


def test_topk_select_leading_axes_and_strided_input(dev):
    base = torch.from_numpy(_rows(3 * 4 * 60, 700, "ties", seed=3)).to(dev)
    _same_as_the_sort(base.reshape(3, 4, 60, 700), 40)
    _same_as_the_sort(base[:, ::2], 16)                     # strided rows
    _same_as_the_sort(base.reshape(3, 4, 60, 700).transpose(-1, -2), 10)
    _same_as_the_sort(base[5], 7)                           # one axis
    vals, idx = ops.topk_smallest(base[:0], 3)               # no rows: no launch
    assert vals.shape == idx.shape == (0, 3)


def test_topk_select_calls_neither_sort_nor_topk(dev, monkeypatch):
    d = torch.from_numpy(_rows(50, 3000, "normal")).to(dev)
    want = stable_topk_smallest(d, 16)

    def boom(*a, **kw):
        raise AssertionError("the card's top-k went through a sort")
    for name in ("sort", "topk", "argsort"):
        monkeypatch.setattr(torch, name, boom)
        monkeypatch.setattr(torch.Tensor, name, boom)
    from repro_torch.core.distances import topk_smallest
    got = topk_smallest(d, 16)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_topk_select_rejects_what_it_cannot_take(dev):
    d = torch.from_numpy(_rows(4, 10, "normal")).to(dev)
    with pytest.raises(ValueError):
        ops.topk_smallest(d, 11)                               # k > N
    with pytest.raises(ValueError):
        ops.topk_smallest(torch.zeros(2, 2000, device=dev), topk_select.K_MAX + 1)
    with pytest.raises(ValueError):
        ops.topk_smallest(d, 0)
    for dtype in (torch.float64, torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(TypeError):
            ops.topk_smallest(d.to(dtype), 3)
    with pytest.raises(ValueError):
        topk_select.topk_smallest(d.cpu(), 3)
    with pytest.raises(ValueError):
        ops.topk_smallest(torch.tensor(1.0, device=dev), 1)


# ------------------------------------------------------------------ ADC --

def _adc_inputs(n, m, dev, codes_dtype, integer_table=False, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, size=(n, m)).astype(codes_dtype)
    if integer_table:
        table = rng.integers(0, 1000, size=(m, 256)).astype(np.float32)
    else:
        table = rng.random((m, 256)).astype(np.float32)
    return torch.from_numpy(codes).to(dev), torch.from_numpy(table).to(dev)


@pytest.mark.parametrize("codes_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("n,m", [(10, 8), (1024, 48), (2000, 112), (3, 120),
                                 (777, 7), (5000, 227), (1, 1), (0, 48)])
def test_adc_lookup_kernel_matches_plain(dev, n, m, codes_dtype):
    codes, table = _adc_inputs(n, m, dev, codes_dtype)
    before = pq_adc.adc_lookup.launches
    got = ops.adc_lookup(codes, table)
    torch.cuda.synchronize()
    assert pq_adc.adc_lookup.launches == before + (1 if n else 0)
    assert got.shape == (n,) and got.dtype == torch.float32
    torch.testing.assert_close(got, adc_lookup_ref(codes, table),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,m", [(1024, 48), (3000, 120), (777, 7)])
def test_adc_lookup_kernel_integer_table_exact(dev, n, m):
    codes, table = _adc_inputs(n, m, dev, np.uint8, integer_table=True)
    assert torch.equal(ops.adc_lookup(codes, table),
                       adc_lookup_ref(codes, table))


def test_adc_lookup_kernel_unaligned_rows(dev):
    # contiguous codes that start 1 byte into their buffer: m % 4 == 0 but
    # the 4-byte loads would be misaligned, so the kernel reads bytes
    rng = np.random.default_rng(3)
    for n, m in ((65, 4), (300, 48), (9, 6)):
        flat = torch.from_numpy(
            rng.integers(0, 256, 1 + n * m).astype(np.uint8)).to(dev)
        codes = flat[1:].view(n, m)
        assert codes.is_contiguous() and codes.data_ptr() % 4 == 1
        table = torch.from_numpy(rng.random((m, 256)).astype(np.float32)).to(dev)
        torch.testing.assert_close(pq_adc.adc_lookup(codes, table),
                                   adc_lookup_ref(codes, table),
                                   rtol=1e-5, atol=1e-4)


_ADC_GROWING_M = """
import numpy as np, torch
from repro_torch.kernels import pq_adc
from repro_torch.kernels.ref import adc_lookup_ref
rng = np.random.default_rng(0)
for m in (48, 120, 227):
    codes = torch.from_numpy(rng.integers(0, 256, (5000, m)).astype(np.uint8)).cuda()
    table = torch.from_numpy(rng.random((m, 256)).astype(np.float32)).cuda()
    for n in (5000, 138):      # the attribute is set once, then reused
        got = pq_adc.adc_lookup(codes[:n], table, path="staged")
        torch.testing.assert_close(got, adc_lookup_ref(codes[:n], table),
                                   rtol=1e-5, atol=1e-4)
torch.cuda.synchronize()
print("ok")
"""


def test_adc_lookup_kernel_raises_shared_memory_as_m_grows(dev):
    # in a fresh process, so no earlier test has set the attribute: the
    # cached shared-memory size must grow from m = 48 to 120 to 227
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", _ADC_GROWING_M], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("m", [48, 120, 7])
@pytest.mark.parametrize("n_from_threshold", [-pq_adc.SMALL_N + 1, -1, 0, 1, 3000])
def test_adc_lookup_paths_give_the_same_bits_around_the_threshold(
        dev, n_from_threshold, m):
    # N = 1, SMALL_N - 1, SMALL_N (the last direct), SMALL_N + 1 (the
    # first staged) and beyond; m = 7 reads the codes byte by byte
    n = pq_adc.SMALL_N + n_from_threshold
    codes, table = _adc_inputs(n, m, dev, np.uint8, seed=n + m)
    got = {p: pq_adc.adc_lookup(codes, table, path=p) for p in pq_adc.PATHS}
    assert torch.equal(got["staged"], got["direct"])
    assert torch.equal(pq_adc.adc_lookup(codes, table), got["staged"])
    torch.testing.assert_close(got["direct"], adc_lookup_ref(codes, table),
                               rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        pq_adc.adc_lookup(codes, table, path="shared")


def test_adc_lookup_kernel_refuses_what_it_cannot_take(dev):
    codes, table = _adc_inputs(16, 8, dev, np.uint8)
    with pytest.raises(ValueError):
        pq_adc.adc_lookup(codes.cpu(), table.cpu())
    with pytest.raises(ValueError):
        ops.adc_lookup(codes, table.cpu())
    with pytest.raises(TypeError):
        pq_adc.adc_lookup(codes.long(), table)
    with pytest.raises(TypeError):
        pq_adc.adc_lookup(codes, table.int())
    with pytest.raises(ValueError):
        pq_adc.adc_lookup(codes, table[:, :128])
    big = torch.zeros((4, pq_adc.MAX_M + 1), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        pq_adc.adc_lookup(big, torch.zeros((pq_adc.MAX_M + 1, 256), device=dev))


# ----------------------------------------- the LM stack and distributed --

@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-1.3b", "recurrentgemma-2b",
                                  "llama-3.2-vision-11b", "dbrx-132b",
                                  "musicgen-medium"])
def test_lm_on_the_card_matches_the_cpu(dev, arch):
    """One seed, one set of weights on both; logits, prefill and decode on
    the card (f32, no TF32) against the CPU's."""
    from repro_torch.configs.archs import ARCHS, smoke
    from repro_torch.kernels.ref import full_f32_matmul
    from repro_torch.models.model import LM
    from repro_torch.serve.decode import _grow_attention_caches

    cfg = smoke(ARCHS[arch])
    rng = np.random.default_rng(0)
    if cfg.family == "audio":
        batch = {"frames": rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 20))}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    key = "frames" if cfg.family == "audio" else "tokens"
    outs = []
    for device in ("cpu", dev):
        lm = LM(cfg, seed=0, device=device)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        with torch.no_grad(), full_f32_matmul():
            full = lm.logits(b).cpu()
            lp, caches = lm.prefill({**b, key: b[key][:, :16]})
            caches = _grow_attention_caches(lm, caches, 20)
            steps = [lp[:, 0].cpu()]
            for t in range(16, 20):
                lt, caches = lm.decode_step({**b, key: b[key][:, t:t + 1]}, t, caches)
                steps.append(lt[:, 0].cpu())
        outs.append((full, torch.stack(steps)))
    (cf, cs), (gf, gs) = outs
    torch.testing.assert_close(gf, cf, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gs, cs, rtol=1e-4, atol=1e-4)


def test_sharded_steps_one_nccl_rank_match_gloo_on_the_cpu(dev, tmp_path):
    import torch.distributed as dist

    from repro_torch.core.distributed import sharded_kmeans_step, sharded_search_step

    rng = np.random.default_rng(0)
    L, M, D, B = 256, 16, 32, 64
    cents = rng.normal(size=(L, D)).astype(np.float32)
    vecs = (cents[:, None] + rng.normal(0, 0.1, (L, M, D))).astype(np.float32)
    ids = np.arange(L * M, dtype=np.int32).reshape(L, M)
    ids[rng.random((L, M)) < 0.1] = -1
    q = (cents[rng.choice(L, B)] + rng.normal(0, 0.05, (B, D))).astype(np.float32)
    norms = (vecs ** 2).sum(-1)
    x = vecs.reshape(-1, D)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        cpu_group = dist.new_group([0], backend="gloo")
        arrays = (cents, vecs, ids, norms, q)
        before = distance.l2_distance.launches
        gi, gd = sharded_search_step(nprobe_local=8, k=10)(
            *(torch.from_numpy(a).to(dev) for a in arrays))
        assert distance.l2_distance.launches == before + 1
        wi, wd = sharded_search_step(cpu_group, nprobe_local=8, k=10)(
            *(torch.from_numpy(a) for a in arrays))
        assert torch.equal(gi.cpu(), wi)
        torch.testing.assert_close(gd.cpu(), wd, rtol=1e-5, atol=1e-4)
        gc = sharded_kmeans_step()(torch.from_numpy(x).to(dev),
                                   torch.from_numpy(cents).to(dev))
        wc = sharded_kmeans_step(cpu_group)(torch.from_numpy(x),
                                            torch.from_numpy(cents))
        torch.testing.assert_close(gc.cpu(), wc, rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------- training --

@pytest.mark.parametrize("arch", ["dbrx-132b", "gemma-2b", "internlm2-20b",
                                  "llama-3.2-vision-11b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b", "musicgen-medium",
                                  "qwen3-32b", "recurrentgemma-2b",
                                  "starcoder2-7b"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch):
    """One train step (remat on) of each smoke config from one seed's
    weights on the card and on the CPU, f32 without TF32: loss and
    grad_norm at rtol 1e-4, each gradient within 1e-4 of its leaf's max
    |g|, the parameters within 2 lr (step 1's g/|g| flips with the sign of
    a near-zero gradient) and m within 1e-4 of (1 - b1) max |g|."""
    import dataclasses

    from repro_torch.configs.archs import ARCHS, smoke
    from repro_torch.kernels.ref import full_f32_matmul
    from repro_torch.models.model import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(smoke(ARCHS[arch]), remat=True)
    rng = np.random.default_rng(0)
    batch = {"labels": rng.integers(0, cfg.vocab, (4, 32))}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (4, 32))
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (4, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    ocfg = opt.OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=200)
    out = []
    for device in ("cpu", dev):
        lm = LM(cfg, seed=0, device=device)
        state = opt.init_state(dict(lm.named_parameters()))
        with full_f32_matmul():
            lm, state, m = make_train_step(lm, ocfg)(
                lm, state, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        grads = {k: p.grad.cpu() for k, p in lm.named_parameters() if p.grad is not None}
        out.append((m, grads, {k: v.cpu() for k, v in lm.state_dict().items()},
                    {k: v.cpu() for k, v in state["m"].items()}))
    (cm, cg, cp, cmom), (gm, gg, gp, gmom) = out
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(gm[key]), float(cm[key]), rtol=1e-4)
    assert set(gg) == set(cg)
    lr = float(cm["lr"])
    for k in cg:
        scale = float(cg[k].abs().max())
        assert float((gg[k] - cg[k]).abs().max()) <= 1e-4 * scale + 1e-12, k
    for k in cp:
        assert float((gp[k] - cp[k]).abs().max()) <= 2 * lr + 1e-6, k
        assert float((gmom[k] - cmom[k]).abs().max()) <= 1e-4 * max(
            float(cmom[k].abs().max()), 1e-12), k
