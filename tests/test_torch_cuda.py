"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device these skip (CPU parity lives in
``test_torch_kernels.py``).  Run on a machine with an H100 and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, distance, fused_topk, ops, pq_adc  # noqa: E402
from repro_torch.kernels.ref import (adc_lookup_ref, l2_distance_ref,  # noqa: E402
                                     l2_topk_ref)

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
