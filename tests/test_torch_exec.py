"""``repro_torch.exec`` on the CPU: the batched scan (mirrors
``tests/test_exec.py``'s pad-to-tile section, and holds the port's batched
ids to the JAX package's), and the calibration table and harness (held to
the reference's ``CalibrationTable`` on one set of entries)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.exec import batched as jbatched  # noqa: E402
from repro.exec import table as jtable  # noqa: E402
from repro_torch.exec import (CALIBRATE_COMMAND, QUERY_TILE,  # noqa: E402
                              CalibEntry, CalibrationTable, batched_topk,
                              coalesce_scan, load_table, measure_table,
                              pad_amount, scan_topk_oracle)
from repro_torch.exec import calibrate  # noqa: E402
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
    # the query tile is the CUDA kernel's small-batch query block, and the
    # wide variant's block (taken from 128 queries up) is whole tiles
    assert QUERY_TILE == fused_topk.NARROW.block_q
    assert fused_topk.WIDE.block_q % QUERY_TILE == 0
    assert fused_topk.pick_variant(QUERY_TILE, 96, 10) is fused_topk.NARROW
    assert pad_amount(33, QUERY_TILE) == 31


# ----------------------------------------------------- calibration table --

_ROWS = [("dist", 32, 0, 100, "float32", 1e-6),
         ("dist", 32, 0, 10000, "float32", 1e-8),
         ("dist", 128, 0, 100, "float32", 4e-6),
         ("adc", 0, 8, 1000, "uint8", 2e-8),
         ("adc", 0, 8, 64000, "uint8", 5e-10),
         ("adc", 0, 48, 1000, "uint8", 3e-8)]


def _tables():
    return (CalibrationTable([CalibEntry(*r) for r in _ROWS],
                             meta={"backend": "test"}),
            jtable.CalibrationTable([jtable.CalibEntry(*r) for r in _ROWS],
                                    meta={"backend": "test"}))


def test_table_roundtrip_matches_reference_file(tmp_path):
    port, ref = _tables()
    port.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    back = CalibrationTable.load(str(tmp_path / "ref.json"))
    assert [e.to_dict() for e in back.entries] == \
        [e.to_dict() for e in port.entries]
    assert back.meta["backend"] == "test"
    assert back.describe() == ref.describe()


@pytest.mark.parametrize("dim", [16, 32, 64, 128, 500])
@pytest.mark.parametrize("batch", [1, 100, 1000, 3333.3, 10000, 1e9])
def test_table_lookups_match_reference(dim, batch):
    port, ref = _tables()
    assert port.dist_unit_s(dim, batch) == ref.dist_unit_s(dim, batch)
    assert port.dist_flops_per_s(dim, batch) == ref.dist_flops_per_s(dim, batch)
    for pq_m in (8, 16, 48, 120):
        assert port.adc_unit_s(pq_m, batch) == ref.adc_unit_s(pq_m, batch)


@pytest.mark.parametrize("work", [(4096, 2048, 64, 8, None, None),
                                  (500, 0, 32, 0, 50000, None),
                                  (0, 777, 96, 48, None, 1e6),
                                  (1, 1, 128, 16, 1, 1)])
def test_plan_seconds_matches_reference(work):
    port, ref = _tables()
    d_dist, d_pq, dim, pq_m, db, ab = work
    assert port.plan_seconds(d_dist, d_pq, dim, pq_m, dist_batch=db,
                             adc_batch=ab) == \
        ref.plan_seconds(d_dist, d_pq, dim, pq_m, dist_batch=db, adc_batch=ab)


def test_table_requires_dist_entries_and_load_needs_a_path():
    with pytest.raises(ValueError):
        CalibrationTable([CalibEntry("adc", 0, 8, 100, "uint8", 1e-8)])
    # without a path: the table measured on the card and committed
    assert load_table().meta["backend"] == "cuda"
    assert "python -m repro_torch.exec.calibrate" in CALIBRATE_COMMAND


def test_measure_table_quick_on_cpu_gives_a_loadable_table(tmp_path):
    t = measure_table(quick=True, iters=1, device="cpu")
    assert {e.op for e in t.entries} == {"dist", "adc"}
    assert all(e.unit_s > 0 for e in t.entries)
    assert len(t.entries) == (len(calibrate.DIMS_QUICK)
                              * len(calibrate.DIST_POINTS_QUICK)
                              + len(calibrate.PQ_MS_QUICK)
                              * len(calibrate.ADC_POINTS_QUICK))
    # no card: no roofline to hold the points to, and the meta says so
    assert t.meta["backend"] == "cpu" and t.meta["rooflines"] == []
    assert t.meta["roofline_check"].startswith("skipped")
    assert t.plan_seconds(1000, 500, 32, 8) > 0
    p = tmp_path / "t.json"
    t.save(str(p))
    assert json.loads(p.read_text())["version"] == 1
    assert load_table(str(p)).dist_unit_s(32) > 0
    # a port-measured table is a valid input for the reference's pricing
    assert jtable.CalibrationTable.load(str(p)).plan_seconds(100, 10, 32, 8) > 0


def test_calibrate_cli_runs_on_the_card_only(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the CLI would time the card")
    out = tmp_path / "cal.json"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate.main(["--out", str(out), "--quick"])
    assert not out.exists()
