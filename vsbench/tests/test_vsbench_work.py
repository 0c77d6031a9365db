"""The yardstick's counters against hand-computed values."""
import numpy as np
import pytest

from vsbench import work


def test_l2_distance_work_by_hand():
    # 2 queries x 3 rows of width 4: products 2*2*3*4 = 48, norms 2*5*4 =
    # 40, combine 3*2*3 = 18; bytes 4*(5*4) + 4*6 = 104
    assert work.l2_distance_work(2, 3, 4) == (106, 104)
    # the probe at 512 x 43,000 x 96
    q, n, d = 512, 43_000, 96
    flop, nbytes = work.l2_distance_work(q, n, d)
    assert flop == 4_227_072_000 + 8_354_304 + 66_048_000
    assert nbytes == 16_708_608 + 88_064_000


def test_search_batch_work_by_hand():
    lengths = np.array([3, 0, 5, 2])
    probe = np.array([[0, 2], [2, 3]])          # 2 queries, nprobe 2
    flop, nbytes = work.search_batch_work(probe, lengths, 4, 8, 10)
    # probe 2*2*4*8 = 128; scan 2*8*(3+5 + 5+2) = 240
    assert flop == 368
    # centroids and queries 4*(4+2)*8 = 192; union {0,2,3}: 10 rows of
    # 4*8 + 4 = 360; out 2*10*8 = 160
    assert nbytes == 192 + 360 + 160


def test_peaks_and_least_time():
    flops, bw = work.card_peaks("NVIDIA H100 80GB HBM3")
    assert (flops, bw) == (67e12, 3.35e12)
    assert work.least_s(67e12, 1.0, (flops, bw)) == pytest.approx(1.0)
    assert work.least_s(1.0, 6.7e12, (flops, bw)) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        work.card_peaks("cpu")
