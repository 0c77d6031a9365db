"""The least time the card could spend on the window's batches (each the
longer of its FLOP at the FP32 peak and its bytes at the HBM peak, counted
by ``work.search_batch_work`` from the lists each query probes), as a
percentage of the window's wall time."""
from vsbench import work


def read(rec):
    if rec.device.type != "cuda" or not rec.batch_work:
        return None
    peaks = work.card_peaks(rec.card)
    least = sum(work.least_s(*rec.batch_work[int(s)], peaks) for s in rec.slots)
    return 100.0 * least / rec.window_s
