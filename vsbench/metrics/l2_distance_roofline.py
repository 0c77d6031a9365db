"""The probe's ``l2_distance`` kernel: its least time at the probe's shape
(batch x lists x dim, ``work.l2_distance_work``) as a percentage of its
mean device time a call in the trace (total over the calls recorded)."""
from vsbench import work


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    secs, calls = tr.kernel_time("l2_distance")
    if not calls:
        return None
    s = rec.shapes
    least = work.least_s(*work.l2_distance_work(rec.batch, s["n_lists"], s["dim"]),
                         work.card_peaks(rec.card))
    return 100.0 * least / (secs / calls)
