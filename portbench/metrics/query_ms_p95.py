"""query_ms_p95: the 95th percentile, in ms, of every query completed in the
window, each timed on the host clock from its issue until its result is
complete on the device (linear between the two nearest ranks)."""


def read(w):
    times = sorted(w.latencies)
    if not times:
        return None
    pos = 0.95 * (len(times) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(times) - 1)
    return 1e3 * (times[lo] + (pos - lo) * (times[hi] - times[lo]))
