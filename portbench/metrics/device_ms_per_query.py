"""device_ms_per_query: the device-busy time per traced query, in ms: the
steady statistic beside the end-to-end metrics of a cell that the host
paces, whose host time spreads them from process to process."""


def read(w):
    t = w.trace
    if t is None or not w.trace_complete or not t.queries.ops:
        return None
    return t.busy_ns() / 1e6 / len(t.queries.ops)
