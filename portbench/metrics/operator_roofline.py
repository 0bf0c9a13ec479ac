"""Shared by groupby_roofline and join_roofline: an operator's least bytes
over the card's published bandwidth, as a share (%) of the device-busy time
of the work launched inside that operator's question spans."""

from portbench.tracing import Spans


def share(w, operator: str):
    t, bandwidth = w.trace, w.peak_bandwidth
    if t is None or not w.trace_complete or bandwidth is None or operator not in w.least_bytes:
        return None
    spans = Spans([s for s in t.queries.ops if w.operators[s.name.split(".", 2)[2]] == operator])
    busy = t.busy_ns(t.launched_in(spans))
    if busy <= 0:
        return None
    return 100.0 * (w.least_bytes[operator] / bandwidth) / (busy / 1e9)
