"""kernels_roofline (%): the hand-written kernels' calls (each entry of
compute.kernels that an operator called in the traced window) as one
roofline: the sum of each call's least bytes (counting.KERNEL_CALLS, the
kernel table's formulas) over 3.35 TB/s, divided by the sum of the
hand-written device functions' times launched inside those calls."""


def read(w):
    t, bandwidth = w.trace, w.peak_bandwidth
    if t is None or not w.trace_complete or bandwidth is None or not w.tap.calls:
        return None
    own = [op for op in t.launched_in(t.kernel_spans) if t.own_function(op)]
    seconds = sum(op.end - op.start for op in own) / 1e9
    if seconds <= 0:
        return None
    return 100.0 * (w.tap.total_bytes() / bandwidth) / seconds
