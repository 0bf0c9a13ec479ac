"""Shares of the traced window, shared by the metrics named after them."""


def hand_share(w):
    """The hand-written kernels' device time over all device-busy time (%)."""
    t = w.trace
    if t is None or not w.trace_complete:
        return None
    busy = t.busy_ns()
    if busy <= 0:
        return None
    return 100.0 * sum(op.end - op.start for op in t.device if t.own_function(op)) / busy


def idle_share(w):
    """The traced window with no kernel, copy or fill on the card (%)."""
    t = w.trace
    if t is None or not w.trace_complete or t.window_ns <= 0:
        return None
    return 100.0 * (1 - t.busy_ns() / t.window_ns)
