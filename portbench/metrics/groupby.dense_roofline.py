"""groupby.dense_roofline (%): kernel B5's share of its roofline: the least
bytes of every ``compute.kernels.groupby_dense`` call in the traced window
(its keys and values read once, the 4096-slot tables written once:
``counting.groupby_dense``) over 3.35 TB/s, divided by the time of the
``dense_histogram`` device functions launched inside those calls.  None
where no query took the mxu route."""


def read(w):
    t, bandwidth = w.trace, w.peak_bandwidth
    if t is None or not w.trace_complete or bandwidth is None or w.tap is None:
        return None
    calls = [fixed for name, fixed, _count, _per_row in w.tap.calls if name == "groupby_dense"]
    own = [op for op in t.launched_in(t.kernel_spans, "portbench.kernel.groupby_dense")
           if t.own_function(op) == "dense_histogram"]
    seconds = sum(op.end - op.start for op in own) / 1e9
    if not calls or seconds <= 0:
        return None
    return 100.0 * (sum(calls) / bandwidth) / seconds
