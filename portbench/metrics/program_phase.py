"""Shared by the readers of the port's own spans, not a metric: the
``att.*`` spans that ``arrow_tpu_torch.runtime.profiler.span`` and
``host_read`` open inside the operators while the traced run's profiler
records.  A program without such spans gives None: nothing to read."""

from portbench.tracing import Spans


def named(t, names) -> Spans:
    """The trace's spans called one of `names` (siblings, not nested)."""
    return Spans([o for o in t.host if o.name in names])


def device_ms(w, *names):
    """The device-busy ms per traced query of the work launched inside the
    spans called one of `names`; None without a complete trace, and None
    when those spans launched no device work (the CPU)."""
    t = w.trace
    if t is None or not w.trace_complete or not t.queries.ops:
        return None
    busy = t.busy_ns(t.launched_in(named(t, names)))
    if busy <= 0:
        return None
    return busy / 1e6 / len(t.queries.ops)
