"""groupby.range_check_ms: the host's wall ms per traced query inside the
dense routes' range check (``att.groupby.range_check``): the launches of
its min/max reductions and its host read, which waits for them.  None where
the spans launched no device work (the CPU)."""

from portbench.metrics.program_phase import named


def read(w):
    t = w.trace
    if t is None or not w.trace_complete or not t.queries.ops:
        return None
    spans = named(t, {"att.groupby.range_check"})
    if not t.launched_in(spans):
        return None
    return sum(o.end - o.start for o in spans.ops) / 1e6 / len(t.queries.ops)
