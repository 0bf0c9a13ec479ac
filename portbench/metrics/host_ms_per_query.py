"""host_ms_per_query: the host's own time per traced query, in ms: each
question span's length less the host's waits on the device inside it (the
runtime calls of host_syncs_per_query).  Beside device_ms_per_query it
shows what a cell paced by the host could gain if those waits went and the
host ran ahead: a query then takes about the larger of the two.  The
profiler's own cost on each host op is in it, so it reads above an
untraced run's host time."""

from portbench.tracing import SYNC_CALLS


def read(w):
    t = w.trace
    if t is None or not w.trace_complete or not t.queries.ops:
        return None
    spans = sum(o.end - o.start for o in t.queries.ops)
    waits = sum(o.end - o.start for o in t.host if o.name in SYNC_CALLS and t.queries.find(o.start) is not None)
    return (spans - waits) / 1e6 / len(t.queries.ops)
