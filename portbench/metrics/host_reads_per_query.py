"""host_reads_per_query: the port's own count of its host reads, per traced
query: the ``att.sync.<cause>`` spans (``runtime.profiler.host_read``)
inside the question spans.  Beside host_syncs_per_query, which counts the
runtime's waits, it names each wait by its cause.  None where the program
opens no ``att.*`` span."""


def read(w):
    t = w.trace
    if t is None or not w.trace_complete or not t.queries.ops:
        return None
    inside = [o.name for o in t.host if o.name.startswith("att.") and t.queries.find(o.start) is not None]
    if not inside:
        return None
    return sum(name.startswith("att.sync.") for name in inside) / len(t.queries.ops)
