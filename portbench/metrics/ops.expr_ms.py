"""ops.expr_ms: the device-busy ms per traced query of the work launched
inside the ops tier's calls that a question makes itself (``att.op.<name>``
spans inside the question spans): Q1's compare, its key and its price
expressions.  None where no such span launched device work."""

from portbench.tracing import Spans


def read(w):
    t = w.trace
    if t is None or not w.trace_complete or not t.queries.ops:
        return None
    spans = Spans([o for o in t.host if o.name.startswith("att.op.") and t.queries.find(o.start) is not None])
    busy = t.busy_ns(t.launched_in(spans))
    if busy <= 0:
        return None
    return busy / 1e6 / len(t.queries.ops)
