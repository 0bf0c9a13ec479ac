"""host_syncs_per_query: the host's waits on the device inside the question
spans (cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize
and synchronous cudaMemcpy runtime calls) per traced query.  The
benchmark's own wait at each query's end lies outside the span."""

from portbench.tracing import SYNC_CALLS


def read(w):
    t = w.trace
    if t is None or not w.trace_complete or not t.queries.ops:
        return None
    return t.host_in(t.queries, SYNC_CALLS) / len(t.queries.ops)
