"""The readers of the port's own spans (``att.*``): the host reads counted
in a traced run on the CPU, nothing read where no device work ran, and
nothing read from a program that opens no such span."""

import json

import pytest
import torch

from portbench import harness, tracing

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
PROGRAM = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]
HOST_READS = {"host_reads_per_query", "host_reads_per_query.host"}
#: the host reads a query makes on the CPU: a join's legacy emit its run
#: bounds' two flags and its total; the sort route its last segment end and
#: its group count; the dense routes their range check and occupied slots
READS = {
    "h2o-join-1e8.q5-big": 3.0,
    "h2o-groupby-1e8-k100.q3-q4-q5": 2.0,
    "h2o-groupby-1e8-k100.q1-q2": 2.0,
    "h2o-join-1e8.q1-q2-small-medium": 3.0,
}


def test_program_span_metrics_are_listed():
    assert len(PROGRAM) == 10 and all(m["workloads"] for m in BENCH["per_layer"] if m["name"] in PROGRAM)


@pytest.mark.parametrize("cell", list(READS))
def test_cpu_run_counts_host_reads_and_reads_no_device_time(small_catalog, cell):
    result = harness.run_cell(small_catalog, cell, 2**36 + 9, 0.3, True, torch.device("cpu"), 0.0)
    assert result["correct"] is True
    mine = {m["name"] for m in small_catalog.metrics(cell, True) if m["name"] in PROGRAM}
    assert mine and set(result["metrics"]) & mine == mine & HOST_READS
    for name in mine & HOST_READS:
        assert result["metrics"][name]["value"] == READS[cell]


def _window(call) -> harness.Window:
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("portbench.window"):
            for _ in range(3):
                with torch.profiler.record_function("portbench.query.q"):
                    call()
    return harness.Window(setup_s=0.0, seconds=0.0, latencies=[], rows=0, peak_bytes=None, device_name="cpu",
                          operators={"q": "groupby"}, trace=tracing.Trace(prof), trace_complete=True)


def test_readers_read_nothing_without_device_work_or_spans():
    import arrow_tpu_torch as att

    keys = att.UInt32Array.from_slice(list(range(50)) * 20, device="cpu")
    vals = att.Int32Array.from_slice([1] * 1000, device="cpu")
    w = _window(lambda: att.compute.hash_aggregate(keys, [("s", vals, "sum")]))
    cat = harness.Catalog()
    for name in PROGRAM:
        value = cat.module("metrics", name.removesuffix(".host")).read(w)
        assert value == (2.0 if name in HOST_READS else None), name
    w.trace.host = [o for o in w.trace.host if not o.name.startswith("att.")]  # a program without spans
    assert all(cat.module("metrics", n.removesuffix(".host")).read(w) is None for n in PROGRAM)
    w.trace_complete = False
    assert all(cat.module("metrics", n.removesuffix(".host")).read(w) is None for n in PROGRAM)
