"""The port's spans (``runtime.profiler.span`` and ``host_read``): free
without a profiler, the same results traced and untraced, the span tree of
each group-by route and join emit, and ``device_report``'s check for lost
device records."""

import logging
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import arrow_tpu_torch as att
from arrow_tpu_torch.compute import join as J
from arrow_tpu_torch.runtime import profiler

C = att.compute
N = 3072  # a whole number of pad units: the radix route takes full buffers only


def _cols(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "k100": att.UInt32Array.from_slice(rng.integers(0, 100, N).astype(np.uint32), device="cpu"),
        "k1e5": att.UInt32Array.from_slice(rng.integers(0, 100_000, N).astype(np.uint32), device="cpu"),
        "kfull": att.UInt32Array.from_slice(rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32),
                                            device="cpu"),
        "v1": att.Int32Array.from_slice(rng.integers(1, 6, N).astype(np.int32), device="cpu"),
        "v3": att.Float64Array.from_slice(rng.random(N) * 100, device="cpu"),
        "i64": att.Int64Array.from_slice(rng.integers(0, 500, N).astype(np.int64), device="cpu"),
        "b64": att.Int64Array.from_slice(np.arange(400, dtype=np.int64), device="cpu"),
        "b32": att.UInt32Array.from_slice(np.arange(60, dtype=np.uint32), device="cpu"),
        "b32dup": att.UInt32Array.from_slice(np.arange(61, dtype=np.uint32) % 60, device="cpu"),  # key 0 twice
    }


def _join(probe, build):
    return lambda c: C.hash_join(
        att.RecordBatch({"id": c[probe], "v": c["v1"]}), att.RecordBatch({"id": c[build]}), "id", "id"
    )


SORT_TAIL = [
    "    att.groupby.gather",
    "    att.groupby.scan",
    "      att.sync.last_segment_end",
    "    att.groupby.compact",
    "    att.groupby.compact",
    "      att.sync.num_groups",
]
RANGE_CHECK = [
    "  att.groupby.route.mxu",
    "    att.groupby.range_check",
    "      att.sync.range_check",
]
DENSE_TAIL = ["    att.groupby.dense_kernel", "    att.groupby.dense_result", "      att.sync.dense_groups"]
PLAN = [
    "  att.join.plan",
    "    att.join.cosort",
    "    att.join.bounds",
    "      att.sync.first_key_start",
    "      att.sync.last_key_end",
    "      att.sync.join_counts",
]
#: unique build keys: one host read between the plan's spans, and the
#: one-match emit inside att.join.expand
ONE_MATCH = ["  att.join.expand", "    att.join.one_match", "  att.join.take"]

#: name -> (environment, the call, the span tree it opens, in order)
CASES = {
    "mxu": ({}, lambda c: C.hash_aggregate(c["k100"], [("s", c["v1"], "sum")]),
            ["att.groupby", *RANGE_CHECK, *DENSE_TAIL]),
    "partition": ({}, lambda c: C.hash_aggregate(c["k1e5"], [("s", c["v1"], "sum"), ("n", None, "count")]),
                  ["att.groupby", *RANGE_CHECK, "  att.groupby.route.partition", "    att.groupby.class_sort",
                   *DENSE_TAIL]),
    "sort": ({}, lambda c: C.hash_aggregate(c["k100"], [("s", c["v1"], "sum"), ("m", c["v3"], "mean")]),
             ["att.groupby", "  att.groupby.route.radix", "  att.groupby.route.sort", "    att.groupby.prepare",
              "    att.groupby.order", *SORT_TAIL]),
    "radix": ({},
              lambda c: C.hash_aggregate(c["kfull"], [("s", c["v1"], "sum")], method="radix"),
              ["att.groupby", "  att.groupby.route.radix", "    att.groupby.prepare", "    att.groupby.order",
               "      att.sync.radix_significant_bits", *SORT_TAIL]),
    "join_legacy": ({}, _join("k100", "b32"),
                    ["att.join", "  att.join.legacy_emit", "    att.sync.first_key_start", "    att.sync.last_key_end",
                     "    att.sync.join_total", "  att.join.take"]),
    "join_merge": ({"ARROW_TPU_JOIN_EMIT": "merge"}, _join("k100", "b32"), ["att.join", *PLAN, *ONE_MATCH]),
    "join_merge_repeated_build_key": ({"ARROW_TPU_JOIN_EMIT": "merge"}, _join("k100", "b32dup"),
                                      ["att.join", *PLAN, "    att.join.lists", "  att.join.expand",
                                       "  att.join.rank_fill", "  att.join.take"]),
    "filter": ({}, lambda c: C.filter(att.RecordBatch({"k": c["k100"], "v": c["i64"]}), att.kernels.lt_scalar(c["v1"], 3)),
               ["att.op.lt_scalar", "att.filter", "  att.sync.filter_count"]),
    "filter_sort": ({}, lambda c: C.filter(att.RecordBatch({"k": c["k100"]}), att.kernels.lt_scalar(c["v1"], 3),
                                           method="sort"),
                    ["att.op.lt_scalar", "att.filter", "  att.sync.filter_count"]),
    "join_merge_narrowed": ({"ARROW_TPU_JOIN_EMIT": "merge"}, _join("i64", "b64"),
                            ["att.join", "  att.join.plan", "    att.sync.narrow_check", *PLAN[1:], *ONE_MATCH]),
}


@pytest.fixture
def case(request, monkeypatch):
    env, call, tree = CASES[request.param]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(J, "NARROW_MIN_ROWS", 0)  # the narrowing check at any size
    return call, tree


def _traced(fn):
    """fn() under a CPU profiler: its result and the ``att.*`` spans as an
    indented tree, nested as the profiler nests them, in order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    lines = []
    for e in sorted(prof.events(), key=lambda e: (e.time_range.start, -e.time_range.elapsed_us())):
        if not e.name.startswith("att."):
            continue
        depth, p = 0, e.cpu_parent
        while p is not None:
            depth += p.name.startswith("att.")
            p = p.cpu_parent
        lines.append("  " * depth + e.name)
    return out, lines


def _bits(batch):
    return {
        name: (col.length, col.data.numpy().tobytes(), None if col.validity is None else col.validity.numpy().tobytes())
        for name, col in batch.columns().items()
    }


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: pytest.fail(f"built a span {name}"))
    assert profiler.span("att.a") is profiler.span("att.b") is profiler.host_read("c")
    with profiler.span("att.a"):
        out = C.hash_aggregate(_cols(1)["k100"], [("s", _cols(1)["v1"], "sum")])
    assert out.num_rows == 100


def test_profiler_flag_follows_start_and_stop():
    """The flag that span reads is true while a profiler records, and only
    then: a torch that moved it would leave every span out."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    assert not torch.autograd.profiler._is_profiler_enabled
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled
        assert isinstance(profiler.span("att.a"), torch.profiler.record_function)
    finally:
        prof.stop()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiler.span("att.a") is profiler.host_read("b")


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_traced_results_are_bit_identical(case):
    call, _tree = case
    plain = call(_cols(7))
    traced, _ = _traced(lambda: call(_cols(7)))
    assert plain.num_rows > 0 and _bits(traced) == _bits(plain)


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_span_tree(case):
    call, tree = case
    _, got = _traced(lambda: call(_cols(8)))
    assert got == tree


@pytest.mark.parametrize("call", ["filter_count", "filter_indices"])
def test_filter_count_reads_are_named(call):
    """filter_count's and filter_indices' count reads are att.sync.filter_count
    spans, and only those: no att.filter span, no other wait."""
    mask = att.kernels.lt_scalar(_cols(9)["v1"], 3)
    out, lines = _traced(lambda: getattr(C, call)(mask))
    want = int((_cols(9)["v1"].data < 3).sum())
    assert (out if call == "filter_count" else out[1]) == want
    assert lines == ["att.sync.filter_count"]


def _event(name, device=False, annotation=False):
    return types.SimpleNamespace(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
                                 is_user_annotation=annotation)


def test_lost_kernels_counts_launches_against_kernel_events():
    events = [_event("cudaLaunchKernel"), _event("cuLaunchKernel"), _event("cudaLaunchKernelExC"),
              _event("cudaMemcpyAsync"), _event("aten::add"), _event("att.join.plan"),
              _event("void add_kernel<float>(...)", device=True), _event("Memcpy DtoH", device=True),
              _event("Memset (Device)", device=True), _event("att.join.plan", device=True, annotation=True)]
    assert profiler.lost_kernels(events) == 2
    events += [_event("radix_onesweep", device=True), _event("merge_tiles", device=True)]
    assert profiler.lost_kernels(events) == 0


def test_device_report_warns_of_lost_records(monkeypatch, caplog):
    a = att.Float32Array.from_slice(np.arange(64, dtype=np.float32), device="cpu")
    with caplog.at_level(logging.WARNING, logger="arrow_tpu_torch"):
        profiler.device_report(att.kernels.neg, a)
    assert not caplog.records
    monkeypatch.setattr(profiler, "lost_kernels", lambda events: 3)
    with caplog.at_level(logging.WARNING, logger="arrow_tpu_torch"):
        rows = profiler.device_report(att.kernels.neg, a)
    assert rows and any("lost 3 " in r.getMessage() for r in caplog.records)
    profiler.reset()
