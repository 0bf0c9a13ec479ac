"""join.one_match_share over CPU traces of the port's merge emit: 100 where
every join meets unique build keys, 0 where a matched build key repeats, and
nothing read from the legacy emit or from a program that reads no
``join_counts``."""

import pytest
import torch

from portbench import harness, tracing


def _window(call) -> harness.Window:
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("portbench.window"):
            for _ in range(3):
                with torch.profiler.record_function("portbench.query.q"):
                    call()
    return harness.Window(setup_s=0.0, seconds=0.0, latencies=[], rows=0, peak_bytes=None, device_name="cpu",
                          operators={"q": "join"}, trace=tracing.Trace(prof), trace_complete=True)


def _join(build_keys):
    import arrow_tpu_torch as att

    probe = att.RecordBatch({"id": att.UInt32Array.from_slice([i % 70 for i in range(500)], device="cpu")})
    build = att.RecordBatch({"id": att.UInt32Array.from_slice(build_keys, device="cpu")})
    return lambda: att.compute.hash_join(probe, build, "id", "id")


READ = harness.Catalog().module("metrics", "join.one_match_share").read


@pytest.mark.parametrize("emit,build_keys,share", [
    ("merge", list(range(60)), 100.0),
    ("merge", list(range(60)) + [5], 0.0),
    ("legacy", list(range(60)), None),
])
def test_one_match_share(monkeypatch, emit, build_keys, share):
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", emit)
    w = _window(_join(build_keys))
    assert READ(w) == share
    w.trace.host = [o for o in w.trace.host if o.name != "att.sync.join_counts"]  # an earlier program
    assert READ(w) is None
    w.trace_complete = False
    assert READ(w) is None
