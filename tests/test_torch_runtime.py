"""The runtime extras of arrow_tpu_torch against the JAX package on the CPU:
the Device API (synchronize, memory_stats), config.profile and
ARROW_TPU_PROFILE, the profiler (the host log, the timed branches of eager
ops and pipelines, device_report and traces), the health probe and
deadline, the native host runtime (built from csrc/host_runtime.cpp with
g++) and its callers, and utils.timing.  Counterparts of
tests/test_table_misc.py's test_device_api, test_profiler, test_config,
test_health_probe_and_deadline and test_native_host_runtime_if_built."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import kernels as JK
from arrow_tpu.runtime import health as jhealth
from arrow_tpu.runtime import native as jnative
from arrow_tpu.runtime import profiler as jprofiler
from arrow_tpu.utils import bits as JB
from arrow_tpu_torch import io as tio
from arrow_tpu_torch import kernels as TK
from arrow_tpu_torch.runtime import health, native, profiler
from arrow_tpu_torch.utils import bits as TB
from arrow_tpu_torch.utils import timing
from torch_helpers import assert_same, jax_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_api():
    for d in (at.default_device(), att.default_device(), att.Device("cpu")):
        assert d.platform == "cpu"
        buf = d.put(np.float32([1, 2, 3]))
        np.testing.assert_array_equal(d.get(buf), np.float32([1, 2, 3]))
        d.synchronize()
        assert d.memory_stats() == {}  # the CPU keeps no allocator statistics
    assert at.default_device().memory_stats() == att.default_device().memory_stats()


def test_config():
    for pkg in (at, att):
        assert pkg.config.profile is False
        pkg.set_config(profile=True)
        assert pkg.config.profile is True
        pkg.set_config(profile=False)
        with pytest.raises(AttributeError):
            pkg.set_config(bogus=1)
    code = ("import json, arrow_tpu, arrow_tpu_torch; "
            "print(json.dumps([arrow_tpu.config.profile, arrow_tpu_torch.config.profile]))")
    for value, want in (("1", [True, True]), ("0", [False, False])):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT,
                             env={**os.environ, "ARROW_TPU_PROFILE": value, "JAX_PLATFORMS": "cpu"})
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.strip().splitlines()[-1]) == want


def _profiled(pkg, K, prof):
    """test_table_misc.py's test_profiler, through one package: the names
    its log holds and its summary's line count."""
    prof.reset()
    pkg.config.profile = True
    try:
        a = pkg.Float32Array.from_slice([1.0, 2.0], **({} if pkg is at else {"device": "cpu"}))
        K.add_scalar(a, 1.0).values()
        with pkg.ComputePipeline(**({} if pkg is at else {"device": "cpu"})) as p:
            K.mul_scalar_op(a, 2.0, p)
            K.neg_op(a, p)
    finally:
        pkg.config.profile = False
    names = sorted(prof.timings())
    assert all(t >= 0 for ts in prof.timings().values() for t in ts)
    lines = prof.summary().splitlines()
    prof.reset()
    assert prof.timings() == {}
    return names, len(lines)


def test_profiler():
    jnames, jlines = _profiled(at, JK, jprofiler)
    tnames, tlines = _profiled(att, TK, profiler)
    assert tnames == jnames == ["add_scalar", "pipeline[2 ops]"]
    assert tlines == jlines == 2
    with profiler.profile_region("region"):
        pass
    assert list(profiler.timings()) == ["region"]
    profiler.record("x", 0.5)
    assert "x" in profiler.summary() and profiler.timings()["x"] == [0.5]
    profiler.reset()


def test_device_report_and_trace(tmp_path):
    """On the CPU the report holds the CPU ops by self time, folded into the
    log as device:<op>; traces are Chrome traces in the given directory."""
    profiler.reset()
    a = att.Float32Array.from_slice(np.arange(4096, dtype=np.float32), device="cpu")
    rows = profiler.device_report(lambda x: TK.mul_scalar(TK.add_scalar(x, 1.0), 2.0), a, top=5,
                                  logdir=str(tmp_path / "report"))
    assert 1 <= len(rows) <= 5
    assert all(isinstance(n, str) and c >= 1 and ms >= 0 for n, c, ms in rows)
    assert [r[2] for r in rows] == sorted((r[2] for r in rows), reverse=True)
    assert sorted(profiler.timings()) == sorted(f"device:{n}" for n, _, _ in rows)
    assert profiler.device_summary(rows).splitlines()[0].split() == ["kernel", "calls", "total_ms"]
    assert (tmp_path / "report" / "trace.json").is_file()
    with profiler.trace(str(tmp_path / "trace")):
        TK.neg(a)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    with pytest.raises(RuntimeError):
        profiler.stop_trace()
    profiler.reset()


def test_timed_call_waits_and_records():
    profiler.reset()
    out = profiler.timed_call("neg", TK.neg, att.Float32Array.from_slice([1.0], device="cpu"))
    assert out.values() == [-1.0] and len(profiler.timings()["neg"]) == 1
    assert [t.shape for t in profiler.held_tensors({"a": (out, [torch.zeros(3)])})] == [(32,), (3,)]
    profiler.reset()


def test_health_probe_and_deadline():
    for h in (jhealth, health):
        latency = h.probe_device(timeout_s=60.0)
        assert latency >= 0.0
        ok, val = h.with_deadline(lambda: 42, timeout_s=10.0)
        assert ok and val == 42
        ok, val = h.with_deadline(lambda: time.sleep(2.0) or 7, timeout_s=0.2, default=-1)
        assert not ok and val == -1
    assert health.probe_device(timeout_s=60.0, device="cpu") >= 0.0


def test_probe_raises_past_its_deadline(monkeypatch):
    monkeypatch.setattr(health.torch, "zeros", lambda *a, **k: time.sleep(1.0) or torch.ones(8))
    with pytest.raises(health.DeviceWedgedError):
        health.probe_device(timeout_s=0.05, device="cpu")


def test_native_host_runtime_if_built():
    """Seeded masks and words through both packages' bindings."""
    if not native.have_native():
        pytest.skip("no g++ to build csrc/host_runtime.cpp")
    assert native.library_path().is_file() and native.library_path().parent.name == "arrow_tpu_torch"
    rng = np.random.default_rng(1)
    for n in (0, 1, 31, 32, 999, 4096 + 17):
        mask = rng.random(n) < 0.3
        words = n // 32 + 2
        w = native.pack_bits_native(mask.view(np.uint8), words)
        np.testing.assert_array_equal(w, JB.pack_bits_np(mask, words))
        np.testing.assert_array_equal(native.unpack_bits_native(w, n), mask)
        np.testing.assert_array_equal(native.unpack_bits_native(w.view(np.int32), n), mask)
        assert native.popcount_native(w) == int(mask.sum())
        w2 = native.pack_bits_native((~mask).view(np.uint8), words)
        if jnative.have_native():
            assert native.popcount_native(w) == jnative.popcount_native(w)
            np.testing.assert_array_equal(native.and_words_native(w, w2), jnative.and_words_native(w, w2))
        assert int(native.and_words_native(w, w2).sum()) == 0
        np.testing.assert_array_equal(native.and_words_native(w, w), w)
    with pytest.raises(ValueError):
        native.pack_bits_native(np.ones(65, np.uint8), 2)
    for values, npdt in (([1, None, 3], np.int32), ([None, 2.5], np.float64), ([1, 2], np.uint8),
                         (np.arange(5), np.int64), (np.array([1, None], dtype=object), np.float32)):
        got, want = native.densify_optionals(values, npdt), jnative.densify_optionals(values, npdt)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype and got[2] == want[2]
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])


def test_native_callers_match_jax():
    """from_optional_slice, pack_bits_np/unpack_bits_np and the io null count
    (the callers of the host runtime) give the JAX package's results."""
    rng = np.random.default_rng(2)
    vals = [None if v < 0.3 else int(v * 100) for v in rng.random(333)]
    for name in ("int32", "uint16", "float64"):
        j = at.PrimitiveArray.from_optional_slice(vals, dtype=at.ArrowType(name))
        t = att.PrimitiveArray.from_optional_slice(vals, dtype=att.ArrowType(name), device="cpu")
        assert_same(j, t)
        assert tio.to_arrow_buffers(t)["null_count"] == 333 - sum(v is not None for v in vals)
    full = att.Int32Array.from_optional_slice([1, 2, 3], device="cpu")
    assert full.validity is None and full.values() == [1, 2, 3]
    assert att.PrimitiveArray.from_optional_slice([None, 2.5], device="cpu").dtype is att.ArrowType.FLOAT64
    mask = rng.random(1000) < 0.5
    np.testing.assert_array_equal(TB.pack_bits_np(mask, 40), JB.pack_bits_np(mask, 40))
    np.testing.assert_array_equal(TB.unpack_bits_np(TB.pack_bits_np(mask), 1000), mask)
    assert_same(at.BooleanArray.from_optional_slice([True, None, False] * 50),
                att.BooleanArray.from_optional_slice([True, None, False] * 50, device="cpu"))
    j = at.Int32Array.from_optional_slice([1, None, 3, None, None, 6])
    assert tio.to_arrow_buffers(jax_to_torch(j))["null_count"] == 3


def test_device_seconds_per_iter_chains_its_calls():
    """A positive float; each call gets the previous call's output."""
    seen = []

    def step(x):
        seen.append(x)
        return x + 1

    x0 = torch.zeros(1 << 12)
    s = timing.device_seconds_per_iter(step, x0, k_lo=2, k_hi=5, repeats=2)
    assert isinstance(s, float) and s > 0
    runs = len(seen)
    assert runs >= 2 * (2 + 5)  # the warm-up runs and at least one sample
    assert all(float(t[0]) == i for i, t in enumerate(seen[:2]))  # 0, then 0 + 1
    both = timing.device_seconds_per_iter(lambda a, b: (b, a), (torch.zeros(4), torch.ones(4)), 1, 3)
    assert both > 0
