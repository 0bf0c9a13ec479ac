"""The public filter of arrow_tpu_torch against arrow_tpu.compute.filter:
record batches with nullable 32-bit, 64-bit, narrow and bool columns, a
nullable mask, both routes; exact, with zero tails."""

import sys

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import compute as JC
from arrow_tpu.table import RecordBatch as JBatch
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch.compute.kernels import compaction3 as C3
from arrow_tpu_torch.compute.kernels import plain_versions
from torch_helpers import assert_same, batch_to_torch, jax_to_torch


def _optional(vals, valid):
    return [v if ok else None for v, ok in zip(vals.tolist(), valid)]


def _batch(rng, n):
    return JBatch({
        "u32": at.UInt32Array.from_optional_slice(
            _optional(rng.integers(0, 2**32, n, dtype=np.uint32), rng.random(n) < 0.8)
        ),
        "f32": at.Float32Array.from_slice(rng.standard_normal(n).astype(np.float32)),
        "i64": at.Int64Array.from_optional_slice(
            _optional(rng.integers(-(2**62), 2**62, n), rng.random(n) < 0.7)
        ),
        "u64": at.UInt64Array.from_slice(rng.integers(0, 2**64, n, dtype=np.uint64)),
        "f64": at.Float64Array.from_slice(rng.standard_normal(n)),
        "i16": at.Int16Array.from_slice(rng.integers(-(2**15), 2**15, n).astype(np.int16)),
        "b": at.BooleanArray.from_optional_slice(
            [bool(x) if ok else None for x, ok in zip(rng.random(n) < 0.5, rng.random(n) < 0.9)]
        ),
        "d": at.Date32Array.from_slice(rng.integers(0, 20000, n).astype(np.int32)),
    })


def _mask(rng, n, sel, nullable):
    bits = rng.random(n) < sel
    if not nullable:
        return at.BooleanArray.from_slice(bits.tolist())
    return at.BooleanArray.from_optional_slice(
        [bool(x) if ok else None for x, ok in zip(bits, rng.random(n) < 0.9)]
    )


@pytest.mark.parametrize("sel", [0.0, 0.01, 0.5, 0.99, 1.0])
def test_batch_filter_matches_jax(sel):
    rng = np.random.default_rng(int(sel * 100))
    n = 5000
    jb = _batch(rng, n)
    jm = _mask(rng, n, sel, nullable=True)
    want = JC.filter(jb, jm)
    tb, tm = batch_to_torch(jb), jax_to_torch(jm)
    with plain_versions():
        plain = TC.filter(tb, tm)
    for got in (TC.filter(tb, tm), TC.filter(tb, tm, method="sort"), plain):
        assert got.num_rows == want.num_rows == TC.filter_count(tm)
        for name in want.column_names:
            assert_same(want[name], got[name])


@pytest.mark.parametrize("n", [1, 31, 32, 100, 8192])
def test_single_array_filter_matches_jax(n):
    rng = np.random.default_rng(n)
    ja = at.Int32Array.from_optional_slice(
        _optional(rng.integers(-100, 100, n).astype(np.int32), rng.random(n) < 0.6)
    )
    jm = _mask(rng, n, 0.4, nullable=False)
    want = JC.filter(ja, jm)
    got = TC.filter(jax_to_torch(ja), jax_to_torch(jm))
    assert_same(want, got)
    bools = at.BooleanArray.from_slice((rng.random(n) < 0.5).tolist())
    assert_same(JC.filter(bools, jm), TC.filter(jax_to_torch(bools), jax_to_torch(jm)))


@pytest.mark.parametrize("form", ["array", "nullable array", "batch"])
def test_method_pallas_names_the_kernel_route(form, monkeypatch):
    """method="pallas", the JAX package's name for its hand-kernel route, is
    the port's kernel B1 route; same rows as the JAX package's (whose kernel
    runs interpreted on the CPU, on its 8192-row-padded buffers)."""
    n = 8192
    rng = np.random.default_rng(n)
    a = at.Int32Array.from_slice(np.arange(n, dtype=np.int32))
    if form == "array":
        jm = at.kernels.gt_scalar(a, 100)
        want = JC.filter(a, jm, method="pallas")
        assert len(want) == 8091
        got = TC.filter(jax_to_torch(a), jax_to_torch(jm), method="pallas")
        assert_same(want, got)
        return
    nullable = at.Float32Array.from_optional_slice(
        _optional(rng.standard_normal(n).astype(np.float32), rng.random(n) < 0.7)
    )
    jm = _mask(rng, n, 0.5, nullable=True)
    calls = []
    real = C3.compact_multi
    # the module, which the function of the same name shadows on the package
    monkeypatch.setattr(sys.modules["arrow_tpu_torch.compute.filter"], "compact_multi",
                        lambda *args: calls.append(1) or real(*args))
    if form == "nullable array":
        assert_same(JC.filter(nullable, jm, method="pallas"),
                    TC.filter(jax_to_torch(nullable), jax_to_torch(jm), method="pallas"))
    else:
        jb = JBatch({"a": a, "f": nullable})
        want = JC.filter(jb, jm, method="pallas")
        got = TC.filter(batch_to_torch(jb), jax_to_torch(jm), method="pallas")
        assert got.num_rows == want.num_rows
        for name in want.column_names:
            assert_same(want[name], got[name])
    assert calls, "method='pallas' did not go through compact_multi"


def test_filter_indices_matches_jax():
    rng = np.random.default_rng(3)
    jm = _mask(rng, 3000, 0.3, nullable=True)
    (wi, wk), (gi, gk) = JC.filter_indices(jm), TC.filter_indices(jax_to_torch(jm))
    assert wk == gk
    assert_same(wi, gi)


def test_filter_errors():
    a = att.Int32Array.from_slice([1, 2, 3], device="cpu")
    m = att.BooleanArray.from_slice([True, False, True], device="cpu")
    with pytest.raises(att.OperationNotSupported):
        TC.filter(a, a)
    with pytest.raises(att.OperationNotSupported):
        TC.filter(a, att.BooleanArray.from_slice([True], device="cpu"))
    with pytest.raises(att.OperationNotSupported):
        TC.filter(a, m, method="no-such-route")


def test_batch_with_many_columns_takes_several_launch_groups():
    rng = np.random.default_rng(9)
    n = 700
    cols = {f"c{i}": rng.integers(0, 1000, n).astype(np.int32) for i in range(C3.MAX_PLANES + 3)}
    keep = rng.random(n) < 0.5
    tb = att.RecordBatch.from_numpy(cols, device="cpu")
    got = TC.filter(tb, att.BooleanArray.from_slice(keep, device="cpu"))
    for name, v in cols.items():
        np.testing.assert_array_equal(got[name].raw_values(), v[keep])
