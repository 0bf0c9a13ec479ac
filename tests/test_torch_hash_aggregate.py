"""hash_aggregate of arrow_tpu_torch (sort route) against
arrow_tpu.compute.hash_aggregate: sum/count/min/max/mean, nullable keys and
values, i32/u32 (values >= 2^31)/i64/u64/f32, and every key width.  Integers are exact; f32 sums are
held to rtol=1e-6 and means to rtol=1e-12 (summation order only)."""

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import compute as JC
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch.compute.kernels import plain_versions
from torch_helpers import assert_same, jax_to_torch

AGGS = ["sum", "count", "min", "max", "mean"]


def _column(rng, name, n, null_p):
    if name == "float32":
        vals = rng.standard_normal(n).astype(np.float32)
    elif name == "uint32":
        vals = rng.integers(2**31 - 50, 2**32, n, dtype=np.uint32)
    else:
        info = np.iinfo(np.dtype(name))
        vals = rng.integers(info.min, info.max, n, dtype=np.dtype(name), endpoint=True)
    t = at.ArrowType(name)
    if null_p == 0:
        return at.PrimitiveArray.from_slice(vals, dtype=t)
    valid = rng.random(n) >= null_p
    return at.PrimitiveArray.from_optional_slice(
        [v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=t
    )


def _keys(rng, name, n, null_p):
    pool = {
        "uint32": np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1, 3_000_000_000, 77], np.uint32),
        "int32": np.array([-(2**31), -7, 0, 3, 2**31 - 1, 12], np.int32),
        "int64": np.array([-(2**63), -(2**40), 0, 2**40, 2**63 - 1], np.int64),
        "uint64": np.array([0, 2**63 - 1, 2**63, 2**64 - 1, 1234], np.uint64),
        "int16": np.array([-(2**15), -1, 0, 2**15 - 1], np.int16),
        "date32": np.array([-719162, 0, 18000, 2932896], np.int32),
    }[name]
    keys = pool[rng.integers(0, pool.shape[0], n)]
    t = at.ArrowType(name)
    if null_p == 0:
        return at.PrimitiveArray.from_slice(keys, dtype=t)
    valid = rng.random(n) >= null_p
    return at.PrimitiveArray.from_optional_slice(
        [k if ok else None for k, ok in zip(keys.tolist(), valid)], dtype=t
    )


def _check(want, got):
    assert want.column_names == got.column_names
    assert want.num_rows == got.num_rows
    for name in want.column_names:
        w = want[name]
        rtol = 1e-12 if w.dtype is at.ArrowType.FLOAT64 else 1e-6
        assert_same(w, got[name], rtol=rtol)


VALUE_TYPES = ["int32", "uint32", "int64", "uint64", "float32"]


@pytest.mark.parametrize("vname", VALUE_TYPES)
def test_all_aggregations_nullable(vname):
    rng = np.random.default_rng(VALUE_TYPES.index(vname))
    n = 3000
    jk = _keys(rng, "uint32", n, 0.1)
    jv = _column(rng, vname, n, 0.2)
    aggs = [(a, jv, a) for a in AGGS] + [("rows", None, "count")]
    want = JC.hash_aggregate(jk, aggs)
    tk, tv = jax_to_torch(jk), jax_to_torch(jv)
    taggs = [(a, tv, a) for a in AGGS] + [("rows", None, "count")]
    _check(want, TC.hash_aggregate(tk, taggs))
    with plain_versions():
        _check(want, TC.hash_aggregate(tk, taggs))


@pytest.mark.parametrize("kname", ["int32", "int64", "uint64", "int16", "date32"])
def test_key_types(kname):
    rng = np.random.default_rng(10 + len(kname))
    n = 2000
    jk = _keys(rng, kname, n, 0.05)
    jv = _column(rng, "int32", n, 0.0)
    want = JC.hash_aggregate(jk, [("s", jv, "sum"), ("mx", jv, "max"), ("c", None, "count")])
    tk, tv = jax_to_torch(jk), jax_to_torch(jv)
    got = TC.hash_aggregate(tk, [("s", tv, "sum"), ("mx", tv, "max"), ("c", None, "count")])
    _check(want, got)


def test_dense_keys_without_nulls():
    """Every row valid and a full buffer: the one-key (dense) branch."""
    rng = np.random.default_rng(4)
    n = 4096
    jk = _keys(rng, "uint32", n, 0.0)
    jv = _column(rng, "float32", n, 0.0)
    want = JC.hash_aggregate(jk, [("t", jv, "sum"), ("lo", jv, "min"), ("n", None, "count")])
    tk, tv = jax_to_torch(jk), jax_to_torch(jv)
    got = TC.hash_aggregate(tk, [("t", tv, "sum"), ("lo", tv, "min"), ("n", None, "count")], method="sort")
    _check(want, got)


def test_unported_routes_raise():
    k = att.UInt32Array.from_slice([1, 2], device="cpu")
    for method in ("mxu", "partition", "radix"):
        with pytest.raises(att.OperationNotSupported, match="not yet ported"):
            TC.hash_aggregate(k, [("n", None, "count")], method=method)
    with pytest.raises(att.OperationNotSupported):
        TC.hash_aggregate(att.Float32Array.from_slice([1.0], device="cpu"), [("n", None, "count")])
