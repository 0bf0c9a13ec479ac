"""hash_aggregate of arrow_tpu_torch against arrow_tpu.compute.hash_aggregate:
the sort route (sum/count/min/max/mean, nullable keys and values,
i32/u32 (values >= 2^31)/i64/u64/f32, every key width) and the radix route
under ARROW_TPU_FORCE_RADIX_AGG=1, which steers both packages.  Integers are
exact; f32 sums are held to rtol=1e-6 and means to rtol=1e-12 (summation
order only).  The mxu and partition routes are in test_torch_groupby_mxu.py
and test_torch_groupby_region.py."""

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
    """The mxu, partition and radix routes are ported: named explicitly, each
    raises on inputs it cannot take (as arrow_tpu does) and answers on those
    it can; float keys raise on every route."""
    k = att.UInt32Array.from_slice([1, 2], device="cpu")
    for method in ("mxu", "partition", "radix"):
        ok = method == "mxu"  # keys in [0, 4096): only the mxu route takes them on the CPU
        if ok:
            assert TC.hash_aggregate(k, [("n", None, "count")], method=method).num_rows == 2
        else:
            with pytest.raises(att.OperationNotSupported, match=f"{method} groupby requires"):
                TC.hash_aggregate(k, [("n", None, "count")], method=method)
    with pytest.raises(att.OperationNotSupported):
        TC.hash_aggregate(att.Float32Array.from_slice([1.0], device="cpu"), [("n", None, "count")])


RADIX_N = 8192  # a full buffer in both packages


def _radix_case(rng, kname, vname):
    keys = {
        "uint32": lambda: rng.integers(2**31 - 40, 2**31 + 40, RADIX_N).astype(np.uint32),
        "int32": lambda: rng.integers(-30, 30, RADIX_N).astype(np.int32),
        "date32": lambda: rng.integers(-20, 20, RADIX_N).astype(np.int32),
    }[kname]()
    return (at.PrimitiveArray.from_slice(keys, dtype=at.ArrowType(kname)),
            _column(rng, vname, RADIX_N, 0.0))


@pytest.mark.parametrize("kname,vname", [("uint32", "int32"), ("int32", "uint32"), ("date32", "float32")])
def test_radix_route_matches_jax(kname, vname, monkeypatch):
    """ARROW_TPU_FORCE_RADIX_AGG=1 sends both packages' auto route to the
    radix group-by on the CPU (the JAX package's chain interpreted)."""
    monkeypatch.setenv("ARROW_TPU_FORCE_RADIX_AGG", "1")
    rng = np.random.default_rng(len(kname) + len(vname))
    jk, jv = _radix_case(rng, kname, vname)
    aggs = [(a, jv, a) for a in AGGS] + [("rows", None, "count")]
    want = JC.hash_aggregate(jk, aggs)
    tk, tv = jax_to_torch(jk), jax_to_torch(jv)
    taggs = [(a, tv, a) for a in AGGS] + [("rows", None, "count")]
    for method in ("auto", "radix"):
        _check(want, TC.hash_aggregate(tk, taggs, method=method))
    with plain_versions():
        _check(want, TC.hash_aggregate(tk, taggs, method="radix"))


@pytest.mark.parametrize("case", ["int16_values", "int64_values", "nulls", "padded"])
def test_radix_route_ineligible_falls_back(case, monkeypatch):
    """Inputs the radix route cannot take go to the sort route under auto
    and raise under method="radix", forced or not; the answer is the JAX
    package's sort route's.  (The JAX radix route itself raises ValueError
    on 8- and 16-bit values: a known defect the port does not copy.)"""
    monkeypatch.setenv("ARROW_TPU_FORCE_RADIX_AGG", "1")
    rng = np.random.default_rng(len(case))
    n = RADIX_N - 5 if case == "padded" else RADIX_N
    jk = _keys(rng, "uint32", n, 0.1 if case == "nulls" else 0.0)
    vname = {"int16_values": "int16", "int64_values": "int64"}.get(case, "int32")
    jv = _column(rng, vname, n, 0.0)
    aggs = [("s", jv, "sum"), ("mx", jv, "max"), ("c", None, "count")]
    want = JC.hash_aggregate(jk, aggs, method="sort")
    tk, tv = jax_to_torch(jk), jax_to_torch(jv)
    taggs = [("s", tv, "sum"), ("mx", tv, "max"), ("c", None, "count")]
    _check(want, TC.hash_aggregate(tk, taggs))
    with pytest.raises(att.OperationNotSupported, match="radix groupby requires"):
        TC.hash_aggregate(tk, taggs, method="radix")


@pytest.mark.parametrize("route", ["auto", "mxu", "partition", "radix", "sort"])
def test_zero_rows_give_zero_groups(route, monkeypatch):
    """A 0-row group-by returns 0 groups on every route (the JAX package
    raises there: its range check reduces an empty array).  The partition
    route is told its key domain, since no key says it; the radix route is
    forced onto the CPU."""
    keys = att.UInt32Array.from_slice(np.zeros(0, np.uint32), device="cpu")
    vals = att.Int32Array.from_slice(np.zeros(0, np.int32), device="cpu")
    kwargs = {"key_domain": (0, 1 << 20)} if route == "partition" else {}
    if route == "radix":
        monkeypatch.setenv("ARROW_TPU_FORCE_RADIX_AGG", "1")
    out = TC.hash_aggregate(keys, [("s", vals, "sum"), ("c", vals, "count"), ("n", None, "count")],
                            method=route, **kwargs)
    assert out.num_rows == 0 and out.column_names == ["key", "s", "c", "n"]
    assert out.to_pydict() == {"key": [], "s": [], "c": [], "n": []}
    for name in out.column_names:
        assert not out[name].data.any()
