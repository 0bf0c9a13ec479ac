"""Kernel B5 (COUNT and exact SUM by dense keys in [0, 4096)): the plain
PyTorch version against arrow_tpu's groupby_dense_pallas, which runs
interpreted here as ``tests/test_groupby_mxu.py`` runs it (16384 rows), and
the port's mxu route of hash_aggregate against arrow_tpu's hash_aggregate
through ``io`` buffers: values, the num_groups prefix, the zero tail; means
at rtol 1e-12.  Integers exact.  The CUDA kernel is held against the plain
version in test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import compute as JC
from arrow_tpu.compute.kernels.groupby_mxu import groupby_dense_pallas
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch.compute.kernels import groupby_mxu as GM
from arrow_tpu_torch.compute.kernels import plain_versions
from torch_helpers import assert_same, jax_to_torch

N = 16384


@functools.lru_cache(maxsize=None)
def _kernel_inputs(nlimb):
    rng = np.random.default_rng(nlimb)
    keys = rng.integers(0, 4096, N).astype(np.uint32)
    vals = rng.integers(0, 2 ** (8 * nlimb), N, dtype=np.uint64).astype(np.uint32)  # u32 >= 2^31 at 4 limbs
    return keys, vals


@pytest.mark.parametrize("nlimb", [1, 4])
@pytest.mark.parametrize("length", [N, N - 1000])
def test_plain_matches_pallas(nlimb, length):
    import jax.numpy as jnp

    keys, vals = _kernel_inputs(nlimb)
    jc, jt = groupby_dense_pallas(jnp.asarray(keys), jnp.asarray(vals), nlimb=nlimb, length=length,
                                  interpret=True)
    tc, tt = GM.groupby_dense(torch.from_numpy(keys.view(np.int32)), torch.from_numpy(vals.view(np.int32)),
                              nlimb, length)
    assert tc.dtype == torch.int32 and tt.dtype == torch.int64 and tc.shape == tt.shape == (GM.SLOTS,)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    exp = np.zeros(GM.SLOTS, np.int64)
    np.add.at(exp, keys[:length], vals[:length].astype(np.int64))
    np.testing.assert_array_equal(tt.numpy(), exp)


def test_plain_cuts_values_and_drops_keys_outside_the_table():
    """Values keep their low 8 x nlimb bits (the TPU kernel's limbs) and keys
    outside [0, 4096), negative ones included, add nothing."""
    keys = torch.tensor([0, 5, 4095, 4096, -1, 5], dtype=torch.int32)
    vals = torch.tensor([0x1FF, 0x300, -1, 7, 7, 1], dtype=torch.int32)
    count, total = GM.groupby_dense_plain(keys, vals, 1)
    assert count[[0, 5, 4095]].tolist() == [1, 2, 1] and int(count.sum()) == 4
    assert total[[0, 5, 4095]].tolist() == [0xFF, 1, 0xFF]
    _, total4 = GM.groupby_dense_plain(keys, vals, 4)
    assert total4[[0, 5, 4095]].tolist() == [0x1FF, 0x301, 2**32 - 1]


def test_wrapper_routes_by_device_and_checks():
    keys = torch.tensor([1, 2, 2], dtype=torch.int32)
    count, total = GM.groupby_dense(keys, keys, 1)
    assert count[:3].tolist() == [0, 1, 2] and total[:3].tolist() == [0, 1, 4]
    with pytest.raises(ValueError):
        GM.groupby_dense_cuda(keys, keys, 1)
    with pytest.raises(ValueError):  # 64-bit values
        GM.groupby_dense(keys, keys.to(torch.int64), 1)
    with pytest.raises(ValueError):
        GM.groupby_dense(keys, keys, 5)


def _check(want, got):
    assert want.column_names == got.column_names
    assert want.num_rows == got.num_rows
    for name in want.column_names:
        assert_same(want[name], got[name], rtol=1e-12)


def _run_both(jk, jvals, aggs, method, **kw):
    """The same query through both packages; value columns by index."""
    want = JC.hash_aggregate(jk, [(n, None if i is None else jvals[i], a) for n, i, a in aggs],
                             method=method, **kw)
    tk, tvals = jax_to_torch(jk), [jax_to_torch(v) for v in jvals]
    taggs = [(n, None if i is None else tvals[i], a) for n, i, a in aggs]
    got = TC.hash_aggregate(tk, taggs, method=method, **kw)
    _check(want, got)
    with plain_versions():
        _check(want, TC.hash_aggregate(tk, taggs, method=method, **kw))
    return got


AGGS = [("s", 0, "sum"), ("c", 0, "count"), ("m", 0, "mean"), ("n", None, "count"), ("s2", 1, "sum")]


@pytest.mark.parametrize("case", ["u32_keys_i32_values", "u32_values_high", "i16_keys_u8_values", "padded"])
def test_mxu_route_matches_jax(case):
    rng = np.random.default_rng(len(case))
    n = 12_345 if case == "padded" else 8192
    if case == "i16_keys_u8_values":
        jk = at.PrimitiveArray.from_slice(rng.integers(0, 300, n).astype(np.int16), dtype=at.ArrowType.INT16)
        v0 = at.PrimitiveArray.from_slice(rng.integers(0, 256, n).astype(np.uint8), dtype=at.ArrowType.UINT8)
    else:
        jk = at.UInt32Array.from_slice(rng.integers(0, 4096, n).astype(np.uint32))
        high = case == "u32_values_high"  # u32 values >= 2^31: stored negative in the port
        v0 = (at.UInt32Array.from_slice(rng.integers(2**31, 2**32, n, dtype=np.uint64).astype(np.uint32))
              if high else at.Int32Array.from_slice(rng.integers(0, 200, n).astype(np.int32)))
    v1 = at.Int32Array.from_slice(rng.integers(0, 2**31 - 1, n).astype(np.int32))
    got = _run_both(jk, [v0, v1], AGGS, "mxu")
    assert got.num_rows > 0 and got["key"].data.shape[0] == 4096  # one table's groups, zero tail after


def test_mxu_route_key_domain_and_value_bits():
    rng = np.random.default_rng(6)
    jk = at.UInt32Array.from_slice(rng.integers(0, 256, 8192).astype(np.uint32))
    jv = at.Int32Array.from_slice(rng.integers(0, 200, 8192).astype(np.int32))
    _run_both(jk, [jv], [("s", 0, "sum"), ("c", None, "count")], "mxu", key_domain=(0, 256), value_bits=8)
    _run_both(jk, [jv], [("s", 0, "sum")], "auto", key_domain=(0, 4096))


@pytest.mark.parametrize("case", ["negative_values", "int64_values", "wide_keys", "nulls", "min_max"])
def test_ineligible_inputs_fall_back_under_auto(case):
    """auto answers on another route, exactly as the JAX package does."""
    rng = np.random.default_rng(len(case) + 40)
    n = 8192
    keys = rng.integers(0, 64, n).astype(np.uint32)
    if case == "wide_keys":
        keys = rng.integers(0, 2**30, n).astype(np.uint32)
    jk = at.UInt32Array.from_slice(keys)
    if case == "nulls":
        jk = at.UInt32Array.from_optional_slice([int(k) if i % 7 else None for i, k in enumerate(keys)])
    vals = rng.integers(-100 if case == "negative_values" else 0, 100, n)
    jv = (at.Int64Array.from_slice((vals + 2**33).astype(np.int64)) if case == "int64_values"
          else at.Int32Array.from_slice(vals.astype(np.int32)))
    kind = "max" if case == "min_max" else "sum"
    _run_both(jk, [jv], [("s", 0, kind), ("c", None, "count")], "auto")


@pytest.mark.parametrize("method", ["mxu", "partition", "radix"])
def test_ineligible_inputs_raise_under_an_explicit_method(method):
    """As arrow_tpu raises for them (tests/test_groupby_mxu.py:44): keys past
    each route's domain, negative values, nulls; the radix route on the CPU
    without ARROW_TPU_FORCE_RADIX_AGG."""
    rng = np.random.default_rng(7)
    wide = att.UInt32Array.from_slice(rng.integers(0, 2**30, 8192).astype(np.uint32), device="cpu")
    small = att.UInt32Array.from_slice(rng.integers(0, 64, 8192).astype(np.uint32), device="cpu")
    neg = att.Int32Array.from_slice(rng.integers(-100, 100, 8192).astype(np.int32), device="cpu")
    nulls = att.UInt32Array.from_optional_slice([1, None, 3], device="cpu")
    cases = {"mxu": [(wide, None), (small, neg), (nulls, None)],
             "partition": [(wide, None), (small, None), (small, neg)],
             "radix": [(small, None)]}[method]
    for keys, vals in cases:
        aggs = [("s", vals, "sum")] if vals is not None else [("n", None, "count")]
        with pytest.raises(att.OperationNotSupported, match=f"{method} groupby requires"):
            TC.hash_aggregate(keys, aggs, method=method)
    with pytest.raises(att.OperationNotSupported, match="unknown hash_aggregate method"):
        TC.hash_aggregate(small, [("n", None, "count")], method="hash")


def test_u64_keys_past_2_63_stay_off_the_dense_routes():
    """A u64 key of 2^63 or more reads negative as int64.  The JAX package's
    range check casts the maximum so, takes the mxu route and folds the key
    into the low 32 bits of its key (a reference defect, ROADMAP section C);
    the port keeps such keys off the dense routes and answers as the JAX
    package's sort route does."""
    keys = np.array([5, 2**63 + 3, 3, 5], np.uint64)
    vals = np.array([1, 10, 100, 1000], np.int32)
    jk = at.PrimitiveArray.from_slice(keys, dtype=at.ArrowType.UINT64)
    jv = at.Int32Array.from_slice(vals)
    want = JC.hash_aggregate(jk, [("s", jv, "sum")], method="sort")
    assert JC.hash_aggregate(jk, [("s", jv, "sum")]).num_rows == 2  # the defect
    got = TC.hash_aggregate(jax_to_torch(jk), [("s", jax_to_torch(jv), "sum")])
    _check(want, got)
    assert got["key"].raw_values().tolist() == [3, 5, 2**63 + 3]
