"""take, merge, put and the RecordBatch transforms of arrow_tpu_torch against
arrow_tpu: bool, nullable, u32 (values >= 2^31), 64-bit and 16-bit columns,
repeated and out-of-range indices (take's clamp; put drops destinations
past the length), every combination of validity buffers in merge.  Exact."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import kernels as JK
from arrow_tpu.table import RecordBatch as JBatch
from arrow_tpu_torch import kernels as TK
from torch_helpers import assert_same, assert_zero_tail, batch_to_torch, jax_to_torch

N = 1000


def _column(rng, name, null_p):
    if name == "bool":
        vals = (rng.random(N) < 0.5).tolist()
        cls = at.BooleanArray
    else:
        if name == "uint32":
            vals = rng.integers(2**31 - 10, 2**32, N, dtype=np.uint32)
        elif name.startswith("float"):
            vals = rng.standard_normal(N).astype(name)
        else:
            info = np.iinfo(np.dtype(name))
            vals = rng.integers(info.min, info.max, N, dtype=np.dtype(name), endpoint=True)
        vals = vals.tolist()
        cls = None
    if null_p:
        vals = [v if ok else None for v, ok in zip(vals, rng.random(N) >= null_p)]
        if cls is at.BooleanArray:
            return at.BooleanArray.from_optional_slice(vals)
        return at.PrimitiveArray.from_optional_slice(vals, dtype=at.ArrowType(name))
    if cls is at.BooleanArray:
        return at.BooleanArray.from_slice(vals)
    return at.PrimitiveArray.from_slice(np.asarray(vals, dtype=name), dtype=at.ArrowType(name))


def _indexes(rng, n_out, hi):
    idx = rng.integers(0, hi, n_out).astype(np.uint32)
    idx[:5] = [0, hi - 1, hi - 1, 3, 0][:n_out]  # repeats and both ends
    return at.UInt32Array.from_slice(idx)


@pytest.mark.parametrize("name", ["bool", "uint32", "int32", "int64", "uint64", "float32", "float64", "int16"])
@pytest.mark.parametrize("null_p", [0.0, 0.3])
@pytest.mark.parametrize("n_out", [1, 777, 2500])
def test_take_matches_jax(name, null_p, n_out):
    rng = np.random.default_rng(n_out)
    col = _column(rng, name, null_p)
    idx = _indexes(rng, n_out, N)
    assert_same(JK.take(col, idx), TK.take(jax_to_torch(col), jax_to_torch(idx)))


def test_take_clamps_out_of_range_indexes():
    rng = np.random.default_rng(3)
    col = _column(rng, "int32", 0.2)
    idx = at.UInt32Array.from_slice(np.array([0, N + 5, 2**32 - 1, 7], np.uint32))
    got = TK.take(jax_to_torch(col), jax_to_torch(idx))
    want = JK.take(col, idx)
    # JAX clamps into its padded buffer, whose rows past the length are zero
    # and null: the port's buffer is padded less, so compare in-range rows
    np.testing.assert_array_equal(got.raw_values()[[0, 3]], want.raw_values()[[0, 3]])
    assert got.length == 4 and got.values()[1] == got.values()[2]


def test_take_rejects_non_u32_indexes():
    col = jax_to_torch(at.Int32Array.from_slice([1, 2, 3]))
    with pytest.raises(Exception):
        TK.take(col, jax_to_torch(at.Int32Array.from_slice([0, 1])))


def test_record_batch_transforms_match_jax():
    rng = np.random.default_rng(4)
    jb = JBatch({"a": _column(rng, "int32", 0.2), "b": _column(rng, "bool", 0.0), "c": _column(rng, "float64", 0.0)})
    tb = batch_to_torch(jb)
    idx = _indexes(rng, 300, N)
    for jt, tt in (
        (jb.select(["c", "a"]), tb.select(["c", "a"])),
        (jb.rename({"a": "x"}), tb.rename({"a": "x"})),
        (jb.with_column("d", jb["a"]), tb.with_column("d", tb["a"])),
        (jb.take(idx), tb.take(jax_to_torch(idx))),
    ):
        assert jt.column_names == tt.column_names
        for name in jt.column_names:
            assert_same(jt[name], tt[name])
    assert jb.to_pydict() == tb.to_pydict()
    for name, arr in jb.to_numpy().items():
        np.testing.assert_array_equal(arr, tb.to_numpy()[name])


MERGE_DTYPES = ["bool", "uint32", "int8", "uint64", "float64", "date32"]
# which of (a, b, mask) carry a validity buffer
VALIDITY = [(va, vb, vm) for va in (False, True) for vb in (False, True) for vm in (False, True)]


@pytest.mark.parametrize("validity", VALIDITY, ids=lambda v: "".join("ABM"[i] if x else "-" for i, x in enumerate(v)))
@pytest.mark.parametrize("name", MERGE_DTYPES)
def test_merge_matches_jax(name, validity):
    """merge's values and its 4-stage validity (a side without a bitmap
    drops out; the mask's validity is cloned when neither side has one)."""
    rng = np.random.default_rng([MERGE_DTYPES.index(name), VALIDITY.index(validity)])
    n = 777
    a, b = (_column_n(rng, name, n, 0.3 if v else 0.0) for v in validity[:2])
    m = _column_n(rng, "bool", n, 0.2 if validity[2] else 0.0)
    assert_same(JK.merge(a, b, m), TK.merge(jax_to_torch(a), jax_to_torch(b), jax_to_torch(m)))


PUT_DTYPES = ["bool", "float32", "uint32", "int64", "uint16", "date32"]


@pytest.mark.parametrize("nulls", ["none", "src", "dst", "both"])
@pytest.mark.parametrize("name", PUT_DTYPES)
def test_put_matches_jax(name, nulls):
    """put over distinct destination indices (a duplicate's winner is
    implementation-defined in both packages), source indices repeated, and
    index arrays of unequal lengths (n = the shorter)."""
    rng = np.random.default_rng([PUT_DTYPES.index(name), ["none", "src", "dst", "both"].index(nulls)])
    src = _column_n(rng, name, 400, 0.3 if nulls in ("src", "both") else 0.0)
    dst = _column_n(rng, name, 650, 0.3 if nulls in ("dst", "both") else 0.0)
    si = at.UInt32Array.from_slice(rng.integers(0, 400, 300).astype(np.uint32))
    di = at.UInt32Array.from_slice(rng.permutation(650)[:250].astype(np.uint32))
    tdst = jax_to_torch(dst)
    assert TK.put(jax_to_torch(src), jax_to_torch(si), tdst, jax_to_torch(di)) is None
    JK.put(src, si, dst, di)
    assert_same(dst, tdst)


def test_put_drops_destinations_past_the_length():
    src = at.Int32Array.from_slice([7, 8, 9])
    dst = at.Int32Array.from_optional_slice([1, None, 3])
    idx = at.UInt32Array.from_slice(np.array([0, 1, 2], np.uint32))
    far = at.UInt32Array.from_slice(np.array([2, 3, 2**32 - 1], np.uint32))
    tdst = jax_to_torch(dst)
    TK.put(jax_to_torch(src), jax_to_torch(idx), tdst, jax_to_torch(far))
    assert tdst.values() == [1, None, 7]
    assert_zero_tail(tdst)


def _column_n(rng, name, n, null_p):
    if name == "bool":
        vals = (rng.random(n) < 0.5).tolist()
    else:
        npdt = np.dtype("int32" if name == "date32" else name)
        if npdt.kind == "f":
            vals = rng.standard_normal(n).astype(npdt).tolist()
        else:
            info = np.iinfo(npdt)
            vals = rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True).tolist()
    if null_p:
        vals = [v if ok else None for v, ok in zip(vals, rng.random(n) >= null_p)]
        if name == "bool":
            return at.BooleanArray.from_optional_slice(vals)
        return at.PrimitiveArray.from_optional_slice(vals, dtype=at.ArrowType(name))
    if name == "bool":
        return at.BooleanArray.from_slice(vals)
    return at.PrimitiveArray.from_slice(np.asarray(vals, dtype=npdt), dtype=at.ArrowType(name))
