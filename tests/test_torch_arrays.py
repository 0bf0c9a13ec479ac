"""Array layer of arrow_tpu_torch against arrow_tpu: Arrow buffer round trips
per dtype (nullable and not), the unsigned storage rule, bitmap helpers."""

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.utils import bits as JB
from arrow_tpu_torch import dtypes as tdt
from arrow_tpu_torch.utils import bits as TB
from torch_helpers import assert_same, jax_to_torch

DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float32", "float64", "date32", "bool"]


def _host_values(rng, name, n):
    if name == "bool":
        return rng.random(n) < 0.5
    if name == "date32":
        return rng.integers(-(2**31), 2**31, n).astype(np.int32)
    npdt = np.dtype(name)
    if npdt.kind == "f":
        v = rng.standard_normal(n).astype(npdt)
        v[::17] = np.nan
        return v
    info = np.iinfo(npdt)
    return rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)


def _jax_array(name, vals, valid):
    t = at.ArrowType(name)
    if t is at.ArrowType.BOOL:
        if valid is None:
            return at.BooleanArray.from_slice(vals.tolist())
        return at.BooleanArray.from_optional_slice(
            [bool(v) if ok else None for v, ok in zip(vals, valid)]
        )
    cls = at.PrimitiveArray
    if valid is None:
        return cls.from_slice(vals, dtype=t)
    return cls.from_optional_slice([v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=t)


def _torch_array(name, vals, valid):
    t = att.ArrowType(name)
    if t is att.ArrowType.BOOL:
        if valid is None:
            return att.BooleanArray.from_slice(vals.tolist(), device="cpu")
        return att.BooleanArray.from_optional_slice(
            [bool(v) if ok else None for v, ok in zip(vals, valid)], device="cpu"
        )
    if valid is None:
        return att.PrimitiveArray.from_slice(vals, dtype=t, device="cpu")
    return att.PrimitiveArray.from_optional_slice(
        [v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=t, device="cpu"
    )


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("name", DTYPES)
def test_buffers_round_trip(name, nullable):
    rng = np.random.default_rng([DTYPES.index(name), nullable])
    n = 1000
    vals = _host_values(rng, name, n)
    valid = rng.random(n) < 0.8 if nullable else None
    ja = _jax_array(name, vals, valid)
    # JAX -> buffers -> port: identical bytes, zero tail
    ta = jax_to_torch(ja)
    assert_same(ja, ta)
    # both packages built from the same host values agree too
    assert_same(ja, _torch_array(name, vals, valid))
    # the port's values() reads back what the JAX package reads back
    jv, tv = ja.values(), ta.values()
    assert len(jv) == len(tv) == n
    for a, b in zip(jv, tv):
        assert (a is None and b is None) or a == b or (a != a and b != b)


def test_u32_high_values_keep_unsigned_meaning():
    vals = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 3_000_000_000], np.uint32)
    ta = att.UInt32Array.from_slice(vals, device="cpu")
    assert ta.data.dtype == torch.int32  # stored as the signed bit pattern
    np.testing.assert_array_equal(ta.raw_values(), vals)
    assert ta.values() == vals.tolist()
    assert_same(at.UInt32Array.from_slice(vals), ta)
    wide = tdt.widen(ta.data[: len(vals)], att.ArrowType.UINT32)
    np.testing.assert_array_equal(wide.numpy(), vals.astype(np.int64))
    # the ordered key sorts in unsigned order
    order = torch.sort(tdt.order_key(ta.data[: len(vals)], att.ArrowType.UINT32)).indices
    np.testing.assert_array_equal(vals[order.numpy()], np.sort(vals))


def test_u64_order_and_float64():
    vals = np.array([0, 1, 2**63 - 1, 2**63, 2**64 - 1, 12345678901234567890], np.uint64)
    ta = att.UInt64Array.from_slice(vals, device="cpu")
    data = ta.data[: len(vals)]
    order = torch.sort(tdt.order_key(data, att.ArrowType.UINT64)).indices
    np.testing.assert_array_equal(vals[order.numpy()], np.sort(vals))
    np.testing.assert_array_equal(
        tdt.to_float64(data, att.ArrowType.UINT64).numpy(), vals.astype(np.float64)
    )


@pytest.mark.parametrize("name", ["int8", "int16", "int32", "uint8", "uint16", "uint32"])
def test_narrow_wraps(name):
    t = att.ArrowType(name)
    wide = torch.tensor([0, 1, -1, 2**40 + 5, -(2**40) - 3, 2**31, 2**32 - 1])
    got = tdt.from_storage_np(tdt.narrow(wide, t).numpy(), t)
    np.testing.assert_array_equal(got, wide.numpy().astype(np.dtype(name)))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000])
def test_bits_match_jax(n):
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.5
    words_np = TB.pack_bits_np(mask)
    np.testing.assert_array_equal(words_np, JB.pack_bits_np(mask))
    padded = np.zeros(TB.num_words(n) * 32, bool)
    padded[:n] = mask
    tw = TB.pack_bits(torch.from_numpy(padded))
    jw = np.asarray(JB.pack_bits(jnp.asarray(padded)))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)
    np.testing.assert_array_equal(TB.unpack_bits(tw, n).numpy(), mask)
    assert int(TB.popcount_words(tw)) == int(mask.sum())
    full = torch.full((TB.num_words(n) + 1,), -1, dtype=torch.int32)
    jt = np.asarray(JB.tail_mask_words(TB.num_words(n) + 1, n))
    np.testing.assert_array_equal(TB.mask_tail(full, n).numpy().view(np.uint32), jt)
    np.testing.assert_array_equal(TB.unpack_bits_np(words_np, n), mask)


def test_record_batch_from_arrow_buffers():
    from arrow_tpu import io as jio
    from arrow_tpu.table import RecordBatch as JBatch

    rng = np.random.default_rng(1)
    k = rng.integers(0, 2**32, 300, dtype=np.uint32)
    v = rng.standard_normal(300).astype(np.float32)
    jb = JBatch.from_numpy({"k": k, "v": v})
    bufs = {name: {**jio.to_arrow_buffers(c), "dtype": c.dtype.value} for name, c in jb.columns().items()}
    tb = att.RecordBatch.from_arrow_buffers(bufs, device="cpu")
    assert tb.num_rows == 300 and tb.column_names == ["k", "v"]
    assert_same(jb["k"], tb["k"])
    assert_same(jb["v"], tb["v"])
    tb2 = att.RecordBatch.from_numpy({"k": k, "v": v}, device="cpu")
    assert tb2.schema == [("k", att.ArrowType.UINT32), ("v", att.ArrowType.FLOAT32)]
    assert_same(jb["k"], tb2["k"])


def test_device_is_carried():
    a = att.Int32Array.from_slice([1, 2, 3], device="cpu")
    assert a.device.platform == "cpu" and a.data.device.type == "cpu"
    assert a.null_count() == 0 and a.is_valid(2)
    b = att.Int32Array.from_optional_slice([1, None, 3], device="cpu")
    assert b.null_count() == 1 and b.is_null(1)
    assert b.null_buffer().null_count() == 1
