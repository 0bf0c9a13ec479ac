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


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("layout", ["whole_words", "partial_word", "odd_offset", "offset_8", "strided", "empty"])
def test_pack_bits_any_layout(layout, share):
    """pack_bits (eight rows a 64-bit lane) equals numpy's little-endian
    packbits on masks of any length, offset and stride; all ones sets bit 31
    of every word and the top bit of every lane."""
    n = {"whole_words": 4096, "partial_word": 1000, "empty": 0}.get(layout, 2016)
    full = np.random.default_rng(len(layout)).random(2 * n + 16) < share
    start = {"odd_offset": 3, "offset_8": 8}.get(layout, 0)
    mask = torch.from_numpy(full)[::2][:n] if layout == "strided" else torch.from_numpy(full)[start:start + n]
    got = TB.pack_bits(mask)
    assert got.dtype == torch.int32 and got.shape == (TB.num_words(n),)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), TB.pack_bits_np(mask.numpy()))
    np.testing.assert_array_equal(TB.unpack_bits(got, n).numpy(), mask.numpy())


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


# -- the array-layer API of the reference's own tests (tests/test_array.py,
# tests/test_table_misc.py): the same calls on both packages, the port on the
# CPU ------------------------------------------------------------------------


def _packages():
    from arrow_tpu import dtypes as jdt
    from arrow_tpu.utils import scans as jscans
    from arrow_tpu_torch.utils import scans as tscans

    return (at, jdt, jscans, {}), (att, tdt, tscans, {"device": "cpu"})


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _case_padding_and_clone(pkg, dts, scans, dev):
    a = pkg.Float32Array.from_optional_slice([1.0, None, 2.5], **dev)
    c = a.clone()
    buf = pkg.Buffer(a.data)
    assert a.padded_length == int(a.data.shape[0]) and buf.size == a.padded_length * 4
    assert buf.ptr_eq(pkg.Buffer(c.data)) and type(c) is type(a)
    b = pkg.BooleanArray.from_optional_slice([True, None, False], **dev)
    assert b.padded_length == int(b.data.shape[0]) * 32
    return c.values(), c.null_count(), b.clone().values(), _host(a.data)[3:].sum()


def _case_bit_buffer_builder(pkg, dts, scans, dev):
    b = pkg.BitBufferBuilder(10)
    b.set_bit(0), b.set_bit(9)
    before = (b.is_set(0), b.is_set(9), b.is_set(5))
    b.unset_bit(0)
    b.append(True)
    fb = pkg.BitBufferBuilder.from_bools([True, False, True])
    return (before, b.is_set(0), len(b), b.words().tolist(), b.words(3).tolist(),
            b.mask().tolist(), fb.words().tolist())


def _case_record_batch_accessors(pkg, dts, scans, dev):
    rb = pkg.table.RecordBatch.from_numpy({"a": np.int32([1, 2, 3]), "b": np.float32([0.5, 1.5, 2.5])}, **dev)
    return (rb.num_rows, rb.num_columns, rb.column_names, "a" in rb, "z" in rb,
            rb.column("b").values(), [(n, t.value) for n, t in rb.schema],
            rb.with_column("c", rb["a"]).num_columns, rb.select(["b"]).num_columns)


def _case_datatype(pkg, dts, scans, dev):
    names = ["bool_", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
             "float32", "float64", "date32"]
    preds = ["is_boolean", "is_integer_dt", "is_signed_integer", "is_unsigned_integer",
             "is_floating", "is_temporal_dt", "is_primitive"]
    out = []
    for name in names:
        t = getattr(dts, name)()
        out.append((repr(t), t.bit_width, t.byte_width, t.num_fields, t.arrow.value,
                    [getattr(dts, p)(t) for p in preds], t == dts.int32(), t == t.arrow,
                    hash(t) == hash(getattr(dts, name)())))
    arr = pkg.UInt16Array.from_slice([1, 2], **dev)
    assert arr.data_type == dts.uint16() and arr.data_type != dts.int16()
    assert pkg.BooleanArray.from_slice([True], **dev).data_type == dts.bool_()
    return out, repr(arr.data_type)


def _case_boolean_from_words(pkg, dts, scans, dev):
    src = pkg.BooleanArray.from_optional_slice([True, None, False, True, None], **dev)
    b = pkg.BooleanArray.from_words(src.data, 5, src.validity)
    plain = pkg.BooleanArray.from_words(src.data, 4)
    return b.values(), b.null_count(), plain.values(), plain.null_count(), len(plain)


def _case_null_bit_buffer(pkg, dts, scans, dev):
    mask = np.array([True, False, True, True, False, True, True], np.bool_)
    nb = pkg.NullBitBuffer.from_mask_np(mask, 6, 2)
    again = pkg.NullBitBuffer.from_words(nb.words, 6).clone()
    ones = pkg.NullBitBuffer.all_valid_words(40, 3)
    return (nb.to_mask_np().tolist(), again.null_count(), again.is_valid(1), again.is_valid(2),
            _host(nb.words).view(np.uint32).tolist(), _host(ones).view(np.uint32).tolist(),
            int(nb.words.shape[0]))


def _case_scalars(pkg, dts, scans, dev):
    out = []
    for value, dtype in ((3.5, None), (3, None), (True, None), (7, pkg.ArrowType.UINT8),
                         (2**40, pkg.ArrowType.INT64), (1.25, pkg.ArrowType.FLOAT64)):
        s = pkg.array.as_scalar(value, dtype) if dtype else pkg.array.as_scalar(value)
        assert pkg.array.as_scalar(s) is s
        v = s.to_numpy()
        out.append((s.dtype.value, type(v).__name__, v.item()))
    with pytest.raises(TypeError):
        pkg.array.as_scalar(pkg.Int32Array.from_slice([1], **dev))
    return out


def _case_from_device_tensor(pkg, dts, scans, dev):
    """from_jax and its analog in the port, from_torch."""
    out = []
    for cls, host, kw in ((pkg.Int32Array, np.arange(5, dtype=np.int32), {}),
                          (pkg.PrimitiveArray, np.float64([1.5, -2.0, 0.0]), {}),
                          (pkg.PrimitiveArray, np.arange(40, dtype=np.int32), {"length": 33}),
                          (pkg.UInt32Array, np.int32([1, -1]).view(np.uint32), {})):
        if pkg is at:
            import jax.numpy as jnp

            arr = cls.from_jax(jnp.asarray(host), **kw)
        else:
            arr = cls.from_torch(torch.from_numpy(tdt.to_storage_np(host, tdt.from_numpy_dtype(host.dtype))), **kw)
        assert arr.padded_length % 32 == 0 and arr.padded_length >= len(arr)
        assert not _host(arr.data)[len(arr):].any() or "length" in kw
        out.append((type(arr).__name__, arr.dtype.value, arr.values(), arr.null_count()))
    return out


def _case_segment_broadcasts(pkg, dts, scans, dev):
    rng = np.random.default_rng(7)
    vals = rng.integers(-50, 50, 300).astype(np.int32)
    starts = rng.random(300) < 0.1
    starts[0] = True
    ends = np.roll(starts, -1)
    ends[-1] = True
    if pkg is at:
        import jax.numpy as jnp

        put = jnp.asarray
    else:
        put = torch.from_numpy
    return (_host(scans.segment_broadcast_first(put(vals), put(starts))).tolist(),
            _host(scans.segment_broadcast_last(put(vals), put(ends))).tolist())


ARRAY_API_CASES = {f.__name__[6:]: f for f in (
    _case_padding_and_clone, _case_bit_buffer_builder, _case_record_batch_accessors, _case_datatype,
    _case_boolean_from_words, _case_null_bit_buffer, _case_scalars, _case_from_device_tensor,
    _case_segment_broadcasts,
)}


@pytest.mark.parametrize("case", list(ARRAY_API_CASES))
def test_array_api_matches_jax(case):
    (jpkg, jdts, jscans, jdev), (tpkg, tdts, tscans, tdev) = _packages()
    want = ARRAY_API_CASES[case](jpkg, jdts, jscans, jdev)
    got = ARRAY_API_CASES[case](tpkg, tdts, tscans, tdev)
    assert got == want


def test_segment_broadcasts_against_numpy():
    from arrow_tpu_torch.utils import scans as tscans

    vals = torch.tensor([5, 6, 7, 8, 9, 10])
    starts = torch.tensor([1, 0, 0, 1, 0, 1], dtype=torch.bool)
    ends = torch.tensor([0, 0, 1, 0, 1, 1], dtype=torch.bool)
    assert tscans.segment_broadcast_first(vals, starts).tolist() == [5, 5, 5, 8, 8, 10]
    assert tscans.segment_broadcast_last(vals, ends).tolist() == [7, 7, 7, 9, 9, 10]


def test_port_datatype_is_its_own_copy():
    import arrow_tpu.dtypes as jdt

    assert tdt.DataType is not jdt.DataType and att.DataType is tdt.DataType
    assert tdt.DataType.__module__ == "arrow_tpu_torch.dtypes"
    assert tdt.from_torch_dtype(torch.int64) is att.ArrowType.INT64
    with pytest.raises(TypeError):
        tdt.from_torch_dtype(torch.bool)
