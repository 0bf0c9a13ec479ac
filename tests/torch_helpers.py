"""Shared helpers of the differential tests that hold arrow_tpu_torch against
arrow_tpu.  Inputs are made with numpy and handed to both packages; state
crosses from the JAX package to the port only through ``io`` buffers, and
results are compared on their logical prefixes plus the zero tails the
operators promise."""

from __future__ import annotations

import numpy as np

import arrow_tpu_torch as att
from arrow_tpu import io as jio
from arrow_tpu_torch import io as tio


def jax_to_torch(arr, device="cpu"):
    """A JAX-package array -> the port's array, through Arrow buffers."""
    b = jio.to_arrow_buffers(arr)
    return tio.from_arrow_buffers(
        b["data"], b["length"], b["validity"], att.ArrowType(arr.dtype.value), device
    )


def batch_to_torch(batch, device="cpu"):
    bufs = {}
    for name, col in batch.columns().items():
        bufs[name] = {**jio.to_arrow_buffers(col), "dtype": col.dtype.value}
    return att.RecordBatch.from_arrow_buffers(bufs, device=device)


def assert_zero_tail(arr):
    """Rows at and past the logical length are zero in every buffer."""
    n = arr.length
    data = arr.data.cpu().numpy()
    if arr.dtype is att.ArrowType.BOOL:
        bits = np.unpackbits(data.view(np.uint8), bitorder="little")
        assert not bits[n:].any(), "bool data bits past the length"
    else:
        assert not data[n:].any(), "values past the length"
    if arr.validity is not None:
        bits = np.unpackbits(arr.validity.cpu().numpy().view(np.uint8), bitorder="little")
        assert not bits[n:].any(), "validity bits past the length"


def assert_same(jarr, tarr, rtol=None):
    """Equal Arrow buffers: length, null count, validity bytes, and the value
    bytes (floats within `rtol` when given, NaN matching NaN)."""
    je, te = jio.to_arrow_buffers(jarr), tio.to_arrow_buffers(tarr)
    assert jarr.dtype.value == tarr.dtype.value
    assert je["length"] == te["length"]
    assert je["null_count"] == te["null_count"]
    assert (je["validity"] is None) == (te["validity"] is None)
    if je["validity"] is not None:
        np.testing.assert_array_equal(je["validity"], te["validity"])
    jd, td = je["data"], te["data"]
    assert jd.dtype == td.dtype, (jd.dtype, td.dtype)
    if rtol is not None and jd.dtype.kind == "f":
        np.testing.assert_allclose(td, jd, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(td.view(np.uint8), jd.view(np.uint8))
    assert_zero_tail(tarr)


__all__ = ["assert_same", "assert_zero_tail", "batch_to_torch", "jax_to_torch"]
