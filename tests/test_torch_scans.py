"""utils/scans.py of arrow_tpu_torch against arrow_tpu.utils.scans on the CPU:
stable_partition, segment_ends, compact_rows, prefix_sum, shift_cummax and
sort_limbs; exact."""

import contextlib

import numpy as np
import pytest
import torch

import arrow_tpu_torch as att
from arrow_tpu.utils import scans as JS
from arrow_tpu_torch.compute.kernels import plain_versions
from arrow_tpu_torch.utils import scans as TS

N = 5000


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_stable_partition_and_compact_rows():
    rng = np.random.default_rng(0)
    flags = rng.random(N) < 0.3
    a = rng.integers(-(2**31), 2**31, N).astype(np.int32)
    b = rng.standard_normal(N)
    c = rng.integers(-100, 100, N).astype(np.int8)
    want = [np.asarray(x) for x in JS.stable_partition(_jnp(flags), [_jnp(a), _jnp(b), _jnp(c)])]
    tflags, planes = torch.from_numpy(flags), [torch.from_numpy(x) for x in (a, b, c)]
    for got, w in zip(TS.stable_partition(tflags, planes), want):
        np.testing.assert_array_equal(got.numpy(), w)
    k = int(flags.sum())
    for route in (contextlib.nullcontext, plain_versions):
        with route():
            rows = TS.compact_rows(tflags, planes)
        for got, w, src in zip(rows, want, planes):
            assert got.dtype == src.dtype
            np.testing.assert_array_equal(got.numpy()[:k], w[:k])
            assert not got.numpy()[k:].any()  # the port's compaction zeroes the rest


@pytest.mark.parametrize("n_valid", [0, 1, 1777, N])
def test_segment_ends(n_valid):
    rng = np.random.default_rng(n_valid)
    starts = rng.random(N) < 0.1
    starts[0] = True
    starts[n_valid:] = False
    want = np.asarray(JS.segment_ends(_jnp(starts), n_valid))
    np.testing.assert_array_equal(TS.segment_ends(torch.from_numpy(starts), n_valid).numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_prefix_sum(dtype):
    rng = np.random.default_rng(1)
    v = (rng.integers(-1000, 1000, N) if dtype != np.float64 else rng.integers(-8, 8, N) / 4).astype(dtype)
    want = np.asarray(JS.prefix_sum(_jnp(v)))
    np.testing.assert_array_equal(TS.prefix_sum(torch.from_numpy(v)).numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
def test_shift_cummax(reverse):
    rng = np.random.default_rng(2)
    v = rng.integers(-(2**31), 2**31, N).astype(np.int32)
    want = np.asarray(JS.shift_cummax(_jnp(v), reverse=reverse))
    np.testing.assert_array_equal(TS.shift_cummax(torch.from_numpy(v), reverse=reverse).numpy(), want)


@pytest.mark.parametrize("name", ["uint32", "int32", "int64", "uint64", "uint16"])
def test_sort_limbs_compose_to_the_arrow_order(name):
    rng = np.random.default_rng(3)
    npdt = np.dtype(name)
    info = np.iinfo(npdt)
    keys = rng.integers(info.min, info.max, N, dtype=npdt, endpoint=True)
    keys[1::7] = keys[: keys[1::7].shape[0]]  # ties
    t = att.ArrowType(name)
    stored = torch.from_numpy(keys.view(att.dtypes.storage_numpy(t)))
    limbs = TS.sort_limbs(stored, t)
    assert all(x.dtype == torch.int64 for x in limbs)
    order = np.lexsort([x.numpy() for x in reversed(limbs)])  # first limb most significant
    np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))
