"""Kernel B6 (COUNT and exact SUM over class-grouped keys) and the port's
partition route of hash_aggregate, against arrow_tpu's
hash_aggregate(method="partition"), whose region kernel runs interpreted
here as ``tests/test_groupby_mxu.py`` runs it: 20000 rows in a padded
buffer, and the skewed case.  Compared through ``io`` buffers: values, the
num_groups prefix, the zero tail; means at rtol 1e-12; integers exact.  The
plain B6 is also held against numpy on rows in no class order (the kernel's
flushes add, so it is right for any order).  The CUDA kernel is held against
the plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import compute as JC
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch.compute.kernels import plain_versions
from arrow_tpu_torch.compute.kernels.groupby_region import (
    groupby_region,
    groupby_region_cuda,
    groupby_region_plain,
)
from torch_helpers import assert_same, jax_to_torch


def _check(want, got):
    assert want.column_names == got.column_names
    assert want.num_rows == got.num_rows
    for name in want.column_names:
        assert_same(want[name], got[name], rtol=1e-12)


def _run_both(jk, jv, aggs, **kw):
    want = JC.hash_aggregate(jk, [(n, jv if v else None, a) for n, v, a in aggs], method="partition", **kw)
    tk, tv = jax_to_torch(jk), jax_to_torch(jv)
    taggs = [(n, tv if v else None, a) for n, v, a in aggs]
    got = TC.hash_aggregate(tk, taggs, method="partition", **kw)
    _check(want, got)
    with plain_versions():
        _check(want, TC.hash_aggregate(tk, taggs, method="partition", **kw))
    # the same groups on the sort route
    _check(want, TC.hash_aggregate(tk, taggs, method="sort"))
    return got


def test_partition_route_matches_jax_padded():
    """20000 rows in a padded buffer (the JAX package's garbage class)."""
    rng = np.random.default_rng(7)
    n = 20000
    jk = at.UInt32Array.from_slice(rng.integers(0, 50000, n).astype(np.uint32))
    jv = at.Int32Array.from_slice(rng.integers(0, 250, n).astype(np.int32))
    got = _run_both(jk, jv, [("s", True, "sum"), ("c", None, "count"), ("m", True, "mean")])
    assert got["key"].data.shape[0] == 1 << 16  # the domain's 2^16 slots, zero past the groups


def test_partition_route_matches_jax_skewed():
    """Most rows on 3 keys of class 0, the rest sprayed over 2^18, with the
    key_domain / value_bits guarantee."""
    rng = np.random.default_rng(8)
    n = 16384
    hot = rng.choice([5, 77, 4000], int(n * 0.8))
    cold = rng.integers(0, 1 << 18, n - hot.shape[0])
    keys = np.concatenate([hot, cold]).astype(np.uint32)
    rng.shuffle(keys)
    jk = at.UInt32Array.from_slice(keys)
    jv = at.Int32Array.from_slice(rng.integers(0, 200, n).astype(np.int32))
    _run_both(jk, jv, [("s", True, "sum"), ("c", None, "count")], key_domain=(0, 1 << 18), value_bits=8)


def test_partition_route_u32_values_high_and_count_only():
    rng = np.random.default_rng(9)
    n = 8192
    jk = at.UInt32Array.from_slice(rng.integers(4000, 9000, n).astype(np.uint32))
    jv = at.UInt32Array.from_slice(rng.integers(2**31, 2**32, n, dtype=np.uint64).astype(np.uint32))
    _run_both(jk, jv, [("s", True, "sum"), ("m", True, "mean")])
    _run_both(jk, jv, [("n", None, "count")])


@pytest.mark.parametrize("order", ["grouped", "unsorted"])
def test_plain_region_matches_numpy_in_any_order(order):
    rng = np.random.default_rng(11)
    nclass = 4
    keys = rng.integers(0, nclass * 4096, 30_001).astype(np.int32)
    if order == "grouped":
        keys = keys[np.argsort(keys >> 12, kind="stable")]
    vals = rng.integers(0, 2**32, keys.shape[0], dtype=np.uint64).astype(np.uint32)
    count, total = groupby_region(torch.from_numpy(keys), torch.from_numpy(vals.view(np.int32)), 4, nclass)
    assert count.dtype == torch.int32 and total.dtype == torch.int64
    np.testing.assert_array_equal(count.numpy(), np.bincount(keys, minlength=nclass * 4096))
    exp = np.zeros(nclass * 4096, np.int64)
    np.add.at(exp, keys, vals.astype(np.int64))
    np.testing.assert_array_equal(total.numpy(), exp)
    _, cut = groupby_region_plain(torch.from_numpy(keys), torch.from_numpy(vals.view(np.int32)), 2, nclass)
    exp2 = np.zeros(nclass * 4096, np.int64)
    np.add.at(exp2, keys, (vals & 0xFFFF).astype(np.int64))
    np.testing.assert_array_equal(cut.numpy(), exp2)


def test_region_wrapper_checks():
    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        groupby_region_cuda(keys, keys, 1, 1)
    with pytest.raises(ValueError):
        groupby_region(keys, keys, 1, 1025)
    with pytest.raises(ValueError):
        groupby_region(keys.to(torch.int64), keys, 1, 1)
