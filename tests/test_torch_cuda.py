"""arrow_tpu_torch on a CUDA device: each hand-written kernel against its
plain PyTorch version, and the operators and the flagship query on the card
against the same calls on the CPU and a numpy oracle.

Every test needs the card and skips without one.  This file imports no JAX,
so that it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

import arrow_tpu_torch as att
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch import flagship
from arrow_tpu_torch import io as tio
from arrow_tpu_torch import kernels as TK
from arrow_tpu_torch.compute.kernels import compaction3 as C3
from arrow_tpu_torch.compute.kernels import plain_versions
from arrow_tpu_torch.compute.kernels import segscan as S
from arrow_tpu_torch.utils import bits as TB
from arrow_tpu_torch.utils import scans as TS

pytestmark = pytest.mark.gpu
# float adds differ from the plain ladder in summation order only; an f64
# sum accumulated in f32 would miss the f64 tolerance by orders of magnitude
ADD_RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided per test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(arr, device):
    """A port array moved to `device` through Arrow buffers."""
    b = tio.to_arrow_buffers(arr)
    return tio.from_arrow_buffers(b["data"], b["length"], b["validity"], arr.dtype, device)


def _same(a, b, rtol=None):
    ea, eb = tio.to_arrow_buffers(a), tio.to_arrow_buffers(b)
    assert ea["length"] == eb["length"] and ea["null_count"] == eb["null_count"]
    assert (ea["validity"] is None) == (eb["validity"] is None)
    if ea["validity"] is not None:
        np.testing.assert_array_equal(ea["validity"], eb["validity"])
    if rtol is not None and ea["data"].dtype.kind == "f":
        np.testing.assert_allclose(ea["data"], eb["data"], rtol=rtol)
    else:
        np.testing.assert_array_equal(ea["data"], eb["data"])


# ---------------------------------------------------------------- kernel B1


@pytest.mark.parametrize("n", [0, 1, 31, 8193, (1 << 20) + 17])
@pytest.mark.parametrize("pattern", ["none", "0.01", "0.5", "0.99", "all", "every32"])
def test_compact_multi_kernel_matches_plain(cuda, n, pattern):
    rng = np.random.default_rng(n)
    rows = np.arange(n)
    flags = {"none": np.zeros(n, bool), "all": np.ones(n, bool), "every32": rows % 32 == 0}.get(pattern)
    if flags is None:
        flags = rng.random(n) < float(pattern)
    planes = [
        torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32)).to(cuda),
        torch.from_numpy(rng.standard_normal(n)).to(cuda),
    ]
    words = [torch.from_numpy(TB.pack_bits_np(rng.random(n) < 0.5).view(np.int32)).to(cuda)]
    mask = torch.from_numpy(TB.pack_bits_np(flags).view(np.int32)).to(cuda)
    before = C3.KERNEL.launches
    kv, kw, kc = C3.compact_multi(planes, words, mask, n)
    torch.cuda.synchronize()
    assert C3.KERNEL.launches == before + 1
    pv, pw, pc = C3.compact_multi_plain(planes, words, mask, n)
    assert int(kc) == int(pc) == int(flags.sum())
    for k, p in zip(kv + kw, pv + pw):
        assert k.is_cuda and torch.equal(k, p)


def test_compact_multi_rejects_what_it_does_not_take(cuda):
    mask = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # 2-byte plane
        C3.compact_multi([torch.zeros(32, dtype=torch.int16, device=cuda)], [], mask)
    with pytest.raises(ValueError):  # plane on another device
        C3.compact_multi([torch.zeros(32, dtype=torch.int32)], [], mask)
    with pytest.raises(ValueError):  # too short
        C3.compact_multi([torch.zeros(16, dtype=torch.int32, device=cuda)], [], mask, 32)
    with pytest.raises(ValueError):  # too many planes
        C3.compact_multi([torch.zeros(32, dtype=torch.int32, device=cuda)] * 17, [], mask)


# ---------------------------------------------------------------- kernel B2


def _scan_values(rng, name, n):
    if name.startswith("float"):
        return torch.from_numpy(rng.random(n).astype(name) + 0.5), False
    info = np.iinfo(np.dtype(name))
    v = rng.integers(info.min, info.max, n, dtype=np.dtype(name), endpoint=True)
    if name.startswith("u"):
        return torch.from_numpy(v.view(np.int32 if v.itemsize == 4 else np.int64)), True
    return torch.from_numpy(v), False


@pytest.mark.parametrize("n", [1, 8193, (1 << 16) + 17])
@pytest.mark.parametrize("flags", ["none", "sparse", "dense"])
@pytest.mark.parametrize("name", ["int32", "uint32", "float32", "int64", "uint64", "float64"])
def test_segmented_scan_kernel_matches_plain(cuda, n, flags, name):
    rng = np.random.default_rng(n)
    tv, unsigned = _scan_values(rng, name, n)
    tv = tv.to(cuda)
    density = {"none": 0.0, "sparse": 0.001, "dense": 0.3}[flags]
    tf = torch.from_numpy(rng.random(n) < density).to(cuda) if density else None
    for op in S.OPS:
        before = S.KERNEL.launches
        got = S.segmented_scan(tv, tf, op, unsigned)
        torch.cuda.synchronize()
        assert S.KERNEL.launches == before + 1 and got.is_cuda
        want = S.segmented_scan_plain(tv, tf, op, unsigned)
        if tv.is_floating_point() and op == "add":
            torch.testing.assert_close(got, want, rtol=ADD_RTOL[tv.dtype], atol=0)
        else:
            assert torch.equal(got, want)


def test_segmented_scan_nan_and_unsigned_extremes(cuda):
    v = torch.tensor([1.0, float("nan"), 3.0, -1.0, 2.0], device=cuda)
    f = torch.tensor([False, False, False, True, False], device=cuda)
    for op in ("max", "min"):
        got, want = S.segmented_scan(v, f, op), S.segmented_scan_plain(v, f, op)
        torch.testing.assert_close(got, want, equal_nan=True, rtol=0, atol=0)
    u = torch.tensor([5, -1, 7, -(2**31)], dtype=torch.int32, device=cuda)  # 5, 2^32-1, 7, 2^31
    assert S.segmented_scan(u, None, "max", unsigned=True).tolist() == [5, -1, -1, -1]
    assert S.segmented_scan(u, None, "min", unsigned=True).tolist() == [5, 5, 5, 5]


def test_scans_on_cuda_match_cpu(cuda):
    rng = np.random.default_rng(11)
    v = torch.from_numpy(rng.integers(-(2**31), 2**31, 100003).astype(np.int32))
    flags = torch.from_numpy(rng.random(100003) < 0.3)
    gv, gf = v.to(cuda), flags.to(cuda)
    assert torch.equal(TS.prefix_sum(gv).cpu(), TS.prefix_sum(v))
    for reverse in (False, True):
        assert torch.equal(TS.shift_cummax(gv, reverse).cpu(), TS.shift_cummax(v, reverse))
    wide = v.to(torch.int64) * 3
    for got, want in zip(TS.compact_rows(gf, [gv, wide.to(cuda)]), TS.compact_rows(flags, [v, wide])):
        assert got.is_cuda and torch.equal(got.cpu(), want)


# ---------------------------------------------------------------- operators


def _batch(rng, n, device):
    valid = rng.random(n) < 0.8
    cols = {
        "u32": att.UInt32Array.from_optional_slice(
            [int(x) if ok else None for x, ok in zip(rng.integers(0, 2**32, n, dtype=np.uint32), valid)],
            device=device,
        ),
        "f32": att.Float32Array.from_slice(rng.standard_normal(n).astype(np.float32), device=device),
        "i64": att.Int64Array.from_slice(rng.integers(-(2**62), 2**62, n), device=device),
        "f64": att.Float64Array.from_slice(rng.standard_normal(n), device=device),
        "i16": att.Int16Array.from_slice(rng.integers(-100, 100, n).astype(np.int16), device=device),
        "b": att.BooleanArray.from_slice(rng.random(n) < 0.5, device=device),
    }
    return att.RecordBatch(cols)


def test_filter_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    n = 70001
    cpu_batch = _batch(rng, n, "cpu")
    cpu_mask = att.BooleanArray.from_optional_slice(
        [bool(x) if ok else None for x, ok in zip(rng.random(n) < 0.5, rng.random(n) < 0.9)],
        device="cpu",
    )
    gpu_batch = att.RecordBatch({k: _to(c, cuda) for k, c in cpu_batch.columns().items()})
    gpu_mask = _to(cpu_mask, cuda)
    want = TC.filter(cpu_batch, cpu_mask)
    before = C3.KERNEL.launches
    got = TC.filter(gpu_batch, gpu_mask)
    assert C3.KERNEL.launches == before + 1  # 7 planes share one launch
    for name in want.column_names:
        assert got[name].data.is_cuda
        _same(want[name], got[name])
    assert TC.filter_count(gpu_mask) == want.num_rows
    (gi, gk), (wi, wk) = TC.filter_indices(gpu_mask), TC.filter_indices(cpu_mask)
    assert gk == wk
    _same(wi, gi)


@pytest.mark.parametrize("vname", ["int32", "uint32", "int64", "float32", "float64"])
def test_hash_aggregate_on_cuda_matches_cpu(cuda, vname):
    rng = np.random.default_rng(3)
    n = 50000
    keys = rng.integers(0, 3000, n).astype(np.uint32) + np.uint32(2**31)
    kvalid = rng.random(n) < 0.9
    vals = rng.integers(0, 2**31, n).astype(vname) if "int" in vname else rng.standard_normal(n).astype(vname)
    vvalid = rng.random(n) < 0.8
    k = att.UInt32Array.from_optional_slice([int(x) if ok else None for x, ok in zip(keys, kvalid)], device="cpu")
    v = att.PrimitiveArray.from_optional_slice(
        [x if ok else None for x, ok in zip(vals.tolist(), vvalid)], dtype=att.ArrowType(vname), device="cpu"
    )
    aggs = ["sum", "count", "min", "max", "mean"]
    want = TC.hash_aggregate(k, [(a, v, a) for a in aggs] + [("rows", None, "count")])
    gk, gv = _to(k, cuda), _to(v, cuda)
    b1, b2 = C3.KERNEL.launches, S.KERNEL.launches
    got = TC.hash_aggregate(gk, [(a, gv, a) for a in aggs] + [("rows", None, "count")])
    assert C3.KERNEL.launches > b1 and S.KERNEL.launches > b2
    for name in want.column_names:
        assert got[name].data.is_cuda
        _same(want[name], got[name], rtol=1e-6 if name == "sum" else 1e-12)


def test_compare_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 2**32, 4097, dtype=np.uint32)
    a = att.UInt32Array.from_slice(vals, device="cpu")
    got = TK.gt_scalar(_to(a, cuda), 2**31 + 5)
    assert got.data.is_cuda
    _same(TK.gt_scalar(a, 2**31 + 5), got)
    np.testing.assert_array_equal(got.raw_values(), vals > 2**31 + 5)


def test_flagship_on_cuda(cuda):
    n = 1 << 18
    cols = flagship.make_host_columns(n, seed=1)
    count, keys, counts, sums = flagship.numpy_reference(cols["k"], cols["v"])
    batch = flagship.make_batch(n, seed=1, device=cuda)
    before = C3.KERNEL.launches, S.KERNEL.launches
    with plain_versions():
        plain_rows, plain = flagship.flagship_query(batch)
    assert (C3.KERNEL.launches, S.KERNEL.launches) == before  # the plain versions launch nothing
    rows, got = flagship.flagship_query(batch)
    assert C3.KERNEL.launches > before[0] and S.KERNEL.launches > before[1]
    assert rows == count == plain_rows and got["key"].data.is_cuda and plain["key"].data.is_cuda
    for name in ("key", "n"):
        _same(plain[name], got[name])
    _same(plain["total"], got["total"], rtol=1e-6)
    np.testing.assert_array_equal(got["key"].raw_values(), keys)
    np.testing.assert_array_equal(got["n"].raw_values(), counts)
    np.testing.assert_allclose(got["total"].raw_values(), sums, rtol=1e-5)
