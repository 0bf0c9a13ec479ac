"""arrow_tpu_torch on a CUDA device: each hand-written kernel against its
plain PyTorch version, and the operators and the flagship query on the card
against the same calls on the CPU and a numpy oracle.

Every test needs the card and skips without one.  This file imports no JAX,
so that it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""

import importlib

import numpy as np
import pytest
import torch

import arrow_tpu_torch as att
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch import flagship
from arrow_tpu_torch import io as tio
from arrow_tpu_torch import kernels as TK
from arrow_tpu_torch.compute import join as TJ
from arrow_tpu_torch.compute import kernels as TCK
from arrow_tpu_torch.compute.kernels._build import KERNELS
from arrow_tpu_torch.compute.kernels import compaction3 as C3
from arrow_tpu_torch.compute.kernels import merge as M
from arrow_tpu_torch.compute.kernels import plain_versions
from arrow_tpu_torch.compute.kernels import radix as R
from arrow_tpu_torch.compute.kernels import segscan as S
from arrow_tpu_torch.utils import bits as TB
from arrow_tpu_torch.utils import scans as TS

TSORT = importlib.import_module("arrow_tpu_torch.compute.sort")  # the module, not compute.sort()

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


# ---------------------------------------------------------------- kernels B3/B4


def _radix_planes(rng, n, key_bits, domain, payloads):
    """A key plane of unsigned-order codes below `domain` (high bits set at
    random above 2^31 for the 2^32 domain) and payload planes of 4 and 8
    bytes."""
    k = rng.integers(0, domain, n, dtype=np.uint64)
    if key_bits == 64:
        k = (k << np.uint64(32)) | rng.integers(0, 4, n, dtype=np.uint64)
        key = torch.from_numpy(k.view(np.int64))
    else:
        key = torch.from_numpy(k.astype(np.uint32).view(np.int32))
    pays = [
        torch.from_numpy(np.arange(n, dtype=np.int32)),
        torch.from_numpy(rng.standard_normal(n)),
        torch.from_numpy(rng.integers(-(2**62), 2**62, n)),
        torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
    ][:payloads]
    return [key, *pays]


@pytest.mark.parametrize("digit_bits", [1, 2, 8])
@pytest.mark.parametrize("n", [0, 1, 31, 8193, (1 << 20) + 17])
@pytest.mark.parametrize("key_bits,domain,payloads", [
    (32, 2, 1), (32, 10_000, 2), (32, 2**32, 4), (64, 2**32, 3), (64, 3, 1),
])
def test_radix_sort_kernel_matches_plain(cuda, digit_bits, n, key_bits, domain, payloads):
    rng = np.random.default_rng(n + digit_bits)
    planes = _radix_planes(rng, n, key_bits, domain, payloads)
    counter = R.KERNEL_2BIT if digit_bits == 2 else R.KERNEL
    before = counter.launches
    got = R.radix_sort([p.to(cuda) for p in planes], key_bits, n, digit_bits)
    torch.cuda.synchronize()
    assert counter.launches == before + (1 if n > 1 else 0)
    want = R.radix_sort_plain(planes, key_bits, n, digit_bits)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    order = np.argsort(planes[0].numpy().view(np.uint64 if key_bits == 64 else np.uint32), kind="stable")
    np.testing.assert_array_equal(want[0].numpy(), planes[0].numpy()[order])


def test_radix_sort_kernel_prefix_and_bits(cuda):
    rng = np.random.default_rng(7)
    n = 70001
    key = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32))
    pay = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32))
    for bits in ([0, 5, 31], [30, 31], []):
        for digit_bits in (1, 2, 8):
            got = R.radix_sort([key.to(cuda), pay.to(cuda)], bits, n - 100, digit_bits)
            want = R.radix_sort_plain([key, pay], bits, n - 100, digit_bits)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
            assert not got[0][n - 100 :].any()


# ---------------------------------------------------------------- kernel B7


def _runs(rng, n, run_len, unique):
    """int32 planes holding sorted runs: heavy duplicates, the int32 extremes
    and the sentinel; row ids as the unique payload."""
    keys = rng.choice(np.array([-(2**31), -1, 0, 3, 2**31 - 2, 2**31 - 1], np.int32), n)
    rows = np.arange(n, dtype=np.int32)
    for lo in range(0, n, run_len):
        o = np.argsort(keys[lo : lo + run_len], kind="stable")
        keys[lo : lo + run_len] = keys[lo : lo + run_len][o]
        rows[lo : lo + run_len] = rows[lo : lo + run_len][o]
    extra = [rng.integers(-(2**31), 2**31, n).astype(np.int32) for _ in range(2)]
    return [torch.from_numpy(p) for p in (keys, rows, *([] if unique else extra))]


@pytest.mark.parametrize("n", [1, 7, 8193, 3 * 8192 + 5, (1 << 20) + 17])
@pytest.mark.parametrize("run_len", [1, 7, 2048, 8192, "half"])
@pytest.mark.parametrize("unique", [False, True])
def test_merge_pass_kernel_matches_plain(cuda, n, run_len, unique):
    run_len = max(1, n // 2) if run_len == "half" else run_len
    rng = np.random.default_rng(n + run_len)
    planes = _runs(rng, n, run_len, unique)
    before = M.KERNEL.launches
    got = M.merge_pass([p.to(cuda) for p in planes], run_len, unique)
    torch.cuda.synchronize()
    assert M.KERNEL.launches == before + 1
    want = M.merge_pass_plain(planes, run_len, unique)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


def test_sort_kv_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(9)
    n = 5 * 8192 + 123
    keys = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
    rows = torch.arange(n, dtype=torch.int32)
    for unique in (False, True):
        gk, (gr,) = TCK.sort_kv(keys.to(cuda), (rows.to(cuda),), n - 1000, unique)
        wk, (wr,) = TCK.sort_kv(keys, (rows,), n - 1000, unique)
        assert torch.equal(gk.cpu(), wk) and torch.equal(gr.cpu(), wr)


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


# ------------------------------------------------------- sort, join, take

_SORT_POOLS = {
    "int32": np.array([-(2**31), -7, 0, 3, 2**31 - 1], np.int32),
    "uint32": np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    "int64": np.array([-(2**63), -1, 0, 2**40, 2**63 - 1], np.int64),
    "uint64": np.array([0, 2**63 - 1, 2**63, 2**64 - 1], np.uint64),
    "float32": np.array([-np.inf, -2.5, -0.0, 0.0, 1.5, np.inf, np.nan, -np.nan], np.float32),
    "float64": np.array([-np.inf, -0.0, 0.0, 2.0, np.nan], np.float64),
}


def _sort_col(rng, name, n, null_p, device):
    vals = _SORT_POOLS[name][rng.integers(0, _SORT_POOLS[name].shape[0], n)]
    if not null_p:
        return att.PrimitiveArray.from_slice(vals, dtype=att.ArrowType(name), device=device)
    valid = rng.random(n) >= null_p
    return att.PrimitiveArray.from_optional_slice(
        [v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=att.ArrowType(name), device=device
    )


@pytest.mark.parametrize("name", list(_SORT_POOLS))
@pytest.mark.parametrize("null_p", [0.0, 0.2])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_routes_on_cuda_match_cpu(cuda, name, null_p, descending):
    """Every route on the card gives the CPU's xla-route result, bit for bit
    (float keys: +-0 tie, every NaN last, on torch.sort's CUDA route too)."""
    rng = np.random.default_rng(17)
    col = _sort_col(rng, name, 70001, null_p, "cpu")
    payload = _sort_col(rng, "float64", 70001, 0.3, "cpu")
    want = TC.sort(col, descending, method="xla")
    wk, wp = TC.sort_by_key(col, payload, descending, method="xla")
    gcol, gpay = _to(col, cuda), _to(payload, cuda)
    routes = ["xla", "auto"]
    if name not in ("float64",) and not null_p:
        routes.append("radix")
    if name in ("int32", "uint32", "float32") and not null_p and not descending:
        routes.append("merge")
    for method in routes:
        before = R.KERNEL.launches, M.KERNEL.launches
        got = TC.sort(gcol, descending, method=method)
        gk, gp = TC.sort_by_key(gcol, gpay, descending, method=method)
        assert got.data.is_cuda and gk.data.is_cuda
        if method == "radix":
            assert R.KERNEL.launches == before[0] + 2
        if method == "merge":
            assert M.KERNEL.launches > before[1]
        _same(want, got)
        _same(wk, gk)
        _same(wp, gp)
    _same(TC.argsort(col, descending), TC.argsort(gcol, descending))


def test_radix_route_two_bit_on_cuda(cuda, monkeypatch):
    monkeypatch.setenv("ARROW_TPU_RADIX_R", "4")
    rng = np.random.default_rng(19)
    keys = att.UInt32Array.from_slice(rng.integers(0, 10_000, 100_003).astype(np.uint32), device="cpu")
    vals = att.Float32Array.from_slice(rng.standard_normal(100_003).astype(np.float32), device="cpu")
    before = R.KERNEL_2BIT.launches
    gk, gv = TC.sort_by_key(_to(keys, cuda), _to(vals, cuda), method="radix")
    assert R.KERNEL_2BIT.launches == before + 1
    wk, wv = TC.sort_by_key(keys, vals, method="xla")
    _same(wk, gk)
    _same(wv, gv)


def _pair_set(pi, bi):
    return sorted(zip(pi.raw_values().tolist(), bi.raw_values().tolist()))


@pytest.mark.parametrize("name,domain,null_p", [("uint32", 5000, 0.0), ("uint32", 300, 0.2), ("int64", 1000, 0.1)])
def test_join_on_cuda_matches_cpu(cuda, name, domain, null_p, monkeypatch):
    """The merge-expand emit on the card (co-sort on kernel B3 for u32 keys,
    with its gate opened at this size) against the CPU's legacy emit."""
    monkeypatch.setattr(TJ, "RADIX_COSORT_ROWS", 0)
    rng = np.random.default_rng(23)
    dt_ = np.dtype(name)
    build = att.PrimitiveArray.from_optional_slice(
        [int(v) if ok else None for v, ok in zip(rng.integers(0, domain, 20_000).astype(dt_), rng.random(20_000) >= null_p)],
        dtype=att.ArrowType(name), device="cpu",
    )
    probe = att.PrimitiveArray.from_slice(rng.integers(0, domain, 50_001).astype(dt_), dtype=att.ArrowType(name), device="cpu")
    want = TC.join_indices(build, probe)
    before = R.KERNEL.launches, M.KERNEL.launches, C3.KERNEL.launches, S.KERNEL.launches
    got = TC.join_indices(_to(build, cuda), _to(probe, cuda))
    after = R.KERNEL.launches, M.KERNEL.launches, C3.KERNEL.launches, S.KERNEL.launches
    assert got[0].data.is_cuda and got[2] == want[2] > 0
    assert after[1] == before[1] + 2 and after[2] > before[2] and after[3] > before[3]
    assert after[0] == before[0] + (name == "uint32")
    assert _pair_set(got[0], got[1]) == _pair_set(want[0], want[1])


def test_take_on_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(29)
    col = att.UInt32Array.from_optional_slice(
        [int(v) if ok else None for v, ok in zip(rng.integers(0, 2**32, 5000, dtype=np.uint32), rng.random(5000) < 0.8)],
        device="cpu",
    )
    flags = att.BooleanArray.from_slice(rng.random(5000) < 0.5, device="cpu")
    idx = att.UInt32Array.from_slice(rng.integers(0, 5000, 7001).astype(np.uint32), device="cpu")
    for c in (col, flags):
        _same(TK.take(c, idx), TK.take(_to(c, cuda), _to(idx, cuda)))


def test_sort_join_query_on_cuda(cuda):
    """The sort-join query on the card: kernels B1, B2, B3 (its gates
    opened at this size) and B7 all launch; the result equals the plain
    path's and a numpy oracle's."""
    n = 1 << 18
    cols = flagship.make_host_columns(n, seed=2)
    batch = flagship.make_batch(n, seed=2, device=cuda)
    saved = TJ.RADIX_COSORT_ROWS, TSORT.RADIX_AUTO_ROWS
    TJ.RADIX_COSORT_ROWS = TSORT.RADIX_AUTO_ROWS = 0
    try:
        before = {k: v.launches for k, v in KERNELS.items()}
        kept, groups, joined, (sk, sv) = flagship.sort_join_query(batch)
        after = {k: v.launches for k, v in KERNELS.items()}
        with plain_versions():
            pk, pg, pj, (psk, psv) = flagship.sort_join_query(batch)
    finally:
        TJ.RADIX_COSORT_ROWS, TSORT.RADIX_AUTO_ROWS = saved
    for name in ("compact_multi", "segmented_scan", "radix_sort", "merge_pass"):
        assert after[name] > before[name], name
    keep = cols["v"] > 0
    order = np.argsort(cols["k"][keep], kind="stable")
    np.testing.assert_array_equal(sk.raw_values(), cols["k"][keep][order])
    np.testing.assert_array_equal(sv.raw_values(), cols["v"][keep][order])
    _same(psk, sk)
    _same(psv, sv)
    assert joined.num_rows == pj.num_rows == int(keep.sum())
    np.testing.assert_array_equal(joined["k"].raw_values(), joined["key"].raw_values())
    for j in (joined, pj):
        packed = np.sort((j["k"].raw_values().astype(np.uint64) << np.uint64(32)) | j["v"].raw_values().view(np.uint32))
        want = np.sort((cols["k"][keep].astype(np.uint64) << np.uint64(32)) | cols["v"][keep].view(np.uint32))
        np.testing.assert_array_equal(packed, want)
