"""Kernel B5 (COUNT and exact SUM by dense keys in [0, 4096)): the plain
PyTorch version against arrow_tpu's groupby_dense_pallas, which runs
interpreted here as ``tests/test_groupby_mxu.py`` runs it (16384 rows), and
the port's mxu route of hash_aggregate against arrow_tpu's hash_aggregate
through ``io`` buffers: values, the num_groups prefix, the zero tail; means
at rtol 1e-12.  Integers exact.  The CUDA kernel is held against the plain
version in test_torch_cuda.py."""

import ctypes
import functools
import pathlib
import re
import shutil
import subprocess

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
    count, total = GM.groupby_dense(keys, keys.to(torch.int64) << 40, 8)  # 64-bit values
    assert total[:3].tolist() == [0, 1 << 40, 4 << 40]
    for vals, nlimb in ((keys, 5), (keys.to(torch.int64), 9), (keys.to(torch.int16), 1),
                        (keys.to(torch.float32), 4), (keys.to(torch.float64), 8)):
        with pytest.raises(ValueError):
            GM.groupby_dense(keys, vals, nlimb)


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
    # int64 values whose rows x largest value reach 2^63 (the mxu route's exact-sum bound)
    jv = (at.Int64Array.from_slice((vals + 2**50).astype(np.int64)) if case == "int64_values"
          else at.Int32Array.from_slice(vals.astype(np.int32)))
    kind = "max" if case == "min_max" else "sum"
    _run_both(jk, [jv], [("s", 0, kind), ("c", None, "count")], "auto")


@pytest.mark.parametrize("method", ["mxu", "partition", "radix"])
def test_ineligible_inputs_raise_under_an_explicit_method(method):
    """As arrow_tpu raises for them (tests/test_groupby_mxu.py:44): keys past
    each route's domain, negative values, nulls; the radix route, which runs
    on any device, for a null key, a padded buffer and a 16-bit key."""
    rng = np.random.default_rng(7)
    wide = att.UInt32Array.from_slice(rng.integers(0, 2**30, 8192).astype(np.uint32), device="cpu")
    small = att.UInt32Array.from_slice(rng.integers(0, 64, 8192).astype(np.uint32), device="cpu")
    neg = att.Int32Array.from_slice(rng.integers(-100, 100, 8192).astype(np.int32), device="cpu")
    nulls = att.UInt32Array.from_optional_slice([1, None, 3], device="cpu")
    null_key = att.UInt32Array.from_optional_slice([None] + list(range(1, 8192)), device="cpu")
    padded = att.UInt32Array.from_slice(rng.integers(0, 64, 8190).astype(np.uint32), device="cpu")
    short = att.PrimitiveArray.from_slice(rng.integers(0, 64, 8192).astype(np.uint16), dtype=att.ArrowType.UINT16,
                                          device="cpu")
    cases = {"mxu": [(wide, None), (small, neg), (nulls, None)],
             "partition": [(wide, None), (small, None), (small, neg)],
             "radix": [(null_key, None), (padded, None), (short, None)]}[method]
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


# -- 64-bit values (the mxu route keeps them 64-bit) --


def _numpy_table(keys, vals, nlimb):
    """(count, sum) over [0, 4096) by numpy: values read as unsigned 64-bit,
    cut to 8 x nlimb bits, summed modulo 2^64."""
    k = keys.astype(np.int64)
    ok = (k >= 0) & (k < GM.SLOTS)
    v = vals.astype(np.int64).view(np.uint64)
    if nlimb < 8:
        v = v & np.uint64((1 << (8 * nlimb)) - 1)
    count = np.bincount(k[ok], minlength=GM.SLOTS).astype(np.int32)
    total = np.zeros(GM.SLOTS, np.uint64)
    np.add.at(total, k[ok], v[ok])
    return count, total.view(np.int64)


@pytest.mark.parametrize("nlimb", [1, 5, 8])
@pytest.mark.parametrize("n", [0, 1, 4099, 12_347])
def test_plain_64_bit_values_match_numpy(nlimb, n):
    """int64 values with bits above 32 and at the top, keys outside the
    table among them, lengths not a multiple of 2 or 4."""
    rng = np.random.default_rng([nlimb, n])
    keys = rng.integers(-3, 4100, n).astype(np.int32)
    vals = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    count, total = GM.groupby_dense(torch.from_numpy(keys), torch.from_numpy(vals), nlimb)
    want_count, want_total = _numpy_table(keys, vals, nlimb)
    np.testing.assert_array_equal(count.numpy(), want_count)
    np.testing.assert_array_equal(total.numpy(), want_total)
    if n > 9:  # `length` below the rows
        count, total = GM.groupby_dense(torch.from_numpy(keys), torch.from_numpy(vals), nlimb, n - 9)
        np.testing.assert_array_equal(total.numpy(), _numpy_table(keys[: n - 9], vals[: n - 9], nlimb)[1])


HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE.parent / "arrow_tpu_torch" / "csrc" / "groupby_mxu.cu"
LAUNCH = re.compile(r"(dense_histogram<[\w, ]+>)<<<(\w+), (\w+), \w+, \w+>>>\(([^;]*)\);")
SHARED = "extern __shared__ unsigned smem[];"


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/groupby_mxu.cu built for the host with g++, each block's threads
    run together by the shim (tests/cuda_host_shim.h); its C entry declared
    as the wrapper declares the card's."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("groupby_mxu_host")
    shutil.copy(HERE / "cuda_host_shim.h", d / "cuda_runtime.h")
    src = SOURCE.read_text()
    assert src.count(SHARED) == 1, "the kernel's shared array moved"
    src, n = LAUNCH.subn(r"emulate_block_launch(\2, \3, [&] { \1(\4); });", src.replace(SHARED, "unsigned* smem = shim_shared;"))
    assert n == 1, "the kernel's launch line moved"
    (d / "groupby_mxu.cpp").write_text(src)
    lib = d / "libgroupby_mxu_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(d), "-o", str(lib),
                    str(d / "groupby_mxu.cpp")], check=True, capture_output=True)
    return GM.declare(ctypes.CDLL(str(lib)))


def _host_call(fn, keys, vals, nlimb):
    count = torch.zeros(GM.SLOTS, dtype=torch.int32)
    total = torch.zeros(GM.SLOTS, dtype=torch.int64)
    err = fn(keys.data_ptr(), vals.data_ptr(), keys.shape[0], vals.element_size(), nlimb, count.data_ptr(),
             total.data_ptr(), None)
    assert err == 0
    return count, total


@pytest.mark.parametrize("dtype,nlimb", [(torch.int32, 4), (torch.int32, 2), (torch.int64, 5), (torch.int64, 8)])
@pytest.mark.parametrize("domain", [1, 5, 4096])
@pytest.mark.parametrize("offset", [0, 1])
def test_kernel_source_matches_plain(host_kernel, dtype, nlimb, domain, offset):
    """The kernel's own source on the host gives the plain version's tables:
    a handful of keys (every lane of a warp on a few slots) and the whole
    table; 16-byte aligned planes (the vector loop and its tail, n % 4 ==
    3) and planes one row in (the scalar loop); more rows than one block's
    share."""
    rng = np.random.default_rng([domain, nlimb, offset])
    n = 40_003
    keys = torch.from_numpy(rng.integers(0, domain, n + 1).astype(np.int32))[offset:]
    hi = 2**31 if dtype == torch.int32 else 2**62
    vals = torch.from_numpy(rng.integers(-hi, hi, n + 1)).to(dtype)[offset:]
    want = GM.groupby_dense_plain(keys, vals, nlimb)
    got = _host_call(host_kernel, keys, vals, nlimb)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_source_table_design_drops_keys_outside_the_table(host_kernel):
    keys = torch.tensor([0, 5, 4095, 4096, -1, 5, 7], dtype=torch.int32)
    vals = torch.tensor([1 << 40, 3, 1, 7, 7, 1, 2], dtype=torch.int64)
    count, total = _host_call(host_kernel, keys, vals, 8)
    assert count[[0, 5, 4095, 7]].tolist() == [1, 2, 1, 1] and int(count.sum()) == 5
    assert total[[0, 5, 4095, 7]].tolist() == [1 << 40, 4, 1, 2]


def _spy_dense(monkeypatch):
    """The (value dtype, nlimb) of each B5 call the operators make."""
    calls = []
    orig = GM.groupby_dense

    def spy(k, v, nlimb, length=None):
        calls.append((v.dtype, nlimb))
        return orig(k, v, nlimb, length)

    monkeypatch.setattr(GM, "groupby_dense", spy)
    return calls


@pytest.mark.parametrize("case", ["q1_like", "u64", "i64_high"])
def test_mxu_route_64_bit_values(monkeypatch, case):
    """64-bit value columns take the mxu route with their 64 bits (B5 called
    once a column with an int64 plane) and answer as the JAX package does
    (its sort route: it takes no value over 32 bits on its mxu route), and
    as the port's own sort route does."""
    rng = np.random.default_rng(len(case))
    n = 9000
    kdt = {"q1_like": np.uint8, "u64": np.uint32, "i64_high": np.int64}[case]
    jk = at.PrimitiveArray.from_slice(rng.integers(0, 5 if case == "q1_like" else 3000, n).astype(kdt),
                                      dtype=at.ArrowType(np.dtype(kdt).name))
    top = 2**40 if case == "q1_like" else 2**49  # 9000 rows x 2^49 < 2^63
    vdt = at.ArrowType.UINT64 if case == "u64" else at.ArrowType.INT64
    jv = at.PrimitiveArray.from_slice(rng.integers(0, top, n).astype(np.dtype(vdt.value)), dtype=vdt)
    small = at.Int32Array.from_slice(rng.integers(0, 100, n).astype(np.int32))
    jaggs = [("s", jv, "sum"), ("m", jv, "mean"), ("s32", small, "sum"), ("n", None, "count")]
    keys, vals, tsmall = jax_to_torch(jk), jax_to_torch(jv), jax_to_torch(small)
    aggs = [("s", vals, "sum"), ("m", vals, "mean"), ("s32", tsmall, "sum"), ("n", None, "count")]
    calls = _spy_dense(monkeypatch)
    got = TC.hash_aggregate(keys, aggs, method="mxu")
    assert calls == [(torch.int64, 5 if top == 2**40 else 7), (torch.int32, 1)]
    _check(JC.hash_aggregate(jk, jaggs), got)
    want = TC.hash_aggregate(keys, aggs, method="sort")
    for name in want.column_names:
        assert_same(want[name], got[name], rtol=0)


@pytest.mark.parametrize("case", ["int64_2_33", "key_domain_int64", "key_domain_value_bits"])
def test_64_bit_values_under_auto_match_jax(monkeypatch, case):
    """int64 values of 2^33 and more under auto, against the JAX package
    (which answers them on its sort route): rows x largest value below 2^63
    take the mxu route; with key_domain and no value_bits a 64-bit column
    may hold any value, so the route declines it and auto answers on the
    sort route; with value_bits the route takes it."""
    rng = np.random.default_rng(len(case) + 64)
    n = 8192
    jk = at.UInt32Array.from_slice(rng.integers(0, 64, n).astype(np.uint32))
    lo, bits = (2**33, None) if case == "int64_2_33" else (2**32, 40)
    jv = at.Int64Array.from_slice(rng.integers(lo, 2**bits if bits else lo + 100, n).astype(np.int64))
    kw = {} if case == "int64_2_33" else {"key_domain": (0, 4096)}
    if case == "key_domain_value_bits":
        kw["value_bits"] = bits
    calls = _spy_dense(monkeypatch)
    _run_both(jk, [jv], [("s", 0, "sum"), ("m", 0, "mean"), ("c", None, "count")], "auto", **kw)
    on_mxu = case != "key_domain_int64"
    assert calls == ([(torch.int64, 5)] if on_mxu else [])


def test_64_bit_values_past_2_63_decline_the_mxu_route():
    """rows x the largest value at 2^63 or more: mxu raises, partition and
    B6 take no 64-bit value, auto answers on the sort route exactly."""
    n = 4096
    keys = att.UInt32Array.from_slice(np.arange(n, dtype=np.uint32) % 7, device="cpu")
    vals = np.full(n, 3, np.int64)
    vals[5] = 2**51  # 4096 x 2^51 = 2^63: the sums could pass int64
    v = att.Int64Array.from_slice(vals, device="cpu")
    for method in ("mxu", "partition"):
        with pytest.raises(att.OperationNotSupported, match=f"{method} groupby requires"):
            TC.hash_aggregate(keys, [("s", v, "sum")], method=method)
    got = TC.hash_aggregate(keys, [("s", v, "sum")])
    exp = np.zeros(7, np.int64)
    np.add.at(exp, np.arange(n) % 7, vals)
    assert got["s"].raw_values().tolist() == exp.tolist()
    ok = att.Int64Array.from_slice(np.minimum(vals, 2**51 - 1), device="cpu")  # just under: mxu
    assert TC.hash_aggregate(keys, [("s", ok, "sum")], method="mxu").num_rows == 7
