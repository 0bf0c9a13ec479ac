"""arrow_tpu_torch on a CUDA device: each hand-written kernel against its
plain PyTorch version, and the operators and the flagship query on the card
against the same calls on the CPU and a numpy oracle.

Every test needs the card and skips without one.  This file imports no JAX,
so that it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""

import collections
import contextlib
import functools
import importlib
import json
import pathlib
import subprocess
import sys

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
from arrow_tpu_torch.compute.kernels import compaction as C1
from arrow_tpu_torch.compute.kernels import compaction3 as C3
from arrow_tpu_torch.compute.kernels import groupby_mxu as GM
from arrow_tpu_torch.compute.kernels import merge as M
from arrow_tpu_torch.compute.kernels import plain_versions
from arrow_tpu_torch.compute.kernels import radix as R
from arrow_tpu_torch.compute.kernels import segscan as S
from arrow_tpu_torch.compute.kernels import take as TT
from arrow_tpu_torch.compute.kernels.groupby_region import KERNEL as REGION_KERNEL
from arrow_tpu_torch.compute.kernels.groupby_region import groupby_region, groupby_region_plain
from arrow_tpu_torch.ops.kernel import AV
from arrow_tpu_torch.tools import mosaic_probe as MP
from arrow_tpu_torch.tools import probe_designs as PD
from arrow_tpu_torch.tools import probe_r4 as PR
from arrow_tpu_torch.utils import bits as TB
from arrow_tpu_torch.utils import scans as TS
from torch_helpers import MERGE_PATTERNS, TAKE_KINDS, TAKE_SHAPES, TAKE_SRC_ROWS, exact_column, index_plane, merge_edge_planes

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


# B1's tiles are four parts: 32768 rows (8192 a part) of 4-byte planes,
# 16384 (4096 a part) where a plane is 8 bytes wide: lengths around each,
# and many tiles
B1_LENGTHS = [0, 1, 31, 4095, 4096, 4097, 8191, 8192, 8193, 16383, 16384, 16385, 32767, 32768, 32769,
              5 * 32768 + 3, (1 << 20) + 17]
B1_PATTERNS = ["none", "0.01", "0.5", "0.99", "all", "every32", "first", "last", "alternate", "block"]


def _b1_flags(rng, pattern, n):
    """A selection: random at a selectivity, or a shape that stresses the
    tile edges (only the first row, only the last, every other row, the
    second 8192-row block alone)."""
    rows = np.arange(n)
    shaped = {"none": rows < 0, "all": rows >= 0, "every32": rows % 32 == 0, "first": rows == 0,
              "last": rows == n - 1, "alternate": rows % 2 == 0, "block": (rows >= 8192) & (rows < 16384)}
    return shaped[pattern] if pattern in shaped else rng.random(n) < float(pattern)


def _b1_planes(rng, kind, n, device, offset=0):
    """(value planes, bitmap planes): "4-byte", "mixed" (4- and 8-byte value
    planes and a bitmap plane) or "16 planes"; with `offset`, views that start
    that many rows (bitmap planes: words) into a larger tensor."""
    def i32():
        return rng.integers(-(2**31), 2**31, n + offset).astype(np.int32)

    def f32():
        return rng.standard_normal(n + offset).astype(np.float32)

    def i64():
        return rng.integers(-(2**63), 2**63 - 1, n + offset, dtype=np.int64)

    def f64():
        return rng.standard_normal(n + offset)

    def bitmap():
        return TB.pack_bits_np(rng.random(n + 32 * offset) < 0.5).view(np.int32)

    makers = {"4-byte": ((i32, f32), ()), "mixed": ((i32, f64), (bitmap,)),
              "16 planes": ((i32, i64, f32, f64) * 3, (bitmap,) * 4)}[kind]
    return ([torch.from_numpy(m()).to(device)[offset:] for m in makers[0]],
            [torch.from_numpy(m()).to(device)[offset:] for m in makers[1]])


def _check_compact_multi(planes, words, mask, n, want_count):
    before = C3.KERNEL.launches
    kv, kw, kc = C3.compact_multi(planes, words, mask, n)
    torch.cuda.synchronize()
    assert C3.KERNEL.launches == before + 1
    pv, pw, pc = C3.compact_multi_plain(planes, words, mask, n)
    assert int(kc) == int(pc) == want_count
    for k, p in zip(kv + kw, pv + pw):
        assert k.is_cuda and torch.equal(k, p)


def _compact_multi_case(n, pattern, kind, device):
    rng = np.random.default_rng(n)
    flags = _b1_flags(rng, pattern, n)
    planes, words = _b1_planes(rng, kind, n, device)
    mask = torch.from_numpy(TB.pack_bits_np(flags).view(np.int32)).to(device)
    _check_compact_multi(planes, words, mask, n, int(flags.sum()))


@pytest.mark.parametrize("n", B1_LENGTHS)
@pytest.mark.parametrize("pattern", B1_PATTERNS)
def test_compact_multi_kernel_matches_plain(cuda, n, pattern):
    """An i32 and an f64 plane and a bitmap plane."""
    _compact_multi_case(n, pattern, "mixed", cuda)


@pytest.mark.parametrize("n", B1_LENGTHS)
@pytest.mark.parametrize("pattern", B1_PATTERNS)
def test_compact_multi_kernel_four_byte_planes(cuda, n, pattern):
    """An i32 and an f32 plane: the launch's widest plane is 4 bytes."""
    _compact_multi_case(n, pattern, "4-byte", cuda)


@pytest.mark.parametrize("n", [16384, 32768, 5 * 32768 + 3])
@pytest.mark.parametrize("pattern", ["0.5", "first", "last", "alternate"])
def test_compact_multi_kernel_sixteen_mixed_planes(cuda, n, pattern):
    rng = np.random.default_rng(n + 16)
    flags = _b1_flags(rng, pattern, n)
    planes, words = _b1_planes(rng, "16 planes", n, cuda)
    assert len(planes) + len(words) == C3.MAX_PLANES
    mask = torch.from_numpy(TB.pack_bits_np(flags).view(np.int32)).to(cuda)
    _check_compact_multi(planes, words, mask, n, int(flags.sum()))


@pytest.mark.parametrize("n", [8193, (1 << 20) + 17])
@pytest.mark.parametrize("pattern", ["0.5", "first", "last", "alternate", "block"])
@pytest.mark.parametrize("kind", ["4-byte", "mixed", "16 planes"])
def test_compact_multi_kernel_misaligned_views(cuda, n, pattern, kind):
    """Planes, bitmaps and the mask as views one row (or word) in: 16-byte
    loads meet bases that are not 16-byte aligned."""
    rng = np.random.default_rng(n + 1)
    flags = _b1_flags(rng, pattern, n)
    planes, words = _b1_planes(rng, kind, n, cuda, offset=1)
    assert all(p.data_ptr() % 16 for p in planes + words)
    mask = torch.from_numpy(np.concatenate([[0], TB.pack_bits_np(flags).view(np.int32)]).astype(np.int32))
    _check_compact_multi(planes, words, mask.to(cuda)[1:], n, int(flags.sum()))


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


def _same_scan(got, want):
    if want.is_floating_point():
        torch.testing.assert_close(got, want, rtol=ADD_RTOL[want.dtype], atol=0, equal_nan=True)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 8193, (1 << 16) + 17])
@pytest.mark.parametrize("flags", ["none", "sparse", "dense"])
@pytest.mark.parametrize("name", ["int32", "uint32", "float32", "int64", "uint64", "float64"])
@pytest.mark.parametrize("nplanes", [2, 3])
def test_segmented_scan_multi_kernel_matches_plain(cuda, n, flags, name, nplanes):
    """One launch scans every plane; each plane equals the plain version
    (float adds at ADD_RTOL, everything else exact)."""
    rng = np.random.default_rng(n + nplanes)
    planes = [_scan_values(rng, name, n)[0].to(cuda) for _ in range(nplanes)]
    unsigned = name.startswith("u")
    density = {"none": 0.0, "sparse": 0.001, "dense": 0.3}[flags]
    tf = torch.from_numpy(rng.random(n) < density).to(cuda) if density else None
    for op in S.OPS:
        before = S.KERNEL.launches
        got = S.segmented_scan_multi(planes, tf, op, unsigned)
        torch.cuda.synchronize()
        assert S.KERNEL.launches == before + 1 and len(got) == nplanes
        want = S.segmented_scan_multi_plain(planes, tf, op, unsigned)
        for g, w in zip(got, want):
            assert g.is_cuda
            if op == "add":
                _same_scan(g, w)
            else:
                assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["int32", "uint32", "float32", "int64", "uint64", "float64"])
def test_segmented_scan_misaligned_views(cuda, name):
    """Views with a storage offset (values and flags one row in) take the
    kernel's element-wise path and give the plain version's answer."""
    rng = np.random.default_rng(41)
    n = (1 << 16) + 17
    bases = [_scan_values(rng, name, n + 1)[0].to(cuda) for _ in range(2)]
    flags = torch.from_numpy(rng.random(n + 1) < 0.01).to(cuda)[1:]
    planes = [b[1:] for b in bases]
    assert planes[0].data_ptr() % 16 and flags.data_ptr() % 16
    for op in S.OPS:
        for args in ((planes, flags), (planes[:1], None)):
            before = S.KERNEL.launches
            got = S.segmented_scan_multi(*args, op, name.startswith("u"))
            torch.cuda.synchronize()
            assert S.KERNEL.launches == before + 1
            want = S.segmented_scan_multi_plain(*args, op, name.startswith("u"))
            for g, w in zip(got, want):
                if op == "add":
                    _same_scan(g, w)
                else:
                    assert torch.equal(g, w)


def test_join_expand_launches_b2_once(cuda, monkeypatch):
    """The merge-expand emit's three fills are one B2 launch."""
    monkeypatch.setattr(TSORT, "RADIX_AUTO_ROWS", 0)
    launches = []
    expand = TJ._expand

    def counted(*args):
        before = S.KERNEL.launches
        out = expand(*args)
        torch.cuda.synchronize()
        launches.append(S.KERNEL.launches - before)
        return out

    monkeypatch.setattr(TJ, "_expand", counted)
    rng = np.random.default_rng(43)
    build = att.UInt32Array.from_slice(rng.integers(0, 500, 20_000).astype(np.uint32), device="cpu")
    probe = att.UInt32Array.from_slice(rng.integers(0, 500, 50_001).astype(np.uint32), device="cpu")
    want = TC.join_indices(build, probe)
    got = TC.join_indices(_to(build, cuda), _to(probe, cuda))
    assert launches == [1]
    assert _pair_set(got[0], got[1]) == _pair_set(want[0], want[1])


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


@pytest.mark.parametrize("digit_bits", [1, 2, 8])
@pytest.mark.parametrize("name,key_bits,bits,passes", [
    ("class bits", 32, list(range(12, 20)), 1), ("bit 31", 32, [31], 1), ("bit 63", 64, [63], 1),
    ("scattered", 32, [3, 17, 30], 3), ("straddling 32", 64, [30, 31, 32, 33], 1), ("none", 32, [], 0),
])
def test_radix_sort_kernel_by_given_bits(cuda, name, key_bits, bits, passes, digit_bits):
    """Digits aligned to the bits sorted by: bits 12-19 are one 8-bit pass,
    a top bit takes the clamped digit."""
    rng = np.random.default_rng(len(name) + digit_bits)
    n = (1 << 16) + 17
    planes = _radix_planes(rng, n, key_bits, 2**32, 3)
    if key_bits == 64:  # random low halves too
        planes[0] = planes[0] ^ torch.from_numpy(rng.integers(0, 2**32, n))
    counter = R.KERNEL_2BIT if digit_bits == 2 else R.KERNEL
    counter.passes = 0
    got = R.radix_sort([p.to(cuda) for p in planes], bits, n - 5, digit_bits)
    torch.cuda.synchronize()
    if digit_bits == 8:
        assert counter.passes == passes
    want = R.radix_sort_plain(planes, bits, n - 5, digit_bits)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    mask = sum(1 << b for b in bits)
    raw = planes[0].numpy().view(np.uint64 if key_bits == 64 else np.uint32)[: n - 5].astype(np.uint64)
    np.testing.assert_array_equal(got[1].cpu().numpy()[: n - 5], np.argsort(raw & np.uint64(mask), kind="stable"))


@pytest.mark.parametrize("shape", ["hot", "all equal", "reversed", "skew"])
def test_radix_sort_kernel_look_back_stress(cuda, shape):
    """Keys that stress the look-back: one digit value in 99% of the rows, an
    all-equal key (no pass), a descending arange, the group-by's skew."""
    rng = np.random.default_rng(len(shape))
    n = (1 << 20) + 17
    if shape == "hot":
        k = np.where(rng.random(n) < 0.99, 0x00ABCDEF, rng.integers(0, 2**31, n)).astype(np.int32)
    elif shape == "all equal":
        k = np.full(n, 0x01234567, np.int32)
    elif shape == "reversed":
        k = np.arange(n - 1, -1, -1, dtype=np.int32)
    else:
        k = (rng.random(n) ** 4 * (1 << 20)).astype(np.int32)
    planes = [torch.from_numpy(k), torch.arange(n, dtype=torch.int32)]
    bits = list(range(12, 20)) if shape == "skew" else 32
    R.KERNEL.passes = 0
    got = R.radix_sort([p.to(cuda) for p in planes], bits, n)
    torch.cuda.synchronize()
    if shape in ("all equal", "skew"):
        assert R.KERNEL.passes == (0 if shape == "all equal" else 1)
    for g, w in zip(got, R.radix_sort_plain(planes, bits, n)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("digit_bits", [1, 2, 8])
@pytest.mark.parametrize("key_bits", [32, 64])
def test_radix_sort_kernel_eight_planes(cuda, key_bits, digit_bits):
    rng = np.random.default_rng(key_bits + digit_bits)
    n = (1 << 16) + 17
    key, *pays = _radix_planes(rng, n, key_bits, 2**32, 4)
    planes = [key, *pays, pays[1].float(), pays[2] ^ 0x5555, pays[0] + 1]
    assert len(planes) == R.MAX_PLANES
    got = R.radix_sort([p.to(cuda) for p in planes], key_bits, n, digit_bits)
    for g, w in zip(got, R.radix_sort_plain(planes, key_bits, n, digit_bits)):
        assert torch.equal(g.cpu(), w)


def test_partition_route_class_sort_is_one_pass_on_cuda(cuda):
    from arrow_tpu_torch import flagship

    batch = flagship.make_groupby_batch(1 << 18, "1m", 0, cuda)
    R.KERNEL.passes = 0
    out = flagship.groupby_query(batch)
    torch.cuda.synchronize()
    assert R.KERNEL.passes == 1
    with plain_versions():
        plain = flagship.groupby_query(batch)
    for name in out.column_names:
        assert torch.equal(out[name].data, plain[name].data)


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


# B7's tiles are 3712 output rows, within a pair where a pair holds a tile
B7_TILE = 3712


def _check_merge(planes, run_len, unique, device, offset=0):
    """B7 on `planes` moved to `device`, as views `offset` rows into larger
    tensors, against its plain version on the CPU."""
    views = [torch.cat([torch.zeros(offset, dtype=torch.int32), p]).to(device)[offset:] for p in planes]
    if offset:
        assert all(v.data_ptr() % 16 for v in views)  # contiguous, not 16-byte aligned
    before = M.KERNEL.launches
    got = M.merge_pass(views, run_len, unique)
    torch.cuda.synchronize()
    assert M.KERNEL.launches == before + 1
    want = M.merge_pass_plain(planes, run_len, unique)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [B7_TILE - 1, B7_TILE, B7_TILE + 1, 5 * B7_TILE + 3, (1 << 20) + 17])
@pytest.mark.parametrize("run_len", [B7_TILE // 2 - 1, B7_TILE // 2, B7_TILE // 2 + 1, B7_TILE, "half"])
@pytest.mark.parametrize("unique", [False, True])
def test_merge_pass_kernel_around_its_tile(cuda, n, run_len, unique):
    run_len = max(1, n // 2) if run_len == "half" else run_len
    _check_merge(_runs(np.random.default_rng(n + run_len), n, run_len, unique), run_len, unique, cuda)


@pytest.mark.parametrize("pattern", MERGE_PATTERNS)
@pytest.mark.parametrize("run_len", ["one pair", 8192])
@pytest.mark.parametrize("unique", [False, True])
def test_merge_pass_kernel_edge_patterns(cuda, pattern, run_len, unique):
    n = (1 << 20) + 17
    run_len = (n + 1) // 2 if run_len == "one pair" else run_len
    planes = [torch.from_numpy(p) for p in merge_edge_planes(pattern, n, run_len, unique, seed=n)]
    _check_merge(planes, run_len, unique, cuda)


@pytest.mark.parametrize("n", [B7_TILE + 1, (1 << 20) + 17])
@pytest.mark.parametrize("run_len", [B7_TILE // 2 + 1, "half"])
def test_merge_pass_kernel_eight_planes(cuda, n, run_len):
    run_len = max(1, n // 2) if run_len == "half" else run_len
    rng = np.random.default_rng(n)
    planes = _runs(rng, n, run_len, False)
    planes += [torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32))
               for _ in range(M.MAX_PLANES - len(planes))]
    _check_merge(planes, run_len, False, cuda)


@pytest.mark.parametrize("run_len", [B7_TILE // 2 + 1, B7_TILE, "half"])
@pytest.mark.parametrize("unique", [False, True])
def test_merge_pass_kernel_misaligned_views(cuda, run_len, unique):
    n = (1 << 20) + 17
    run_len = (n + 1) // 2 if run_len == "half" else run_len
    _check_merge(_runs(np.random.default_rng(run_len), n, run_len, unique), run_len, unique, cuda, offset=1)


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


def test_radix_route_two_bit_on_cuda(cuda):
    """The 2-bit chain (B4), asked for by ``digit_bits=2``, on the card
    against the stable torch.sort route on the CPU."""
    rng = np.random.default_rng(19)
    keys = att.UInt32Array.from_slice(rng.integers(0, 10_000, 100_003).astype(np.uint32), device="cpu")
    vals = att.Float32Array.from_slice(rng.standard_normal(100_003).astype(np.float32), device="cpu")
    gk, gv = _to(keys, cuda), _to(vals, cuda)
    before = R.KERNEL_2BIT.launches
    sk, sv = TCK.radix_sort([gk.data, gv.data], 32, gk.length, digit_bits=2)  # u32: the bits are the order
    torch.cuda.synchronize()
    assert R.KERNEL_2BIT.launches == before + 1
    wk, wv = TC.sort_by_key(keys, vals, method="xla")
    _same(wk, att.make_array(sk, None, gk.length, gk.dtype))
    _same(wv, att.make_array(sv, None, gv.length, gv.dtype))


def _pair_set(pi, bi):
    return sorted(zip(pi.raw_values().tolist(), bi.raw_values().tolist()))


@pytest.mark.parametrize("name,domain,null_p", [("uint32", 5000, 0.0), ("uint32", 300, 0.2), ("int64", 1000, 0.1)])
def test_join_on_cuda_matches_cpu(cuda, name, domain, null_p, monkeypatch):
    """The merge-expand emit on the card (co-sort on kernel B3 for u32 keys,
    with its gate opened at this size) against the CPU's legacy emit."""
    monkeypatch.setattr(TSORT, "RADIX_AUTO_ROWS", 0)
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


@pytest.mark.parametrize("name,null_p", [("uint32", 0.0), ("int64", 0.2)])
def test_join_one_match_on_cuda_matches_cpu(cuda, name, null_p, monkeypatch):
    """Unique build keys on the card (co-sort on kernel B3 for u32 keys, with
    its gate opened at this size): the one-match emit, one B2 fill and one
    B1 compaction past the plan's and no B7 pass, against the CPU's legacy
    emit; index planes of the emit's capacity, zero past the matches."""
    monkeypatch.setattr(TSORT, "RADIX_AUTO_ROWS", 0)
    rng = np.random.default_rng(31)
    dt_ = np.dtype(name)
    keys = rng.permutation(20_000).astype(dt_)
    build = att.PrimitiveArray.from_optional_slice(
        [int(v) if ok else None for v, ok in zip(keys, rng.random(20_000) >= null_p)],
        dtype=att.ArrowType(name), device="cpu",
    )
    probe = att.PrimitiveArray.from_slice(rng.integers(0, 30_000, 50_001).astype(dt_), dtype=att.ArrowType(name),
                                          device="cpu")
    want = TC.join_indices(build, probe)
    fills = []
    one_match = TJ._one_match

    def counted(*args):
        before = S.KERNEL.launches, C3.KERNEL.launches
        out = one_match(*args)
        fills.append((S.KERNEL.launches - before[0], C3.KERNEL.launches - before[1]))
        return out

    monkeypatch.setattr(TJ, "_one_match", counted)
    before = M.KERNEL.launches
    got = TC.join_indices(_to(build, cuda), _to(probe, cuda))
    assert fills == [(1, 1)] and M.KERNEL.launches == before
    assert got[0].data.is_cuda and got[2] == want[2] > 0
    assert _pair_set(got[0], got[1]) == _pair_set(want[0], want[1])
    for plane in (got[0].data, got[1].data):
        assert plane.shape[0] == TJ._bucket(got[2]) and not bool(plane[got[2]:].any())


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


# ------------------------------------------- take_columns, the join's take


def _take_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.data.is_cuda and g.dtype is w.dtype and g.length == w.length
        assert g.data.dtype == w.data.dtype and torch.equal(g.data.view(torch.uint8), w.data.view(torch.uint8))
        assert (g.validity is None) == (w.validity is None)
        assert g.validity is None or torch.equal(g.validity, w.validity)


def _take_launch(columns, planes, length):
    """The kernel's outputs and its plain version's, both on the card; the
    launches it counted."""
    before = TT.KERNEL.launches
    got = TT.take_columns(columns, planes, length)
    torch.cuda.synchronize()
    launched = TT.KERNEL.launches - before
    return got, TT.take_columns_plain(columns, planes, length), launched


def _on(arr, device):
    return AV(arr.data.to(device), None if arr.validity is None else arr.validity.to(device), arr.length,
                 arr.dtype)


@pytest.mark.parametrize("shape", [*TAKE_SHAPES, ((1 << 20) + 4, 1_000_003)], ids=lambda s: f"cap{s[0]}-len{s[1]}")
@pytest.mark.parametrize("nulls", [False, True], ids=["no_validity", "validity"])
@pytest.mark.parametrize("kind", TAKE_KINDS)
def test_take_columns_kernel_matches_plain(cuda, kind, nulls, shape):
    """Bit for bit, zeros past the length, indices past the source clamped."""
    cap, length = shape
    rng = np.random.default_rng([TAKE_KINDS.index(kind), nulls, cap, length])
    cols = [_on(exact_column(rng, kind, n, nulls), cuda) for n in (TAKE_SRC_ROWS, 70_001)]
    planes = [index_plane(rng, cap, length, n).data.to(cuda) for n in (TAKE_SRC_ROWS, 70_001)]
    got, want, launched = _take_launch([(cols[0], 0), (cols[1], 1), (cols[0], 1)], planes, length)
    _take_same(got, want)
    assert launched == (1 if cap else 0)


@pytest.mark.parametrize("ncols", [16, 17, 22, 33])
def test_take_columns_kernel_many_columns(cuda, ncols):
    """Every width, BOOL and validity mixed, both planes, one launch a 16
    columns; views one row into their buffers, an index plane too."""
    rng = np.random.default_rng(ncols)
    kinds = (TAKE_KINDS * 4)[:ncols]
    cols = [_on(exact_column(rng, kind, 5000 + i, i % 3 == 0), cuda) for i, kind in enumerate(kinds)]
    cols = [c if i % 4 or c.dtype is att.ArrowType.BOOL else c._replace(data=c.data[1:]) for i, c in enumerate(cols)]
    planes = [index_plane(rng, 8193, 8191, 5000).data.to(cuda), index_plane(rng, 8194, 8192, 5000).data.to(cuda)[1:]]
    columns = [(c, i % 2) for i, c in enumerate(cols)]
    got, want, launched = _take_launch(columns, planes, 8191)
    _take_same(got, want)
    assert launched == -(-ncols // TT.MAX_COLUMNS)


def _wide_batches(cuda, n_probe, n_build, extra):
    """A probe and a build batch on the card, keyed by "k", with columns of
    every width, BOOL and validity on both sides (``extra`` more a side)."""
    rng = np.random.default_rng(41)
    kinds = TAKE_KINDS[: 6 + extra]

    def batch(n, domain):
        cols = {"k": att.UInt32Array.from_slice(rng.integers(0, domain, n).astype(np.uint32), device=cuda)}
        for i, kind in enumerate(kinds):
            cols[f"c{i}"] = _to(exact_column(rng, kind, n, i % 2 == 1), cuda)
        return att.RecordBatch(cols)

    return batch(n_probe, 3000), batch(n_build, 3000)


@pytest.mark.parametrize("extra", [0, 4])
def test_hash_join_takes_with_take_columns(cuda, extra):
    """hash_join on the card gathers its output columns with take_columns,
    one launch a 16 columns, equal bit for bit to its plain path's."""
    left, right = _wide_batches(cuda, 20_000, 5_000, extra)
    ncols = len(left.column_names) + len(right.column_names) - 1
    before = TT.KERNEL.launches
    got = TC.hash_join(left, right, "k", "k")
    torch.cuda.synchronize()
    assert TT.KERNEL.launches - before == -(-ncols // TT.MAX_COLUMNS)
    with plain_versions():
        want = TC.hash_join(left, right, "k", "k")
    assert TT.KERNEL.launches - before == -(-ncols // TT.MAX_COLUMNS)
    assert got.column_names == want.column_names and len(got.column_names) == ncols
    _take_same([got[n] for n in got.column_names], [want[n] for n in want.column_names])


def test_join_take_runs_no_per_column_gather(cuda, monkeypatch):
    """Inside att.join.take on the card: no index gather, no arange, where,
    compare, clamp or widening copy; only the kernel's outputs allocated.
    The ops are read by a dispatch mode, not a profiler: a CPU-only profile
    here left the file's later CUDA traces without device records in a
    whole-file run on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    left, right = _wide_batches(cuda, 20_000, 5_000, 4)
    inside, ops = [False], []
    real_span = TJ.span

    @contextlib.contextmanager
    def spy(name):
        was = inside[0]
        inside[0] = was or name == "att.join.take"
        try:
            with real_span(name):
                yield
        finally:
            inside[0] = was

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if inside[0]:
                ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(TJ, "span", spy)
    before = TT.KERNEL.launches
    with Ops():
        TC.hash_join(left, right, "k", "k")
    torch.cuda.synchronize()
    assert TT.KERNEL.launches - before == 2  # 21 output columns
    assert ops and set(ops) <= {"aten.empty"}, sorted(set(ops))


def test_sort_join_query_on_cuda(cuda):
    """The sort-join query on the card: kernels B1, B2 and B3 (the radix
    gate opened at this size) launch, and no B7 pass, since each kept row meets
    one group (the join's one-match emit); the result equals the plain
    path's and a numpy oracle's."""
    n = 1 << 18
    cols = flagship.make_host_columns(n, seed=2)
    batch = flagship.make_batch(n, seed=2, device=cuda)
    saved = TSORT.RADIX_AUTO_ROWS
    TSORT.RADIX_AUTO_ROWS = 0
    try:
        before = {k: v.launches for k, v in KERNELS.items()}
        kept, groups, joined, (sk, sv) = flagship.sort_join_query(batch)
        after = {k: v.launches for k, v in KERNELS.items()}
        with plain_versions():
            pk, pg, pj, (psk, psv) = flagship.sort_join_query(batch)
    finally:
        TSORT.RADIX_AUTO_ROWS = saved
    for name in ("compact_multi", "segmented_scan", "radix_sort"):
        assert after[name] > before[name], name
    assert after["merge_pass"] == before["merge_pass"]
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


# ------------------------------------------------- kernels B8 and B9


def _split_case(rng, n, form, device, offset=0):
    """Three 4-byte planes (views `offset` rows in) and the split's selection."""
    planes = [
        torch.from_numpy(rng.integers(-(2**31), 2**31, n + offset).astype(np.int32)).to(device)[offset:],
        torch.from_numpy(rng.standard_normal(n + offset).astype(np.float32)).to(device)[offset:],
        torch.from_numpy(rng.integers(0, 2**32, n + offset, dtype=np.uint64).astype(np.uint32).view(np.int32))
        .to(device)[offset:],
    ]
    if form.startswith("bit"):
        return planes, {"bit": int(form[3:])}
    words = np.concatenate([np.zeros(offset, np.int32), TB.pack_bits_np(_b1_flags(rng, form, n)).view(np.int32)])
    return planes, {"mask_words": torch.from_numpy(words.astype(np.int32)).to(device)[offset:]}


def _check_split_multi(planes, kw):
    before = C3.SPLIT_KERNEL.launches
    ks, ku, kc = C3.split_multi(planes, **kw)
    torch.cuda.synchronize()
    assert C3.SPLIT_KERNEL.launches == before + 1
    ps, pu, pc = C3.split_multi_plain(planes, **kw)
    assert int(kc) == int(pc)
    for k, p in zip(ks + ku, ps + pu):
        assert k.is_cuda and torch.equal(k, p)


@pytest.mark.parametrize("n", [0, 1, 31, 8192, 8193, 32767, 32768, 32769, 5 * 32768 + 3, (1 << 20) + 17])
@pytest.mark.parametrize("form", ["0", "0.01", "0.5", "0.99", "1", "first", "last", "alternate", "block",
                                  "bit0", "bit17", "bit31"])
def test_split_multi_kernel_matches_plain(cuda, n, form):
    rng = np.random.default_rng(n + len(form))
    _check_split_multi(*_split_case(rng, n, form, cuda))


@pytest.mark.parametrize("form", ["0.5", "alternate", "last", "bit0"])
def test_split_multi_kernel_misaligned_views(cuda, form):
    rng = np.random.default_rng(len(form))
    planes, kw = _split_case(rng, (1 << 20) + 17, form, cuda, offset=1)
    assert all(p.data_ptr() % 16 for p in planes)
    _check_split_multi(planes, kw)


@pytest.mark.parametrize("n", [0, 1, 31, 8192, 8193, 32767, 32768, 32769, 5 * 32768 + 3, (1 << 20) + 17])
@pytest.mark.parametrize("pattern", ["0", "0.01", "0.5", "1", "first", "last", "alternate", "block"])
def test_compact_kernel_matches_plain(cuda, n, pattern):
    rng = np.random.default_rng(n)
    data = torch.from_numpy(rng.integers(-(2**31), 2**31, n).astype(np.int32)).to(cuda)
    mask = torch.from_numpy(TB.pack_bits_np(_b1_flags(rng, pattern, n)).view(np.int32)).to(cuda)
    before = C1.KERNEL.launches, C3.KERNEL.launches
    out, count = C1.compact(data, mask)
    torch.cuda.synchronize()
    assert (C1.KERNEL.launches, C3.KERNEL.launches) == (before[0] + 1, before[1])
    want, wc = C1.compact_plain(data, mask)
    assert int(count) == int(wc) and torch.equal(out, want)


# ------------------------------------------------- kernels B5 and B6


def _table_inputs(rng, n, domain, order, device):
    keys = rng.integers(0, domain, n)
    if order == "skew":
        keys = (rng.random(n) ** 4 * domain).astype(np.int64)
    if order in ("grouped", "skew"):
        keys = keys[np.argsort(keys >> 12, kind="stable")]
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(keys.astype(np.int32)).to(device), torch.from_numpy(vals).to(device))


@pytest.mark.parametrize("n", [0, 1, 31, 8193, (1 << 20) + 17])
@pytest.mark.parametrize("domain", [1, 7, 1024, 4096, 5000])
@pytest.mark.parametrize("nlimb", [1, 4])
def test_groupby_dense_kernel_matches_plain(cuda, n, domain, nlimb):
    """Keys past 4096 (domain 5000) add nothing; rows past `length` neither."""
    rng = np.random.default_rng(n + domain)
    keys, vals = _table_inputs(rng, n, domain, "uniform", cuda)
    for length, k, v in ((None, keys, vals), (max(0, n - 9), keys, vals), (None, keys[1:], vals[1:])):
        before = GM.KERNEL.launches
        got = GM.groupby_dense(k, v, nlimb, length)
        torch.cuda.synchronize()
        assert GM.KERNEL.launches == before + 1
        want = GM.groupby_dense_plain(k, v, nlimb, length)
        assert all(g.is_cuda and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [0, 1, 31, 8193, (1 << 20) + 17])
@pytest.mark.parametrize("domain", [1, 5, 8, 100, 5000])
@pytest.mark.parametrize("nlimb", [1, 5, 8])
def test_groupby_dense_kernel_64_bit_values_match_plain(cuda, n, domain, nlimb):
    """int64 values with bits above 32, cut to 1, 5 or 8 limbs, over a
    handful of keys and the whole table; aligned and unaligned planes, and
    `length` below the rows."""
    rng = np.random.default_rng([n, domain, nlimb])
    keys = torch.from_numpy(rng.integers(0, domain, n).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.integers(0, 2**62, n, dtype=np.int64)).to(cuda)
    for length, k, v in ((None, keys, vals), (max(0, n - 9), keys, vals), (None, keys[1:], vals[1:])):
        want = GM.groupby_dense_plain(k, v, nlimb, length)
        before = GM.KERNEL.launches
        got = GM.groupby_dense(k, v, nlimb, length)
        torch.cuda.synchronize()
        assert GM.KERNEL.launches == before + 1
        assert all(g.is_cuda and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("domain", [1, 3, 8])
def test_groupby_dense_kernel_few_keys_match_plain(cuda, domain):
    """32-bit values of every pattern over a handful of keys, so that every
    lane of a warp adds into one of a few slots and their low words wrap
    many times: the plain version's tables, bit for bit."""
    rng = np.random.default_rng(domain)
    n = (1 << 22) + 3
    keys = torch.from_numpy(rng.integers(0, domain, n).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(cuda)
    got = GM.groupby_dense(keys, vals, 4)
    want = GM.groupby_dense_plain(keys, vals, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[0].sum()) == n


@pytest.mark.parametrize("n", [0, 1, 31, 8193, (1 << 20) + 17])
@pytest.mark.parametrize("nclass", [1, 2, 256, 1024])
@pytest.mark.parametrize("order", ["grouped", "unsorted", "skew"])
def test_groupby_region_kernel_matches_plain(cuda, n, nclass, order):
    rng = np.random.default_rng(n + nclass)
    keys, vals = _table_inputs(rng, n, nclass * 4096, order, cuda)
    for nlimb, k, v in ((4, keys, vals), (2, keys, vals), (4, keys[1:], vals[1:])):
        before = REGION_KERNEL.launches
        got = groupby_region(k, v, nlimb, nclass)
        torch.cuda.synchronize()
        assert REGION_KERNEL.launches == before + 1
        want = groupby_region_plain(k, v, nlimb, nclass)
        assert all(g.is_cuda and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("method,domain,vname", [
    ("mxu", 4096, "uint32"), ("partition", 1 << 20, "int32"), ("partition", 5000, "uint8"),
    ("radix", 1 << 31, "int32"), ("radix", 300, "float32"), ("mxu", 5, "int64"), ("mxu", 4096, "int64"),
])
def test_groupby_routes_on_cuda_match_cpu(cuda, method, domain, vname):
    """Each route on the card launches its kernels and gives the CPU's sort
    route's answer."""
    rng = np.random.default_rng(31)
    n = 100_000
    keys = att.UInt32Array.from_slice(rng.integers(0, domain, n).astype(np.uint32), device="cpu")
    high = {"uint32": 2**32, "uint8": 2**8, "int64": 2**40}.get(vname, 1000)
    vals = att.PrimitiveArray.from_slice(rng.integers(0, high, n).astype(vname), dtype=att.ArrowType(vname),
                                         device="cpu")
    aggs = [("s", vals, "sum"), ("c", vals, "count"), ("m", vals, "mean"), ("n", None, "count")]
    want = TC.hash_aggregate(keys, aggs, method="sort")
    gk, gv = _to(keys, cuda), _to(vals, cuda)
    before = {k: v.launches for k, v in KERNELS.items()}
    got = TC.hash_aggregate(gk, [(a, gv if c is not None else None, k) for a, c, k in aggs], method=method)
    after = {k: v.launches for k, v in KERNELS.items()}
    launched = {k for k in after if after[k] > before[k]}
    assert launched == {"mxu": {"groupby_dense"}, "partition": {"radix_sort", "groupby_region"},
                        "radix": {"radix_sort", "segmented_scan", "compact_multi"}}[method]
    for name in want.column_names:
        assert got[name].data.is_cuda
        _same(want[name], got[name], rtol=1e-6 if name == "s" else 1e-12)  # f32 sums: B2's order


@pytest.mark.parametrize("dist", flagship.GROUPBY_DISTS)
def test_groupby_query_on_cuda(cuda, dist):
    """groupby_query on the card: its route's kernels launch; the answer is
    the CPU's and, for the dense distributions, numpy's."""
    n = 1 << 18
    batch = flagship.make_groupby_batch(n, dist, seed=3, device=cuda)
    before = {k: v.launches for k, v in KERNELS.items()}
    got = flagship.groupby_query(batch)
    after = {k: v.launches for k, v in KERNELS.items()}
    need = {"1k": ["groupby_dense"], "1m": ["radix_sort", "groupby_region"],
            "skew": ["radix_sort", "groupby_region"], "100m": ["segmented_scan", "compact_multi"]}[dist]
    assert all(after[k] > before[k] for k in need), (dist, before, after)
    want = flagship.groupby_query(flagship.make_groupby_batch(n, dist, seed=3, device="cpu"))
    for name in want.column_names:
        assert got[name].data.is_cuda
        _same(want[name], got[name])
    if dist != "100m":
        cols = flagship.make_groupby_columns(n, dist, seed=3)
        keys, counts, sums = flagship.groupby_reference(cols["k"], cols["v"])
        np.testing.assert_array_equal(got["key"].raw_values(), keys)
        np.testing.assert_array_equal(got["c"].raw_values(), counts)
        np.testing.assert_array_equal(got["s"].raw_values(), sums)


def _fused_graph(K, p, x, k, u):
    """A graph of fusible ops with a boundary (sum) in the middle: every
    output live, nulls on x and u only."""
    c = K.add_op(K.mul_scalar_op(x, 2.0, p), K.cast_op(k, att.ArrowType.FLOAT32, p), p)
    m = K.merge_op(c, K.neg_op(c, p), K.gt_scalar_op(c, 0.0, p), p)
    s = K.sum_op(K.cast_op(k, att.ArrowType.INT64, p), p)
    q = K.div_op(u, K.bitwise_xor_op(u, K.cast_op(k, att.ArrowType.UINT16, p), p), p)
    return [c, m, s, q, K.bitwise_not_op(K.lt_op(x, c, p), p), K.min_op(x, K.sqrt_op(K.abs_op(x, p), p), p)]


@pytest.mark.parametrize("n", [0, 1, 31, 33, 8193, (1 << 20) + 17])
def test_fused_pipeline_matches_plain(cuda, n):
    """The generated kernels against the eager replay (plain versions) on the
    card: one launch of fused_pipeline for each group, the same buffers."""
    from arrow_tpu_torch.runtime import fusion

    rng = np.random.default_rng(n)
    x = att.PrimitiveArray.from_optional_slice(
        [None if v < 0.2 else float(v * 20 - 10) for v in rng.random(n)], dtype=att.ArrowType.FLOAT32, device=cuda)
    k = att.UInt32Array.from_slice(rng.integers(0, 2**32, n, dtype=np.uint32), device=cuda)
    u = att.PrimitiveArray.from_optional_slice(
        [None if v % 3 == 0 else int(v) for v in rng.integers(0, 2**16, n)], dtype=att.ArrowType.UINT16, device=cuda)
    with att.ComputePipeline(device=cuda) as p:
        got = _fused_graph(TK, p, x, k, u)
        groups = len(p.plan().groups)
        KERNELS["fused_pipeline"].launches = 0
    assert groups == 2 and KERNELS["fused_pipeline"].launches == (groups if n else 0)
    with plain_versions(), att.ComputePipeline(device=cuda) as p:
        want = _fused_graph(TK, p, x, k, u)
    for g, w in zip(got, want):
        assert g.data.is_cuda
        _same(g.bound(), w.bound())
    assert fusion.plan.cache_info().hits >= 1


# ------------------------------------------------- the probe tools' kernels


PROBE_LABELS = [p.label for p in MP.PROBES] + [p.label for p in PR.KERNELS]


def _probe(label):
    return MP.BY_LABEL.get(label) or PR.BY_NAME[label]


@pytest.mark.parametrize("label", PROBE_LABELS)
def test_probe_kernel_matches_plain(cuda, label):
    """Each probe kernel on the JAX probe's inputs: one launch, equal to its
    plain version on the card and to the JAX probe's oracle."""
    probe = _probe(label)
    args = MP.inputs_on(probe, cuda)
    before = probe.kernel.launches
    got = MP.launch(probe, *args)
    torch.cuda.synchronize()
    assert probe.kernel.launches == before + 1
    want = MP.plain(probe, *args)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    if probe.oracle is not None:
        np.testing.assert_array_equal(MP.as_numpy(got), probe.oracle(*probe.inputs()))


# float32 bit patterns the bitcast must keep: NaNs with payloads (quiet and
# signalling, both signs), +-0, +-inf, subnormals at both ends, +-1
FLOAT_SPECIALS = np.array([0x7FC00001, 0x7F800001, 0xFFC12345, 0xFFBFFFFF, 0x00000000, 0x80000000, 0x7F800000,
                           0xFF800000, 0x00000001, 0x807FFFFF, 0x3F800000, 0xBF800000], np.uint32).view(np.int32)


def _bitcast_tile(rng):
    """An (8, 128) float32 tile of full-range bit patterns with every one
    of FLOAT_SPECIALS in it."""
    bits = rng.integers(-2 ** 31, 2 ** 31, (8, 128)).astype(np.int32)
    bits.reshape(-1)[rng.permutation(bits.size)[:len(FLOAT_SPECIALS)]] = FLOAT_SPECIALS
    return bits.view(np.float32)


def _random_inputs(label, rng):
    """Inputs of the probe's shapes drawn at random: full-range values, ties,
    negative and zero entries."""
    i32 = lambda lo, hi, shape: rng.integers(lo, hi, shape).astype(np.int32)  # noqa: E731
    if label in ("mb_step_rollpair", "mb_step_taa"):  # keys with many ties
        return np.full((1,), 5, np.int32), i32(0, 100, (64, 128)), i32(0, 100, (64, 128))
    return {
        "bitcast_f32_u32": lambda: (_bitcast_tile(rng),),
        "lax_sort_in_kernel": lambda: (i32(-2 ** 31, 2 ** 31, (8, 128)),),
        "matmul_int8_s32acc": lambda: (i32(-128, 128, (128, 128)).astype(np.int8),
                                       i32(-128, 128, (128, 128)).astype(np.int8)),
        "i1_to_bf16_astype": lambda: (i32(-3, 3, (128, 128)),),
        "u32_shifts_popcount": lambda: (i32(-2 ** 31, 2 ** 31, (8, 128)),),
        "cumsum_sublanes_f32": lambda: (rng.standard_normal((64, 128)).astype(np.float32),),
        "cumsum_lanes_i32": lambda: (i32(-2 ** 20, 2 ** 20, (8, 128)),),
        "gather_lanes_taa_8x128_i32": lambda: (i32(-2 ** 31, 2 ** 31, (8, 128)), i32(0, 128, (8, 128))),
        "gather_lanes_256wide_2gathers": lambda: (i32(-2 ** 31, 2 ** 31, (8, 256)), i32(0, 256, (8, 128))),
        "gather_sublanes_taa_axis0": lambda: (i32(-2 ** 31, 2 ** 31, (64, 128)), i32(0, 64, (64, 128))),
        "pltpu_roll_dynamic": lambda: (np.full((1,), 131, np.int32), i32(-2 ** 31, 2 ** 31, (8, 128))),
        "cmp_to_bf16_vector": lambda: (i32(-2 ** 31, 2 ** 31, (32, 128)),),
        "transpose_32b_128x128": lambda: (i32(-2 ** 31, 2 ** 31, (128, 128)),),
        "hbm_to_hbm_dma": lambda: (i32(-2 ** 31, 2 ** 31, (64, 128)),),
        "dynamic_slice_vmem_rows": lambda: (np.full((1,), 56, np.int32), i32(-2 ** 31, 2 ** 31, (64, 128))),
        "dma_unaligned_row_write": lambda: (np.full((1,), 0, np.int32), i32(-2 ** 31, 2 ** 31, (8, 128))),
        "dma_unaligned_row_offset": lambda: (np.full((1,), 37, np.int32), i32(-2 ** 31, 2 ** 31, (64, 128))),
        "prefetch_scalar_grid": lambda: (np.full((1,), 2 ** 31 - 7, np.int32), i32(-2 ** 31, 2 ** 31, (16, 128))),
    }[label]()


RANDOM_LABELS = ["mb_step_rollpair", "mb_step_taa", "lax_sort_in_kernel", "matmul_int8_s32acc",
                 "i1_to_bf16_astype", "u32_shifts_popcount", "cumsum_sublanes_f32", "cumsum_lanes_i32",
                 "gather_lanes_taa_8x128_i32", "gather_lanes_256wide_2gathers", "gather_sublanes_taa_axis0",
                 "pltpu_roll_dynamic", "cmp_to_bf16_vector", "transpose_32b_128x128", "dynamic_slice_vmem_rows",
                 "dma_unaligned_row_write", "dma_unaligned_row_offset", "prefetch_scalar_grid", "hbm_to_hbm_dma",
                 "bitcast_f32_u32"]


@pytest.mark.parametrize("label", RANDOM_LABELS)
def test_probe_kernel_matches_plain_on_random_inputs(cuda, label):
    probe = _probe(label)
    host = _random_inputs(label, np.random.default_rng(13))
    args = [torch.from_numpy(a).to(cuda) for a in host]
    got = MP.launch(probe, *args)
    want = MP.plain(probe, *args)
    assert torch.equal(got, want)
    if label == "bitcast_f32_u32":  # every bit, against the host's
        tile = host[0].view(np.int32)
        assert set(FLOAT_SPECIALS) <= set(tile.reshape(-1).tolist())
        np.testing.assert_array_equal(got.cpu().numpy(), tile)


CUMSUM_TILES = {"ones": lambda: MP.BY_LABEL["cumsum_sublanes_f32"].inputs()[0],
                "normals": lambda: np.random.default_rng(13).standard_normal((64, 128)).astype(np.float32),
                "ordered": PD.ordered_tile}


@pytest.mark.parametrize("tile", CUMSUM_TILES)
def test_cumsum_sublanes_f32_keeps_the_row_order_bit_for_bit(cuda, tile):
    """The column cumsum against the plain version's row order (_scan) on
    the card, bit for bit (NaNs and signed zeros too), on the probe's ones,
    on normals and on the order-sensitive tile (+-1e8 beside values near 1,
    then +-inf and NaN in every column), and against the host's _scan
    wherever that is not NaN (the host's NaN bits are its own)."""
    host = CUMSUM_TILES[tile]()
    x = torch.from_numpy(host).to(cuda)
    probe = MP.BY_LABEL["cumsum_sublanes_f32"]
    got = MP.launch(probe, x)
    assert PD.same_bits(got, MP.plain(probe, x))
    want = MP._scan(torch.from_numpy(host), 0)
    nan = want.isnan()
    assert torch.equal(got.cpu().isnan(), nan)
    assert torch.equal(got.cpu()[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("tile", [0, 1])
def test_i1_to_bf16_astype_at_every_row_count(cuda, tile):
    """The mask matmul on tiles whose rows have every count of positive
    entries from 0 to 128 (0, -1, INT_MIN, 1 and INT_MAX among them): equal
    to mask_matmul_plain on the card and to each row's count in every
    column."""
    host = PD.count_tiles()[tile]
    x = torch.from_numpy(host).to(cuda)
    probe = PR.BY_NAME["i1_to_bf16_astype"]
    got = MP.launch(probe, x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, MP.plain(probe, x))
    counts = torch.from_numpy((host > 0).sum(1)).float()
    assert torch.equal(got.cpu().float(), counts[:, None].expand(128, 128))


@functools.lru_cache(maxsize=None)
def _design_libs():
    """The sublane gather's, the sized copy's, the in-row sort's, the lane
    cumsum's, the lane gather's, the roll's, the scalar loop's, the compare
    cast's and the u32 shifts' other designs, built once."""
    return PD.build(("direct", "count_first", "eight_a_lane", "warp_blocks", "row_staged", "roll_staged",
                     "lane_sum", "eight_a_thread", "two_words"))[0]


@pytest.mark.parametrize("label,design", [*[("gather_sublanes_taa_axis0", d) for d in ("new", "direct")],
                                          *[("dma_dynamic_size_rows", d) for d in ("new", "count_first")]])
def test_gather_and_sized_copy_on_their_held_inputs(cuda, label, design):
    """The sublane gather on a full-range random tile with idx all 0, all
    63, the identity and random, and the sized copy at every s from -1 to
    65 on full-range random rows: the shipped kernel (one counted launch a
    call) and each other design, each equal bit for bit to the plain version
    on the card and to the JAX probe's oracle.  No index outside [0, 64) is
    launched: its trap would poison the context for the tests after it."""
    _hold_on_held_inputs(cuda, label, design, 4 if label == "gather_sublanes_taa_axis0" else len(PD.SIZED_HELD))


def _hold_on_held_inputs(cuda, label, design, extra, oracle_cases=None):
    """The probe's kernel ("new", one counted launch a call) or its other
    design on the probe's inputs and the `extra` cases of held_inputs, each
    equal bit for bit to the plain version on the card (NaN payloads and
    signed zeros too) and to the JAX probe's oracle (on the first
    `oracle_cases` cases where given: an oracle of the probe's input
    alone; a bf16 output as float32, as the oracle gives it)."""
    probe = MP.BY_LABEL[label]
    call = (lambda *a: MP.launch(probe, *a)) if design == "new" else PD.design_entries(_design_libs(), label)[design]
    cases = list(PD.held_inputs(probe, cuda))
    assert len(cases) == 1 + extra
    before = probe.kernel.launches
    for i, args in enumerate(cases):
        got = call(*args)
        assert PD.same_bits(got, MP.plain(probe, *args)), [a.flatten()[:4].tolist() for a in args]
        if oracle_cases is None or i < oracle_cases:
            host = [a.cpu().numpy() for a in args]
            np.testing.assert_array_equal(MP.as_numpy(got), probe.oracle(*host))
    assert probe.kernel.launches == before + (len(cases) if design == "new" else 0)


@pytest.mark.parametrize("label,design", [("dynamic_store_vmem_rows", "new"), ("lax_sort_in_kernel", "new"),
                                          ("lax_sort_in_kernel", "eight_a_lane")])
def test_store_and_sort_on_their_held_inputs(cuda, label, design):
    """The row store at every s in [0, 56] on full-range random rows, and
    the in-row sort on each of ``sort_tiles`` (full range with INT_MIN and
    INT_MAX in every row, all equal, ascending, descending, 4 values,
    bitonic rows): the shipped kernel (one counted launch a call) and the
    sort's eight_a_lane design, each equal bit for bit to the plain version
    on the card and to the JAX probe's oracle (np.sort for the sort).  No s
    outside [0, 56] is launched: its trap would poison the context for the
    tests after it."""
    _hold_on_held_inputs(cuda, label, design, 57 if label == "dynamic_store_vmem_rows" else len(PD.sort_tiles()))


@pytest.mark.parametrize("label,design", [(label, design) for label in ("cumsum_lanes_i32", *PD.GATHER_LANES)
                                          for design in ("new", *PD.TURNS[label][1:])])
def test_lane_cumsum_and_gathers_on_their_held_inputs(cuda, label, design):
    """The lane cumsum on a full-range random tile, where the int32 sum
    wraps, and on the 16 one-hot tiles, and each lane gather on a full-range
    x (-0 and a signalling NaN in every row of the float32 one) with idx all
    0, all W - 1, the identity, the reversal, the upper half at W = 256 and
    random: the shipped kernel (one counted launch a call) and its other
    design (warp_blocks, row_staged), each equal bit for bit to the plain
    version on the card and to the JAX probe's oracle.  No
    index outside [0, W) is launched here: its trap would poison the
    context for the tests after it (a child process launches one below)."""
    probe = MP.BY_LABEL[label]
    extra = 1 + len(PD.one_hot_tiles()) if label == "cumsum_lanes_i32" else len(
        PD.lane_indices(len(probe.inputs()[1]), probe.inputs()[0].shape[1]))
    _hold_on_held_inputs(cuda, label, design, extra)


@pytest.mark.parametrize("label,design", [(label, design) for label in (*PD.ROLLS, "smem_scratch_scalar_loop")
                                          for design in ("new", *PD.TURNS[label][1:])])
def test_roll_and_scalar_loop_on_their_held_inputs(cuda, label, design):
    """The static roll on a full-range random tile and the 16 one-hot tiles,
    the dynamic roll on a full-range random tile at every shift of
    ROLL_SHIFTS (every (q, m), both signs, INT_MIN and INT_MAX) and on the
    one-hot tiles at each of ROLL_ONE_HOT_SHIFTS, and the scalar loop on a
    full-range tile whose column-0 sum wraps and on noise beside column 0:
    the shipped kernel (one counted launch a call) and its other design
    (roll_staged, lane_sum), each equal bit for bit to the plain version on
    the card; the rolls to np.roll (their oracle) on every input, the scalar
    loop to its oracle (3584) on the probe's arange."""
    if label == "smem_scratch_scalar_loop":
        _hold_on_held_inputs(cuda, label, design, len(PD.scalar_tiles()), oracle_cases=1)
        return
    tiles = len(PD.one_hot_tiles())
    extra = (len(PD.ROLL_SHIFTS) + len(PD.ROLL_ONE_HOT_SHIFTS) * tiles if label == "pltpu_roll_dynamic"
             else 1 + tiles)
    _hold_on_held_inputs(cuda, label, design, extra)


@pytest.mark.parametrize("label,design", [(label, design) for label in (*PD.COMPARES, "u32_shifts_popcount")
                                          for design in ("new", *PD.TURNS[label][1:])])
def test_compare_casts_and_shifts_on_their_held_inputs(cuda, label, design):
    """The compare casts on a full-range random tile and on the 4 boundary
    tiles (51 and INT_MAX at one position of every 16-byte word, 50,
    INT_MIN, -51 and 49 at the others), and the u32 shifts on a full-range
    random tile and on 0xFFFFFFFF, 0x80000000 and 0xE0000000 at each
    position of a word: the shipped kernel (one counted launch a call) and
    its other design (eight_a_thread, two_words), each equal bit for bit to
    the plain version on the card (the bf16 output as its bits) and to the
    JAX probe's oracle on every input."""
    tiles = PD.compare_tiles() if label in PD.COMPARES else PD.shift_tiles()
    _hold_on_held_inputs(cuda, label, design, len(tiles))


# a child process: a lane gather in range, then one with an index of W, whose trap it reads at the synchronize
TRAP_CHILD = """
import os, sys, torch
from arrow_tpu_torch.tools import mosaic_probe as MP
probe = MP.BY_LABEL[sys.argv[1]]
x, idx = MP.inputs_on(probe, "cuda")
assert torch.equal(MP.launch(probe, x, idx), MP.plain(probe, x, idx))
torch.cuda.synchronize()
idx[3, 5] = x.shape[1]
MP.launch(probe, x, idx)
try:
    torch.cuda.synchronize()
except Exception as e:  # the trap's launch error
    print("launch error:", type(e).__name__, str(e).splitlines()[0], flush=True)
    os._exit(3)
print("no error", flush=True)
os._exit(0)
"""


@pytest.mark.parametrize("label", ["gather_lanes_taa_8x128_i32", "gather_lanes_256wide_2gathers"])
def test_lane_gather_traps_on_an_index_past_its_row(cuda, label):
    """An index of W (128, or 256 for the 256-wide row) makes the lane
    gather trap rather than read outside the row: launched in a child
    process, where the trap cannot poison this process's context, after a
    launch in range that matches the plain version; the child finds the
    launch error at its synchronize."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", TRAP_CHILD, label], cwd=repo, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 3 and "launch error:" in proc.stdout, (proc.returncode, proc.stdout[-2000:],
                                                                     proc.stderr[-2000:])


@pytest.mark.parametrize("keys", ["full range", "ends"])
@pytest.mark.parametrize("name", PR.MERGE_STEPS)
def test_merge_step_matches_plain_on_full_range_keys(cuda, name, keys):
    """Beside the ties case: full-range random keys, and all INT_MIN against
    all INT_MAX, at R = 5, one block and one block an SM."""
    probe = PR.BY_NAME[name]
    rng = np.random.default_rng(18)
    if keys == "full range":
        a, b = (rng.integers(-2 ** 31, 2 ** 31, (64, 128)).astype(np.int32) for _ in "ab")
    else:
        a, b = np.full((64, 128), -2 ** 31, np.int32), np.full((64, 128), 2 ** 31 - 1, np.int32)
    args = [torch.from_numpy(x).to(cuda) for x in (np.full((1,), 5, np.int32), a, b)]
    want = MP.plain(probe, *args)
    assert torch.equal(MP.launch(probe, *args), want)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert torch.equal(MP.launch(probe, *args, blocks=sms), want.expand(sms, *want.shape))


# the int8 product's cases: the identity on either side (a descriptor or
# layout fault shows as the rows and columns it moves), the extremes (-128 @
# -128 is 2 097 152 in every cell), and the full int8 range from three seeds
INT8_CASES = ["A = I", "B = I", "-128 @ -128", "-128 @ 127", "seed 21", "seed 22", "seed 23"]


def _int8_case(case):
    rng = np.random.default_rng(int(case.split()[-1]) if case.startswith("seed") else 7)
    full = lambda: rng.integers(-128, 128, (128, 128)).astype(np.int8)  # noqa: E731
    eye = np.eye(128, dtype=np.int8)
    return {
        "A = I": lambda: (eye, full()),
        "B = I": lambda: (full(), eye),
        "-128 @ -128": lambda: (np.full((128, 128), -128, np.int8),) * 2,
        "-128 @ 127": lambda: (np.full((128, 128), -128, np.int8), np.full((128, 128), 127, np.int8)),
    }.get(case, lambda: (full(), full()))()


@pytest.mark.parametrize("case", INT8_CASES)
def test_matmul_int8_s32acc_cases(cuda, case):
    """The wgmma product against the exact product on the host; a fault
    names its first wrong (row, column)s."""
    a, b = _int8_case(case)
    got = MP.launch(MP.BY_LABEL["matmul_int8_s32acc"], torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    got = got.cpu().numpy()
    want = a.astype(np.int64) @ b.astype(np.int64)
    wrong = np.argwhere(got != want)
    assert not len(wrong), f"{case}: {len(wrong)} wrong, first (row, column) {wrong[:8].tolist()}"
    if case == "-128 @ -128":
        assert (got == 2_097_152).all()


# the host's launch calls in a profile's trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def _traced(launch, tmp_path, file="trace.json"):
    """The events of the exported trace of one profiled `launch()` and the
    synchronize after it."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        launch()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / file))
    return json.loads((tmp_path / file).read_text())["traceEvents"]


def _one_traced_kernel(prof, tmp_path, name, what, again=None):
    """The events of `prof`'s exported trace and its one kernel event, which
    must name `name`.  Where the trace holds no kernel event at all, the
    assertion's message also carries the same profile's launch calls (name,
    correlation id, time) and its count of events by category, so that a
    lost device record can be told from a launch that never happened, and,
    where `again` is given, the kernels of one more trace of `again()` (the
    same launch): a record that came late shows there as a second kernel.
    The empty trace fails all the same."""
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    found = f"{what} kernels {[e['name'] for e in kernels]}"
    if not kernels:  # a string, so that pytest prints all of it
        launches = [(e["name"], e.get("args", {}).get("correlation"), e.get("ts")) for e in events
                    if e.get("name") in LAUNCH_CALLS]
        found += f"; launches {launches}; events by category {dict(collections.Counter(e.get('cat') for e in events))}"
        if again is not None:
            later = [(e["name"], e.get("args", {}).get("correlation")) for e in _traced(again, tmp_path, "again.json")
                     if e.get("cat") == "kernel"]
            found += f"; one more trace of the same launch holds the kernels {later}"
    assert len(kernels) == 1 and name in kernels[0]["name"], found
    return events, kernels[0]


def test_grid_1d_blockspec_is_one_launch_of_its_grid(cuda, tmp_path):
    """One call is one kernel on the card: 32 blocks (an 8-row tile each) of
    256 threads (one 16-byte load and store each), equal to x + 1."""
    probe = MP.BY_LABEL["grid_1d_blockspec"]
    (x,) = MP.inputs_on(probe, cuda)
    MP.launch(probe, x)
    torch.cuda.synchronize()
    before = probe.kernel.launches
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        got = MP.launch(probe, x)
        torch.cuda.synchronize()
    assert probe.kernel.launches == before + 1
    assert torch.equal(got, x + 1)
    _, kernel = _one_traced_kernel(prof, tmp_path, "add_one_tiles", (), again=lambda: MP.launch(probe, x))
    assert (kernel["args"]["grid"], kernel["args"]["block"]) == ([32, 1, 1], [256, 1, 1]), kernel["args"]


@pytest.mark.parametrize("s", range(64 - 8 + 1))
@pytest.mark.parametrize("label", ["dynamic_slice_vmem_rows", "dma_unaligned_row_write", "dma_unaligned_row_offset",
                                   "dynamic_store_vmem_rows"])
def test_row_window_kernel_at_every_row(cuda, label, s):
    """The row slice, the row write, the row-offset copy and the row store
    at every legal device row s, on full-range random rows: equal to the
    plain version on the card and to the JAX probe's oracle (zeros outside
    the written window)."""
    probe = MP.BY_LABEL[label]
    rows = np.random.default_rng(s).integers(-2 ** 31, 2 ** 31, probe.inputs()[1].shape, np.int32)
    at = np.full((1,), s, np.int32)
    args = [torch.from_numpy(at).to(cuda), torch.from_numpy(rows).to(cuda)]
    got = MP.launch(probe, *args)
    assert torch.equal(got, MP.plain(probe, *args))
    np.testing.assert_array_equal(got.cpu().numpy(), probe.oracle(at, rows))


def test_dma_unaligned_row_write_is_one_launch_with_no_fill(cuda, tmp_path):
    """One call is one kernel on the card, with no fill before it: 8 blocks
    of 256 threads write the whole output, the zeros too (the output's
    memory held -1s just before), equal to the plain version."""
    probe = MP.BY_LABEL["dma_unaligned_row_write"]
    args = MP.inputs_on(probe, cuda)
    MP.launch(probe, *args)
    torch.cuda.synchronize()
    before = probe.kernel.launches
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    junk = torch.full((1, *probe.shape), -1, dtype=probe.dtype, device=cuda)
    junk_ptr = junk.data_ptr()
    del junk
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        got = MP.launch(probe, *args)
        torch.cuda.synchronize()
    assert probe.kernel.launches == before + 1
    assert got.data_ptr() == junk_ptr  # the same memory, so the zeros are the kernel's
    assert torch.equal(got, MP.plain(probe, *args))
    _, kernel = _one_traced_kernel(prof, tmp_path, "write_rows", (), again=lambda: MP.launch(probe, *args))
    assert (kernel["args"]["grid"], kernel["args"]["block"]) == ([8, 1, 1], [256, 1, 1]), kernel["args"]


# the kernel that one call of each probe launches: (name, grid, block)
ONE_KERNEL = {"dma_unaligned_row_offset": ("slice_every_row", [8, 1, 1], [256, 1, 1]),
              "prefetch_scalar_grid": ("add_scalar_tiles", [2, 1, 1], [256, 1, 1]),
              "transpose_32b_128x128": ("transpose_tile", [4, 4, 1], [256, 1, 1]),
              "hbm_to_hbm_dma": ("copy_rows_direct", [1, 1, 1], [256, 1, 1]),
              "bitcast_f32_u32": ("copy_rows_direct", [1, 1, 1], [256, 1, 1]),
              "mb_step_rollpair": ("merge_step", [1, 1, 1], [256, 1, 1]),
              "mb_step_taa": ("merge_step", [1, 1, 1], [256, 1, 1]),
              "cumsum_sublanes_f32": ("cumsum_rows", [4, 1, 1], [32, 1, 1]),
              "i1_to_bf16_astype": ("mask_matmul", [8, 1, 1], [256, 1, 1]),
              "gather_sublanes_taa_axis0": ("gather_stripe", [8, 1, 1], [256, 1, 1]),
              "dma_dynamic_size_rows": ("copy_rows_sized", [8, 1, 1], [256, 1, 1]),
              "dynamic_store_vmem_rows": ("write_rows", [8, 1, 1], [256, 1, 1]),
              "lax_sort_in_kernel": ("sort_rows", [8, 1, 1], [32, 1, 1]),
              "cumsum_lanes_i32": ("cumsum_lanes", [1, 1, 1], [256, 1, 1]),
              "gather_lanes_taa_8x128_i32": ("gather_lanes", [8, 1, 1], [32, 1, 1]),
              "gather_lanes_f32": ("gather_lanes", [8, 1, 1], [32, 1, 1]),
              "gather_lanes_256wide_2gathers": ("gather_lanes", [8, 1, 1], [32, 1, 1]),
              "gather_lanes_taa_256x128_i32": ("gather_lanes", [32, 1, 1], [256, 1, 1]),
              "pltpu_roll_static": ("roll_lanes", [1, 1, 1], [256, 1, 1]),
              "pltpu_roll_dynamic": ("roll_lanes", [1, 1, 1], [256, 1, 1]),
              "smem_scratch_scalar_loop": ("scalar_loop_fill", [1, 1, 1], [256, 1, 1]),
              "cmp_to_bf16_vector": ("greater_to", [4, 1, 1], [256, 1, 1]),
              "cmp_to_int8_vector": ("greater_to", [4, 1, 1], [256, 1, 1]),
              "u32_shifts_popcount": ("shifts_popcount", [1, 1, 1], [256, 1, 1])}


@pytest.mark.parametrize("label", ONE_KERNEL)
def test_scalar_probe_is_one_launch_of_one_kernel(cuda, tmp_path, label):
    """One call of the row-offset copy, the scalar add, the transpose, the
    HBM-to-HBM copy, the bitcast, a merge step, the column cumsum, the mask
    matmul, the sublane gather, the sized copy, the row store (P4's
    write_rows), the in-row sort, the lane cumsum, a lane gather, a roll,
    the scalar loop, a compare cast or the u32 shifts is one counted launch
    and exactly one kernel on the card, with its name, grid and block (no
    fill, no wrapper-side copy, no host read of s or R), equal to the plain
    version."""
    probe = _probe(label)
    args = MP.inputs_on(probe, cuda)
    MP.launch(probe, *args)
    torch.cuda.synchronize()
    before = probe.kernel.launches
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        got = MP.launch(probe, *args)
        torch.cuda.synchronize()
    assert probe.kernel.launches == before + 1
    assert torch.equal(got, MP.plain(probe, *args))
    name, grid, block = ONE_KERNEL[label]
    events, kernel = _one_traced_kernel(prof, tmp_path, name, (), again=lambda: MP.launch(probe, *args))
    copies = [e["name"] for e in events if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    assert not copies, copies
    assert (kernel["args"]["grid"], kernel["args"]["block"]) == (grid, block), kernel["args"]


def test_one_kernel_traces_with_the_design_libraries_loaded(cuda, tmp_path):
    """With the other designs' libraries loaded in the process and each
    launched, ten traced calls of each probe above still hold exactly its
    one kernel: loading more kernel libraries adds nothing to a trace."""
    libs = _design_libs()
    for label in ("gather_sublanes_taa_axis0", "dma_dynamic_size_rows", "lax_sort_in_kernel", "cumsum_lanes_i32",
                  *PD.GATHER_LANES, *PD.ROLLS, "smem_scratch_scalar_loop", *PD.COMPARES, "u32_shifts_popcount"):
        args = MP.inputs_on(MP.BY_LABEL[label], cuda)
        for call in PD.design_entries(libs, label).values():
            call(*args)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (name, _, _) in ONE_KERNEL.items():
        probe = _probe(label)
        args = MP.inputs_on(probe, cuda)
        for round_ in range(10):
            with torch.profiler.profile(activities=activities) as prof:
                MP.launch(probe, *args)
                torch.cuda.synchronize()
            _one_traced_kernel(prof, tmp_path, name, (label, round_), again=lambda: MP.launch(probe, *args))


@pytest.mark.parametrize("name", PR.MERGE_STEPS)
def test_merge_step_blocks_agree(cuda, name):
    """One block an SM: every block's slice equals the one-block output."""
    probe = PR.BY_NAME[name]
    args = MP.inputs_on(probe, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    many = MP.launch(probe, *args, blocks=sms)
    assert many.shape == (sms, PR.TR, PR.LANES)
    assert torch.equal(many, MP.launch(probe, *args).expand_as(many))


def test_queued_seconds_per_call(cuda):
    """Calls queued behind the spin take their device time, here a spin of
    known length; a call that reads the device on the host has none."""
    from arrow_tpu_torch.utils import timing

    cycles = 2_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    s = timing.queued_seconds_per_call(lambda: torch.cuda._sleep(cycles), calls=8)
    assert s == pytest.approx(start.elapsed_time(end) / 1e3, rel=0.2)
    x = torch.ones(4, device=cuda)
    assert timing.queued_seconds_per_call(lambda: (x + 1).sum().item(), calls=4) is None
