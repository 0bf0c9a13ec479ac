"""Kernel B3/B4's plain version (arrow_tpu_torch ``radix_sort_plain``) at
digit widths 1, 2 and 8, and the port's radix sort route, against
arrow_tpu's ``sort_by_key(method="radix")``, whose Pallas chain runs
interpreted here as ``tests/test_radix_sort.py`` runs it: N = 8192, a full
buffer, narrow key domains.  Exact.  Also the passes' digit positions
(``_shifts``: aligned to the bits sorted by), the plain version at those
positions, and the partition group-by whose class bits straddle bit 16."""

import functools

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute.sort import sort_by_key as jax_sort_by_key
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch.compute import kernels as TCK
from arrow_tpu_torch.compute.kernels import radix as R
from arrow_tpu_torch.compute.sort import key_code
from torch_helpers import assert_same, jax_to_torch

N = 8192
WIDTHS = [1, 2, 8]
# name -> (Arrow key type, numpy keys from a seeded generator)
CASES = {
    "u32": ("uint32", lambda rng: rng.integers(0, 200, N, dtype=np.uint32)),
    "u32_high": ("uint32", lambda rng: rng.integers(2**31 - 40, 2**31 + 40, N).astype(np.uint32)),
    "i32": ("int32", lambda rng: rng.integers(-3, 3, N).astype(np.int32)),
    "u64": ("uint64", lambda rng: (rng.integers(0, 8, N, dtype=np.uint64) << np.uint64(32))
            | rng.integers(0, 16, N, dtype=np.uint64)),
    # keys whose significant bits are exactly a window that no multiple of 8 starts
    "u32_bits_12_19": ("uint32", lambda rng: (rng.integers(0, 256, N, dtype=np.uint32) << np.uint32(12))
                       | np.uint32(0x5)),
    "u32_bit_31": ("uint32", lambda rng: (rng.integers(0, 2, N, dtype=np.uint32) << np.uint32(31))
                   | np.uint32(0x70)),
    "u64_bit_63": ("uint64", lambda rng: (rng.integers(0, 2, N, dtype=np.uint64) << np.uint64(63))
                   | np.uint64(1 << 33)),
}
# case -> the significant mask of its sort code, and the 8-bit passes' shifts
WINDOWS = {"u32_bits_12_19": (0xFF000, [12]), "u32_bit_31": (1 << 31, [24]), "u64_bit_63": (1 << 63, [56])}


def _arrays(case):
    name, make = CASES[case]
    rng = np.random.default_rng(len(case))
    keys = at.PrimitiveArray.from_slice(make(rng), dtype=at.ArrowType(name))
    payload = at.UInt32Array.from_slice(np.arange(N, dtype=np.uint32))  # exposes stability
    return keys, payload


@functools.lru_cache(maxsize=None)
def _jax_radix(case, radix_r=None):
    import os

    keys, payload = _arrays(case)
    saved = os.environ.pop("ARROW_TPU_RADIX_R", None)
    if radix_r:
        os.environ["ARROW_TPU_RADIX_R"] = radix_r
    try:
        return jax_sort_by_key(keys, payload, method="radix")
    finally:
        os.environ.pop("ARROW_TPU_RADIX_R", None)
        if saved is not None:
            os.environ["ARROW_TPU_RADIX_R"] = saved


def _code(keys):
    """The unsigned-order code plane of the port's sort (int32/int64 bits)."""
    t = jax_to_torch(keys)
    return key_code(t.data, t.dtype)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("digit_bits", WIDTHS)
def test_radix_sort_plain_matches_jax_radix_chain(case, digit_bits):
    keys, payload = _arrays(case)
    want_k, want_p = _jax_radix(case)
    code, pay = _code(keys), jax_to_torch(payload).data
    got_code, got_p = R.radix_sort_plain([code, pay], 8 * code.element_size(), N, digit_bits)
    order = np.argsort(code.numpy().view(np.uint64 if code.element_size() == 8 else np.uint32), kind="stable")
    np.testing.assert_array_equal(got_code.numpy(), code.numpy()[order])
    np.testing.assert_array_equal(got_p.numpy().view(np.uint32), want_p.raw_values())
    np.testing.assert_array_equal(keys.raw_values()[got_p.numpy()], want_k.raw_values())
    if case in WINDOWS and digit_bits == 8:
        mask, shifts = WINDOWS[case]
        assert R.significant_mask_plain(code, N) == mask
        assert R._shifts(mask, 8 * code.element_size(), 8) == shifts
        R.KERNEL.passes = 0
        R.radix_sort([code, pay], 8 * code.element_size(), N, 8)
        assert R.KERNEL.passes == len(shifts)


@pytest.mark.parametrize("case", list(CASES))
def test_port_radix_route_matches_jax_radix_route(case):
    keys, payload = _arrays(case)
    want_k, want_p = _jax_radix(case)
    got_k, got_p = TC.sort_by_key(jax_to_torch(keys), jax_to_torch(payload), method="radix")
    assert_same(want_k, got_k)
    assert_same(want_p, got_p)


def test_two_bit_chain_matches_jax_radix_r4():
    """The port's 2-bit chain (B4), asked for by ``digit_bits=2``, against
    the JAX package's under its ARROW_TPU_RADIX_R=4."""
    keys, payload = _arrays("u32")
    want_k, want_p = _jax_radix("u32", "4")
    code, pay = _code(keys), jax_to_torch(payload).data
    R.KERNEL.passes = R.KERNEL_2BIT.passes = 0
    got_code, got_p = TCK.radix_sort([code, pay], 32, N, digit_bits=2)
    assert R.KERNEL_2BIT.passes == 4 and R.KERNEL.passes == 0  # keys below 256: bits 0-7, 2 a pass
    np.testing.assert_array_equal(got_p.numpy().view(np.uint32), want_p.raw_values())
    np.testing.assert_array_equal(keys.raw_values()[got_p.numpy()], want_k.raw_values())
    np.testing.assert_array_equal(got_code.numpy().view(np.uint32), want_k.raw_values())


@pytest.mark.parametrize("digit_bits", WIDTHS)
def test_only_significant_digits_and_given_bits(digit_bits):
    rng = np.random.default_rng(digit_bits)
    key = torch.from_numpy((rng.integers(0, 4, 5000) << 20).astype(np.int32) | 0x7)
    assert R.significant_mask_plain(key, 5000) == 3 << 20
    assert R._shifts(3 << 20, 32, digit_bits) == {1: [20, 21], 2: [20], 8: [20]}[digit_bits]
    rows = torch.arange(5000, dtype=torch.int32)
    got = R.radix_sort_plain([key, rows], 32, 4000, digit_bits)
    want = np.argsort(key.numpy()[:4000], kind="stable")
    np.testing.assert_array_equal(got[1].numpy()[:4000], want)
    assert not got[0][4000:].any() and not got[1][4000:].any()
    # an explicit bit list sorts by those bits only: bit 21 alone
    got = R.radix_sort_plain([key, rows], [21], None, digit_bits)
    np.testing.assert_array_equal(got[1].numpy(), np.argsort((key.numpy() >> 21) & 1, kind="stable"))


def test_radix_sort_rejects_what_it_does_not_take():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        R.radix_sort_plain([k.float()], 32)  # float key plane
    with pytest.raises(ValueError):
        R.radix_sort_plain([k, k.to(torch.int16)], 32)  # 2-byte payload
    with pytest.raises(ValueError):
        R.radix_sort_plain([k] * 9, 32)  # too many planes
    with pytest.raises(ValueError):
        R.radix_sort_plain([k], 32, None, 4)  # digit width


@pytest.mark.parametrize("mask,key_bits,digit_bits,want", [
    (0xFF000, 32, 8, [12]),                # the partition route's class bits: one pass
    (3 << 20, 32, 8, [20]),
    (1 << 31, 32, 8, [24]),                # clamped: the digit ends at the key's top bit
    (1 << 63, 64, 8, [56]),
    ((1 << 14) - 1, 32, 8, [0, 8]),        # sort_by_key's 14 bits stay two passes
    ((1 << 31) - 1, 32, 8, [0, 8, 16, 24]),
    ((1 << 3) | (1 << 17) | (1 << 30), 32, 8, [3, 17, 24]),
    (0x1FF, 32, 8, [0, 8]),
    (0, 32, 8, []),
    (0xFF000, 32, 2, [12, 14, 16, 18]),
    (1 << 31, 32, 2, [30]),
    (0b101 << 61, 64, 2, [61, 62]),        # bit 63 alone is left: clamped to 62
    (0xFF000, 32, 1, list(range(12, 20))),
    (1 << 63, 64, 1, [63]),
    ((1 << 5) | (1 << 40), 64, 1, [5, 40]),
])
def test_shifts_are_aligned_to_the_bits_sorted(mask, key_bits, digit_bits, want):
    got = R._shifts(mask, key_bits, digit_bits)
    assert got == want
    covered = 0
    for s in got:
        assert 0 <= s and s + digit_bits <= key_bits
        covered |= ((1 << digit_bits) - 1) << s
    assert covered & mask == mask


@pytest.mark.parametrize("digit_bits", WIDTHS)
@pytest.mark.parametrize("name,bits", [
    ("class bits", list(range(12, 20))), ("bit 31", [31]), ("bit 63", [63]),
    ("scattered", [3, 17, 30]), ("straddling 32", [30, 31, 32, 33]), ("none", []),
])
def test_plain_version_by_given_bits_matches_numpy(name, bits, digit_bits):
    """The plain version over windows that start at no multiple of the digit
    width: the stable order of the masked key, the zero tail, 3 planes of
    mixed widths."""
    rng = np.random.default_rng(len(name) + digit_bits)
    wide = any(b >= 32 for b in bits)
    n, live = 3000, 2777
    raw = rng.integers(0, 2**64 if wide else 2**32, n, dtype=np.uint64)
    key = torch.from_numpy(raw.view(np.int64) if wide else raw.astype(np.uint32).view(np.int32))
    rows = torch.arange(n, dtype=torch.int32)
    extra = torch.from_numpy(rng.standard_normal(n))
    got = R.radix_sort([key, rows, extra], bits, live, digit_bits)
    mask = sum(1 << b for b in bits)
    order = np.argsort(raw[:live] & np.uint64(mask), kind="stable")
    np.testing.assert_array_equal(got[1].numpy()[:live], order)
    np.testing.assert_array_equal(got[0].numpy()[:live], key.numpy()[:live][order])
    np.testing.assert_array_equal(got[2].numpy()[:live], extra.numpy()[:live][order])
    for g in got:
        assert g.shape[0] == n and not g[live:].any()


def test_all_equal_key_makes_no_pass():
    key = torch.full((500,), 0x1234567, dtype=torch.int32)
    rows = torch.arange(500, dtype=torch.int32)
    R.KERNEL.passes = 0
    got = R.radix_sort([key, rows], 32)
    assert R.KERNEL.passes == 0
    assert torch.equal(got[0], key) and torch.equal(got[1], rows)


def test_partition_route_with_class_bits_across_bit_16_matches_jax():
    """The partition group-by at a 2^18 key domain: its class bits 12-17
    straddle bit 16, and the class sort is one pass.  Against the JAX
    package through ``io`` buffers, exact, with the zero tail."""
    from arrow_tpu import compute as JC

    rng = np.random.default_rng(18)
    n = 16384
    jk = at.UInt32Array.from_slice(rng.integers(0, 1 << 18, n).astype(np.uint32))
    jv = at.Int32Array.from_slice(rng.integers(0, 200, n).astype(np.int32))
    kw = {"key_domain": (0, 1 << 18), "value_bits": 8}
    want = JC.hash_aggregate(jk, [("s", jv, "sum"), ("c", None, "count")], method="partition", **kw)
    tk, tv = jax_to_torch(jk), jax_to_torch(jv)
    R.KERNEL.passes = 0
    got = TC.hash_aggregate(tk, [("s", tv, "sum"), ("c", None, "count")], method="partition", **kw)
    assert R.KERNEL.passes == 1
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        assert_same(want[name], got[name])
