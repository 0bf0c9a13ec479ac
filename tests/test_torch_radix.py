"""Kernel B3/B4's plain version (arrow_tpu_torch ``radix_sort_plain``) at
digit widths 1, 2 and 8, and the port's radix sort route, against
arrow_tpu's ``sort_by_key(method="radix")``, whose Pallas chain runs
interpreted here as ``tests/test_radix_sort.py`` runs it: N = 8192, a full
buffer, narrow key domains.  Exact."""

import functools

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute.sort import sort_by_key as jax_sort_by_key
from arrow_tpu_torch import compute as TC
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
}


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


@pytest.mark.parametrize("case", list(CASES))
def test_port_radix_route_matches_jax_radix_route(case):
    keys, payload = _arrays(case)
    want_k, want_p = _jax_radix(case)
    got_k, got_p = TC.sort_by_key(jax_to_torch(keys), jax_to_torch(payload), method="radix")
    assert_same(want_k, got_k)
    assert_same(want_p, got_p)


def test_two_bit_chain_matches_jax_radix_r4(monkeypatch):
    keys, payload = _arrays("u32")
    want_k, want_p = _jax_radix("u32", "4")
    monkeypatch.setenv("ARROW_TPU_RADIX_R", "4")
    assert R.chain_digit_bits() == 2
    got_k, got_p = TC.sort_by_key(jax_to_torch(keys), jax_to_torch(payload), method="radix")
    assert_same(want_k, got_k)
    assert_same(want_p, got_p)


@pytest.mark.parametrize("digit_bits", WIDTHS)
def test_only_significant_digits_and_given_bits(digit_bits):
    rng = np.random.default_rng(digit_bits)
    key = torch.from_numpy((rng.integers(0, 4, 5000) << 20).astype(np.int32) | 0x7)
    assert R.significant_mask_plain(key, 5000) == 3 << 20
    assert R._shifts(3 << 20, 32, digit_bits) == {1: [20, 21], 2: [20], 8: [16]}[digit_bits]
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
