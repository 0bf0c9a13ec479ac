"""Logical ops of arrow_tpu_torch against arrow_tpu.kernels: bitwise
and/or/xor/not over every integer dtype and packed booleans, shl/shr with
amounts at and past the width (they wrap at 32, or at 64 for 64-bit types),
and the any_/all_ host reductions; with and without nulls; exact."""

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import kernels as JK
from arrow_tpu_torch import kernels as TK
from torch_helpers import ELEMENTWISE_N as N
from torch_helpers import assert_same, edge_values, make_pair

INTS = ["uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32", "int64"]
BINARY = ["bitwise_and", "bitwise_or", "bitwise_xor"]


def _pair(name, rng, nulls, p=0.8):
    return make_pair(name, edge_values(name, N, rng), rng.random(N) < p if nulls else None)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", INTS + ["bool"])
@pytest.mark.parametrize("op", BINARY)
def test_binary_matches_jax(op, name, nulls):
    rng = np.random.default_rng([BINARY.index(op), (INTS + ["bool"]).index(name), int(nulls)])
    (ja, ta), (jb, tb) = _pair(name, rng, nulls), _pair(name, rng, nulls, 0.6)
    assert_same(getattr(JK, op)(ja, jb), getattr(TK, op)(ta, tb))


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", INTS + ["bool"])
def test_not_matches_jax(name, nulls):
    rng = np.random.default_rng([5, (INTS + ["bool"]).index(name), int(nulls)])
    ja, ta = _pair(name, rng, nulls)
    assert_same(JK.bitwise_not(ja), TK.bitwise_not(ta))
    assert_same(JK.not_(ja), TK.not_(ta))


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", INTS)
@pytest.mark.parametrize("op", ["bitwise_shl", "bitwise_shr"])
def test_shift_matches_jax(op, name, nulls):
    rng = np.random.default_rng([6 + (op == "bitwise_shr"), INTS.index(name), int(nulls)])
    ja, ta = _pair(name, rng, nulls)
    amounts = rng.integers(0, 70, N).astype(np.uint32)
    amounts[:10] = [0, 1, 7, 8, 15, 16, 31, 32, 63, 64]
    amounts[10:14] = [65, 100, 2**31 + 3, 2**32 - 1]
    jm, tm = make_pair("uint32", amounts, rng.random(N) < 0.9 if nulls else None)
    assert_same(getattr(JK, op)(ja, jm), getattr(TK, op)(ta, tm))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 300])
def test_any_all_match_jax(n):
    rng = np.random.default_rng(n)
    for vals in (np.zeros(n, bool), np.ones(n, bool), rng.random(n) < 0.5, np.arange(n) == n - 1):
        for valid in (None, rng.random(n) < 0.5):
            ja, ta = make_pair("bool", vals, valid)
            assert (JK.any_(ja), JK.all_(ja)) == (TK.any_(ta), TK.all_(ta))
            assert isinstance(TK.any_(ta), bool) and isinstance(TK.all_(ta), bool)


def test_refusals():
    i32 = att.Int32Array.from_slice([1, 2], device="cpu")
    f32 = att.Float32Array.from_slice([1.0, 2.0], device="cpu")
    with pytest.raises(att.OperationNotSupported):
        TK.bitwise_and(i32, att.Int64Array.from_slice([1, 2], device="cpu"))
    with pytest.raises(att.OperationNotSupported):
        TK.bitwise_or(f32, f32)
    with pytest.raises(att.OperationNotSupported):
        TK.bitwise_shl(i32, i32)  # amounts must be UInt32
    with pytest.raises(att.OperationNotSupported):
        TK.any_(i32)
    assert TK.and_ is TK.bitwise_and and TK.xor is TK.bitwise_xor
    assert JK.any_(at.BooleanArray.from_slice([False, True])) is TK.any_(
        att.BooleanArray.from_slice([False, True], device="cpu"))
