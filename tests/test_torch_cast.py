"""Casts of arrow_tpu_torch against arrow_tpu.kernels: every supported
(source, target) pair of the numeric closure plus bool -> numeric, with
nulls, over edge values (NaN, +-inf, huge and negative floats against the
saturating float -> int rule; 64-bit integers that round when they become
floats; unsigned values above the signed maximum); every same-width bitcast;
the refusals; exact (a NaN matches any NaN)."""

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import kernels as JK
from arrow_tpu_torch import kernels as TK
from torch_helpers import ELEMENTWISE_N as N
from torch_helpers import NUMERIC, edge_values, make_pair
from torch_helpers import assert_same as _assert_same

PAIRS = [(s, d) for s in NUMERIC + ["bool"] for d in NUMERIC if s != d]
BITCASTS = [(s, d) for group in (["uint8", "int8"], ["uint16", "int16"],
                                 ["uint32", "int32", "float32", "date32"], ["uint64", "int64", "float64"])
            for s in group for d in group if s != d]


def assert_same(jarr, tarr):
    _assert_same(jarr, tarr, nan_bits=False)


def _source(name, rng):
    v = edge_values(name, N, rng)
    if name.startswith("float"):  # values around the targets' bounds and fractions
        v[20:32] = [255.9, 256.0, 300.7, -3.5, -0.9, 65535.5, 2**31 - 0.5, 2**31, 4294967295.5,
                    4294967296.0, -(2**31) - 1.0, 1e20]
    elif name in ("int64", "uint64"):  # 64-bit values that round when they become floats
        v[20:24] = np.array([2**60 + 2**36 + 1, (1 << 62) + (1 << 38) + (1 << 37) + 1,
                             2**53 + 1, 2**54 + 3], v.dtype)
        if name == "uint64":
            v[24:27] = np.array([2**64 - 1, 2**63 + 2**39 + 1, 2**63 + 2**40 - 1], v.dtype)
    return v


@pytest.mark.parametrize("src,dst", PAIRS)
def test_cast_matches_jax(src, dst):
    rng = np.random.default_rng([NUMERIC.index(dst), (NUMERIC + ["bool"]).index(src)])
    ja, ta = make_pair(src, _source(src, rng), rng.random(N) < 0.8)
    to = att.ArrowType(dst)
    assert_same(JK.cast(ja, at.ArrowType(dst)), TK.cast(ta, to))
    assert_same(JK.cast_dyn(ja, at.ArrowType(dst)), TK.cast_dyn(ta, att.DataType(to)))


@pytest.mark.parametrize("src", NUMERIC + ["bool"])
def test_cast_without_nulls_and_to_itself(src):
    rng = np.random.default_rng(50 + (NUMERIC + ["bool"]).index(src))
    ja, ta = make_pair(src, _source(src, rng))
    dst = "float32" if src != "float32" else "int32"
    assert_same(JK.cast(ja, at.ArrowType(dst)), TK.cast(ta, att.ArrowType(dst)))
    if src != "bool":
        assert_same(JK.cast(ja, at.ArrowType(src)), TK.cast(ta, att.ArrowType(src)))


@pytest.mark.parametrize("src,dst", BITCASTS)
def test_bitcast_matches_jax(src, dst):
    rng = np.random.default_rng(NUMERIC.index(src) * 16 + NUMERIC.index(dst))
    ja, ta = make_pair(src, _source(src, rng), rng.random(N) < 0.8)
    _assert_same(JK.bitcast(ja, at.ArrowType(dst)), TK.bitcast(ta, att.ArrowType(dst)))  # NaN bits too


def test_refusals():
    i32 = att.Int32Array.from_slice([1, 2], device="cpu")
    with pytest.raises(att.CastingNotSupported):
        TK.cast(i32, att.ArrowType.BOOL)
    with pytest.raises(att.CastingNotSupported):
        TK.bitcast(i32, att.ArrowType.INT64)
    with pytest.raises(att.CastingNotSupported):
        TK.bitcast(att.BooleanArray.from_slice([True], device="cpu"), att.ArrowType.INT32)
