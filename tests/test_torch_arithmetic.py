"""Arithmetic ops of arrow_tpu_torch against arrow_tpu.kernels: add, sub, mul,
div and rem in array and scalar forms, neg, the _dyn routing, over every
numeric dtype with and without nulls; exact (floats bit for bit, NaN equal).

Edge inputs: zero divisors, INT_MIN / -1, +-inf, NaN, +-0, unsigned values
above the signed maximum, empty and 1-row arrays.  The JAX package divides
integers through float32 (8-32 bits) or float64 (64 bits), which is exact
only for dividends and divisors below 2^24 or 2^53 in magnitude: div's
operands at those widths are drawn there (plus unsigned dividends past the
signed maximum over powers of two, which divide exactly), and
test_div_is_exact pins the port's exact quotients at every width against
Python integers."""

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import kernels as JK
from arrow_tpu_torch import kernels as TK
from torch_helpers import ELEMENTWISE_N as N
from torch_helpers import NUMERIC, edge_values, make_pair, storage_numpy
from torch_helpers import assert_same as _assert_same

OPS = ["add", "sub", "mul", "div", "rem"]
SIGNED = ["float32", "float64", "int8", "int16", "int32", "int64"]


def assert_same(jarr, tarr):
    """Exact; a NaN result matches any NaN (torch's and XLA's NaN payloads differ)."""
    _assert_same(jarr, tarr, nan_bits=False)


def _float_exact_limit(name):
    """The magnitude below which the JAX package's integer div is exact
    (None: exact over the whole type)."""
    bits = np.dtype(storage_numpy(name)).itemsize * 8
    return {32: 2**24, 64: 2**53}.get(bits)


def _operands(op, name, rng):
    x, y = edge_values(name, N, rng), edge_values(name, N, rng)
    y = np.roll(y, 5)  # pair every edge with every other kind of value
    if name.startswith("float"):
        return x, y
    info = np.iinfo(storage_numpy(name))
    lim = _float_exact_limit(name) if op == "div" else None
    if lim is not None:
        lo = max(info.min, -lim + 1)
        x = rng.integers(lo, lim, N).astype(x.dtype)
        y = rng.integers(lo, lim, N).astype(x.dtype)
        y[::9] = rng.integers(1, 100, y[::9].shape[0])  # quotients of many digits
        if info.min == 0:  # above the signed maximum, over powers of two
            bits, m, u = x.dtype.itemsize * 8, x[4::13].shape[0], x.dtype.type
            high = rng.integers(0, 1 << 20, m).astype(x.dtype) << u(bits - 21)
            x[4::13] = u(1 << (bits - 1)) + high  # 21 significant bits: exact as a float
            y[4::13] = np.left_shift(1, rng.integers(0, bits - 1, m)).astype(x.dtype)
    y[::7] = 0  # x / 0 == x, x % 0 == 0
    if info.min < 0:
        x[3::11], y[3::11] = info.min, -1  # INT_MIN / -1 == INT_MIN, INT_MIN % -1 == 0
    return x, y


def _scalars(op, name):
    if name.startswith("float"):
        return [2.5, 0.0, -0.0, float("inf"), float("nan")]
    info = np.iinfo(storage_numpy(name))
    neg = [-1] if info.min < 0 else []
    if op == "div" and _float_exact_limit(name):
        # powers of two divide INT_MIN and the high unsigned rows exactly
        return [0, 1, 2, 8] + neg
    return [0, 1, 7] + neg + [int(info.max), int(info.min) if info.min < 0 else int(info.max // 2 + 1)]


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", NUMERIC)
@pytest.mark.parametrize("op", OPS)
def test_array_form_matches_jax(op, name, nulls):
    rng = np.random.default_rng([OPS.index(op), NUMERIC.index(name), int(nulls)])
    x, y = _operands(op, name, rng)
    ja, ta = make_pair(name, x, rng.random(N) < 0.8 if nulls else None)
    jb, tb = make_pair(name, y, rng.random(N) < 0.7 if nulls else None)
    assert_same(getattr(JK, op)(ja, jb), getattr(TK, op)(ta, tb))
    assert_same(getattr(JK, f"{op}_array_dyn")(ja, jb), getattr(TK, f"{op}_dyn")(ta, tb))


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", NUMERIC)
@pytest.mark.parametrize("op", OPS)
def test_scalar_form_matches_jax(op, name, nulls):
    rng = np.random.default_rng([10 + OPS.index(op), NUMERIC.index(name), int(nulls)])
    x, _ = _operands(op, name, rng)
    ja, ta = make_pair(name, x, rng.random(N) < 0.8 if nulls else None)
    for s in _scalars(op, name):
        assert_same(getattr(JK, f"{op}_scalar")(ja, s), getattr(TK, f"{op}_scalar")(ta, s))
    # a 1-row array as the scalar, routed by length either way round
    j1, t1 = make_pair(name, np.array([_scalars(op, name)[2]], x.dtype))
    assert_same(getattr(JK, f"{op}_dyn")(ja, j1), getattr(TK, f"{op}_dyn")(ta, t1))
    assert_same(getattr(JK, f"{op}_dyn")(j1, ja), getattr(TK, f"{op}_dyn")(t1, ta))


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", SIGNED)
def test_neg_matches_jax(name, nulls):
    rng = np.random.default_rng([20, SIGNED.index(name), int(nulls)])
    ja, ta = make_pair(name, edge_values(name, N, rng), rng.random(N) < 0.8 if nulls else None)
    assert_same(JK.neg(ja), TK.neg(ta))


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("op", OPS)
def test_empty_and_one_row(op, n):
    for name in ("float32", "uint32", "int64"):
        x, y = (np.array([v][:n], storage_numpy(name)) for v in (9, 4))
        (ja, ta), (jb, tb) = make_pair(name, x), make_pair(name, y)
        assert_same(getattr(JK, op)(ja, jb), getattr(TK, op)(ta, tb))
        assert_same(getattr(JK, f"{op}_scalar")(ja, 3), getattr(TK, f"{op}_scalar")(ta, 3))


def _wgsl_div(x, y, bits, signed):
    if y == 0:
        return x, 0
    if signed and x == -(1 << (bits - 1)) and y == -1:
        return x, 0
    q = abs(x) // abs(y) * (1 if (x < 0) == (y < 0) else -1)
    return q, x - q * y


@pytest.mark.parametrize("name", ["uint8", "int8", "uint16", "int16", "uint32", "int32", "uint64", "int64", "date32"])
def test_div_is_exact(name):
    """The port's integer div and rem against Python integers over the whole
    type, at the values where the JAX package's float division rounds."""
    rng = np.random.default_rng(7)
    npdt = storage_numpy(name)
    info = np.iinfo(npdt)
    x = rng.integers(info.min, info.max, 500, dtype=npdt, endpoint=True)
    y = rng.integers(info.min, info.max, 500, dtype=npdt, endpoint=True)
    y[::3] = rng.integers(1, 1000, y[::3].shape[0])
    y[::17] = 0
    probes = {"int64": [(2**62 + 1, 3)], "uint64": [(2**64 - 1, 3), (2**64 - 1, 2**63 + 1), (2**63, 2**63)],
              "uint32": [(2**32 - 1, 3)], "int32": [(2**31 - 1, 3), (-(2**31), -1)]}.get(name, [])
    for i, (a, b) in enumerate(probes):
        x[i], y[i] = a, b
    ta = att.PrimitiveArray.from_slice(x, dtype=att.ArrowType(name), device="cpu")
    tb = att.PrimitiveArray.from_slice(y, dtype=att.ArrowType(name), device="cpu")
    want = [_wgsl_div(int(a), int(b), info.bits, info.min < 0) for a, b in zip(x, y)]
    assert TK.div(ta, tb).values() == [q for q, _ in want]
    assert TK.rem(ta, tb).values() == [r for _, r in want]
    if name == "int64":
        assert TK.div_scalar(ta, 3).values()[0] == 1537228672809129301
    if name == "uint64":
        assert TK.div_scalar(ta, 3).values()[0] == 6148914691236517205


def test_mixed_date32_int32_and_refusals():
    ji, ti = make_pair("int32", np.array([1, 2, 3], np.int32))
    jd, td = make_pair("date32", np.array([10, 20, 30], np.int32))
    assert_same(JK.add_array_dyn(ji, jd), TK.add_array_dyn(ti, td))
    assert_same(JK.add_array_dyn(jd, ji), TK.add_array_dyn(td, ti))
    tbool = att.BooleanArray.from_slice([True], device="cpu")
    with pytest.raises(att.OperationNotSupported):
        TK.add(tbool, tbool)
    with pytest.raises(att.OperationNotSupported):
        TK.neg(att.UInt32Array.from_slice(np.array([1], np.uint32), device="cpu"))
    assert TK.add_scalar(ti, att.Scalar.of(2)).values() == JK.add_scalar(ji, at.Scalar.of(2)).values()
