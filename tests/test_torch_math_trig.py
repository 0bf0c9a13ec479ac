"""Math and trigonometry ops of arrow_tpu_torch against arrow_tpu.kernels,
with and without nulls.  abs and sqrt are exact (a NaN matches any NaN);
exp, exp2, log, log2, cbrt, float power and the trigonometry agree to
rtol 2e-6 (float32) and 1e-14 (float64), since the two packages' math
libraries round differently; integer power (the WGSL loop: wrapping
multiplies, and the closed form of negative exponents) is exact."""

import numpy as np
import pytest

from arrow_tpu import kernels as JK
from arrow_tpu_torch import kernels as TK
from torch_helpers import ELEMENTWISE_N as N
from torch_helpers import assert_same, edge_values, make_pair

RTOL = {"float32": 2e-6, "float64": 1e-14}
FLOATS = ["float32", "float64"]
UNARY = {  # op -> dtypes the JAX package accepts
    "abs": FLOATS + ["int8", "int16", "int32", "int64"],
    "sqrt": FLOATS, "cbrt": FLOATS, "exp": FLOATS, "exp2": FLOATS, "log": FLOATS, "log2": FLOATS,
}
UNARY_CASES = [(op, name) for op, names in UNARY.items() for name in names]
TRIG_DTYPES = FLOATS + ["uint8", "uint16", "int8", "int16"]
EXACT = ("abs", "sqrt")


def _inputs(op, name, rng):
    v = edge_values(name, N, rng)
    if not name.startswith("float"):
        return v
    if op in ("exp", "exp2"):
        v[12:] = rng.uniform(-20, 20, N - 12)
    elif op in ("log", "log2"):
        v[12:] = np.abs(v[12:]) + 1e-3
        v[12:20] = [1e-30, 1e-3, 0.5, 2.0, 1024.0, 1e30, 3.0, 10.0]
    elif op in ("sin", "cos", "sinh"):
        v[12:] = rng.uniform(-10, 10, N - 12)
    elif op == "acos":
        v[12:] = rng.uniform(-1.2, 1.2, N - 12)
    return v


def _check(jout, tout, op, name):
    if op in EXACT or not (name.startswith("float") or jout.dtype.value.startswith("float")):
        assert_same(jout, tout, nan_bits=False)
    else:
        assert_same(jout, tout, rtol=RTOL[jout.dtype.value])


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("op,name", UNARY_CASES)
def test_unary_math_matches_jax(op, name, nulls):
    rng = np.random.default_rng([UNARY_CASES.index((op, name)), int(nulls)])
    ja, ta = make_pair(name, _inputs(op, name, rng), rng.random(N) < 0.8 if nulls else None)
    _check(getattr(JK, op)(ja), getattr(TK, op)(ta), op, name)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", FLOATS + ["int32", "int64"])
def test_power_matches_jax(name, nulls):
    rng = np.random.default_rng([30, (FLOATS + ["int32", "int64"]).index(name), int(nulls)])
    if name.startswith("float"):
        x = edge_values(name, N, rng)
        x[12:] = np.abs(x[12:]) % 8
        p = rng.uniform(-6, 6, N).astype(name)
        p[:16] = [0, 0.5, -1, 2, np.inf, -np.inf, np.nan, 3, 0.5, -0.5, 1, 0, 2, -2, 1.5, 7]
        p[30:40] = np.round(p[30:40])  # integral exponents of negative bases
    else:
        x = rng.integers(-5, 6, N).astype(name)
        x[:8] = [0, 1, -1, 2, -2, 3, np.iinfo(name).min, np.iinfo(name).max]
        p = rng.integers(-12, 64, N).astype(name)  # see test_int_power_wraps_every_multiply
        p[8:16] = [-1, -2, -3, 0, np.iinfo(name).min, 31, 62, 63]
        p[:8] = [-3, -5, -4, -1, -1, 0, 2, 1]
    ja, ta = make_pair(name, x, rng.random(N) < 0.8 if nulls else None)
    jp, tp = make_pair(name, p, rng.random(N) < 0.9 if nulls else None)
    _check(JK.power(ja, jp), TK.power(ta, tp), "power", name)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", TRIG_DTYPES)
@pytest.mark.parametrize("op", ["sin", "cos", "acos", "sinh"])
def test_trig_matches_jax(op, name, nulls):
    rng = np.random.default_rng([40 + ["sin", "cos", "acos", "sinh"].index(op), TRIG_DTYPES.index(name), int(nulls)])
    ja, ta = make_pair(name, _inputs(op, name, rng), rng.random(N) < 0.8 if nulls else None)
    _check(getattr(JK, op)(ja), getattr(TK, op)(ta), op, name)


@pytest.mark.parametrize("name", ["int32", "int64"])
def test_int_power_wraps_every_multiply(name):
    """The WGSL loop multiplies p times, wrapping: x ** p mod 2^w for every
    p >= 0.  The JAX package's integer power (jnp.power) reads the low 6
    bits of the exponent only, so exponents of 64 and more are pinned here
    against Python integers."""
    bits = np.iinfo(name).bits
    x = np.array([3, -5, 4, 2, -1, 7, 0, 1, -3, 12345], name)
    p = np.array([64, 67, 64, 65, 2**31 - 1, 1000, 99, 2**30, 2**31 - 2, 1 << 20], name)
    got = TK.power(make_pair(name, x)[1], make_pair(name, p)[1]).values()
    want = [(pow(int(a), int(b), 1 << bits) + (1 << (bits - 1))) % (1 << bits) - (1 << (bits - 1))
            for a, b in zip(x, p)]
    assert got == want


def test_sinh_near_float32_overflow():
    """sinh(+-89) is finite in float32 (2.2e38), on arrays long enough to
    take torch's vectorised CPU loop (whose float32 sinh overflows from
    |x| = 88.7); held to numpy's float64 sinh rounded to float32."""
    x = np.tile(np.array([88, 89, -89, 90, 127, -128, 81, 0], np.int8), 8)
    got = TK.sinh(make_pair("int8", x)[1]).raw_values()
    with np.errstate(over="ignore"):
        want = np.sinh(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL["float32"])
    assert np.isfinite(got[:3]).all()
