"""Compare ops of arrow_tpu_torch against arrow_tpu.kernels: array and scalar
forms, NaN, nulls and unsigned values >= 2^(w-1); the elementwise min and
max (NaN propagates, -0 below +0, unsigned order); the _op forms through a
ComputePipeline; exact."""

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import kernels as JK
from arrow_tpu_torch import kernels as TK
from torch_helpers import assert_same, edge_values, jax_to_torch

OPS = ["eq", "gt", "gteq", "lt", "lteq"]
DTYPES = ["float32", "float64", "int32", "uint32", "int64", "uint64", "date32", "uint16"]
# a scalar inside each type's range, in its upper half for the unsigned ones
SCALARS = {
    "float32": 0.0, "float64": -0.5, "int32": 7, "uint32": 2**31 + 5, "int64": -(2**40),
    "uint64": 2**63 + 9, "date32": 100, "int8": -3, "uint16": 40000,
}


def _values(rng, name, n):
    if name.startswith("float"):
        v = rng.standard_normal(n).astype(name)
        v[::7] = np.nan
        v[3::11] = SCALARS[name]
        return v
    npdt = np.dtype("int32" if name == "date32" else name)
    info = np.iinfo(npdt)
    v = rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)
    v[3::11] = SCALARS[name]
    v[5::13] = v[6::13][: v[5::13].shape[0]]
    return v


def _pair(name, vals, valid):
    t = at.ArrowType(name)
    if valid is None:
        ja = at.PrimitiveArray.from_slice(vals, dtype=t)
    else:
        ja = at.PrimitiveArray.from_optional_slice(
            [v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=t
        )
    return ja, jax_to_torch(ja)


@pytest.mark.parametrize("name", DTYPES)
def test_array_forms(name):
    rng = np.random.default_rng(DTYPES.index(name))
    n = 777
    a = _values(rng, name, n)
    b = a.copy()
    swap = rng.random(n) < 0.5
    b[swap] = _values(rng, name, n)[swap]
    ja, ta = _pair(name, a, rng.random(n) < 0.8)
    jb, tb = _pair(name, b, None)
    for op in OPS:
        assert_same(getattr(JK, op)(ja, jb), getattr(TK, op)(ta, tb))


@pytest.mark.parametrize("name", DTYPES)
def test_scalar_forms(name):
    rng = np.random.default_rng(100 + DTYPES.index(name))
    n = 555
    a = _values(rng, name, n)
    ja, ta = _pair(name, a, rng.random(n) < 0.9)
    s = SCALARS[name]
    for op in OPS:
        assert_same(getattr(JK, f"{op}_scalar")(ja, s), getattr(TK, f"{op}_scalar")(ta, s))


def test_nan_compares_false_and_null_is_null():
    ta = att.Float32Array.from_optional_slice([float("nan"), 1.0, None], device="cpu")
    tb = att.Float32Array.from_slice([float("nan"), 1.0, 1.0], device="cpu")
    assert TK.eq(ta, tb).values() == [False, True, None]
    assert TK.gt_scalar(ta, 0.0).values() == [False, True, None]
    assert TK.lteq_scalar(ta, float("nan")).values() == [False, False, None]


def test_scalar_object_and_pipeline_refused():
    ta = att.Int32Array.from_slice([1, 5, 9], device="cpu")
    assert TK.gt_scalar(ta, att.Scalar.of(4)).values() == [False, True, True]
    with pytest.raises(TypeError):  # a pipeline must be a ComputePipeline
        TK.gt(ta, ta, pipeline=object())
    with pytest.raises(att.OperationNotSupported):
        TK.gt(att.BooleanArray.from_slice([True], device="cpu"), ta)


MINMAX_DTYPES = DTYPES + ["int8", "uint8", "int16"]


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", MINMAX_DTYPES)
def test_elementwise_min_max(name, nulls):
    rng = np.random.default_rng([200 + MINMAX_DTYPES.index(name), int(nulls)])
    n = 600
    a, b = edge_values(name, n, rng), np.roll(edge_values(name, n, rng), 3)
    if name.startswith("float"):  # every order of +-0 and of a NaN against a number
        a[20:26], b[20:26] = [0.0, -0.0, 0.0, -0.0, np.nan, 1.0], [-0.0, 0.0, 0.0, -0.0, 1.0, np.nan]
    ja, ta = _pair(name, a, rng.random(n) < 0.8 if nulls else None)
    jb, tb = _pair(name, b, rng.random(n) < 0.8 if nulls else None)
    for op in ("min", "max", "min_array_dyn", "max_array_dyn", "min_dyn", "max_dyn"):
        assert_same(getattr(JK, op)(ja, jb), getattr(TK, op)(ta, tb), nan_bits=False)


@pytest.mark.parametrize("name", ["float32", "uint32", "int64"])
def test_op_forms_in_a_pipeline(name):
    """Every compare and min/max through its _op form in one pipeline, held
    to the JAX package's pipeline."""
    rng = np.random.default_rng(300 + DTYPES.index(name))
    n = 300
    a, b = _values(rng, name, n), _values(rng, name, n)
    ja, ta = _pair(name, a, rng.random(n) < 0.8)
    jb, tb = _pair(name, b, None)
    s = SCALARS[name]
    jp, tp = at.ComputePipeline(), att.ComputePipeline(device="cpu")
    jouts, touts = [], []
    for op in OPS + ["min", "max"]:
        for mod, p, x, y, outs in ((JK, jp, ja, jb, jouts), (TK, tp, ta, tb, touts)):
            outs.append(getattr(mod, f"{op}_op")(x, y, p))
            outs.append(getattr(mod, f"{op}_op_dyn")(x, y, p))
            if op in OPS:
                outs.append(getattr(mod, f"{op}_scalar_op")(x, s, p))
    jp.finish()
    tp.finish()
    for j, t in zip(jouts, touts):
        assert_same(j.bound(), t.bound(), nan_bits=False)
