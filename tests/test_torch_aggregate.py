"""Aggregates of arrow_tpu_torch against arrow_tpu.kernels: sum_, min_reduce
and max_reduce over every dtype they take, with nulls (which are not
skipped: a null row adds its stored zero), on 0, 1 and 300 rows.  Integer
sums wrap at the type's width and are exact, as are min and max (NaN
propagates; -0 is below +0); float sums agree to rtol 1e-5 (float32) and
1e-12 (float64), their summation orders differing.  The result is a 1-row
array on a padded buffer, zero past its row."""

import numpy as np
import pytest

import arrow_tpu_torch as att
from arrow_tpu import kernels as JK
from arrow_tpu_torch import kernels as TK
from torch_helpers import ELEMENTWISE_N as N
from torch_helpers import NUMERIC, assert_same, edge_values, make_pair

SUM_RTOL = {"float32": 1e-5, "float64": 1e-12}
SUM_DTYPES = [n for n in NUMERIC if n != "date32"]


def _column(name, n, rng, nulls, finite=False):
    v = edge_values(name, n, rng)
    if finite and name.startswith("float"):  # positive terms: no cancellation
        v = rng.random(n).astype(name)
    return make_pair(name, v, rng.random(n) < 0.7 if nulls else None)


@pytest.mark.parametrize("n", [0, 1, N])
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", SUM_DTYPES)
def test_sum_matches_jax(name, nulls, n):
    rng = np.random.default_rng([SUM_DTYPES.index(name), int(nulls), n])
    for finite in (True, False) if name.startswith("float") else (False,):
        ja, ta = _column(name, n, rng, nulls, finite)
        got, want = TK.sum_(ta), JK.sum_(ja)
        assert_same(want, got, rtol=SUM_RTOL.get(name))
        assert got.data.shape[0] == att.array.array.pad_len(1)
        assert_same(JK.sum_dyn(ja), TK.sum_dyn(ta), rtol=SUM_RTOL.get(name))


@pytest.mark.parametrize("n", [1, N])
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("name", NUMERIC)
def test_min_max_match_jax(name, nulls, n):
    rng = np.random.default_rng([50 + NUMERIC.index(name), int(nulls), n])
    ja, ta = _column(name, n, rng, nulls)
    assert_same(JK.min_reduce(ja), TK.min_reduce(ta))
    assert_same(JK.max_reduce(ja), TK.max_reduce(ta))
    if name.startswith("float"):  # without NaN; the zeros' signs decide ties
        vals = rng.standard_normal(n).astype(name)
        vals[: min(n, 4)] = np.array([0.0, -0.0, 0.0, -0.0], name)[: min(n, 4)]
        for v in (vals, np.abs(vals), -np.abs(vals), np.zeros(n, name), -np.zeros(n, name)):
            ja, ta = make_pair(name, v)
            assert_same(JK.min_reduce(ja), TK.min_reduce(ta))
            assert_same(JK.max_reduce(ja), TK.max_reduce(ta))


@pytest.mark.parametrize("name", NUMERIC)
def test_min_max_of_no_rows_is_the_identity(name):
    """The JAX package raises on an empty min/max (a zero-size reduction);
    the port gives the fill the JAX package pads with."""
    ja, ta = make_pair(name, np.zeros(0, edge_values(name, 1, np.random.default_rng(0)).dtype))
    with pytest.raises(ValueError):
        JK.min_reduce(ja)
    if name.startswith("float"):
        lo, hi = -np.inf, np.inf
    else:
        info = np.iinfo(att.dtypes.info(att.ArrowType(name)).numpy)
        lo, hi = int(info.min), int(info.max)
    assert TK.min_reduce(ta).values() == [hi]
    assert TK.max_reduce(ta).values() == [lo]


def test_refusals():
    with pytest.raises(att.OperationNotSupported):
        TK.sum_(att.Date32Array.from_slice([1, 2], device="cpu"))
    with pytest.raises(att.OperationNotSupported):
        TK.min_reduce(att.BooleanArray.from_slice([True], device="cpu"))
