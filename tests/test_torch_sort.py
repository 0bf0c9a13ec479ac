"""sort / argsort / sort_by_key / lex_sort of arrow_tpu_torch against
arrow_tpu.compute (its default lax.sort route): every port route (xla,
radix, merge) where it applies, i32/u32/i64/u64/f32/f64/date32/u8/i16 keys,
nulls, descending order, +-0, +-NaN and +-inf.  Exact, bit for bit.

The JAX package's own radix and merge routes order +-0 and -NaN unlike its
default route; ``test_jax_float_routes_disagree`` pins that down (ROADMAP
section C), and the port follows the default route on every route.

Also the one row gate of every radix route (``radix_pays``): it alone sends
sort_by_key, hash_aggregate and the join's co-sort to kernel B3 under
``auto``, on any device, and the JAX package's environment switches steer
none of the port's routes."""

import importlib

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import compute as JC
from arrow_tpu.compute.sort import _sort_radix as jax_sort_radix
from arrow_tpu.table import RecordBatch as JBatch
import arrow_tpu_torch as att
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch.compute.kernels import merge as TM
from arrow_tpu_torch.compute.kernels import radix as TR
from torch_helpers import assert_same, batch_to_torch, jax_to_torch

TS = importlib.import_module("arrow_tpu_torch.compute.sort")  # the module, not compute.sort()

N = 3000
_NAN_NEG = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
POOLS = {
    "int32": np.array([-(2**31), -7, -1, 0, 3, 2**31 - 1], np.int32),
    "uint32": np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1, 3_000_000_000], np.uint32),
    "int64": np.array([-(2**63), -(2**40), -1, 0, 2**40, 2**63 - 1], np.int64),
    "uint64": np.array([0, 7, 2**63 - 1, 2**63, 2**64 - 1], np.uint64),
    "float32": np.array([-np.inf, -2.5, -0.0, 0.0, 1.5, np.inf, np.nan, _NAN_NEG], np.float32),
    "float64": np.array([-np.inf, -1e300, -0.0, 0.0, 2.0, np.inf, np.nan, -np.nan], np.float64),
    "date32": np.array([-719162, -1, 0, 18000, 2932896], np.int32),
    "uint8": np.array([0, 1, 127, 128, 255], np.uint8),
    "int16": np.array([-(2**15), -1, 0, 2**15 - 1], np.int16),
}
RADIX_TYPES = {"int32", "uint32", "int64", "uint64", "float32", "date32"}
MERGE_TYPES = {"int32", "uint32", "float32", "date32"}


def _col(rng, name, null_p, n=N):
    vals = POOLS[name][rng.integers(0, POOLS[name].shape[0], n)]
    t = at.ArrowType(name)
    if not null_p:
        return at.PrimitiveArray.from_slice(vals, dtype=t)
    valid = rng.random(n) >= null_p
    return at.PrimitiveArray.from_optional_slice(
        [v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=t
    )


def _routes(name, nulls, descending):
    routes = ["xla", "auto"]
    if name in RADIX_TYPES and not nulls:
        routes.append("radix")
    if name in MERGE_TYPES and not nulls and not descending:
        routes.append("merge")
    return routes


@pytest.mark.parametrize("name", list(POOLS))
@pytest.mark.parametrize("null_p", [0.0, 0.25])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_and_argsort_match_jax(name, null_p, descending):
    rng = np.random.default_rng(len(name))
    col = _col(rng, name, null_p)
    want = JC.sort(col, descending)
    t = jax_to_torch(col)
    for method in _routes(name, null_p > 0, descending):
        assert_same(want, TC.sort(t, descending, method=method))
    order = TC.argsort(t, descending)
    np.testing.assert_array_equal(order.raw_values(), JC.argsort(col, descending).raw_values())


@pytest.mark.parametrize("name", ["uint32", "int64", "float32", "float64", "int16"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_by_key_array_payload_matches_jax(name, descending):
    rng = np.random.default_rng(7)
    keys = _col(rng, name, 0.0)
    payload = _col(rng, "float64", 0.3)
    wk, wp = JC.sort_by_key(keys, payload, descending)
    for method in _routes(name, False, descending):
        gk, gp = TC.sort_by_key(jax_to_torch(keys), jax_to_torch(payload), descending, method=method)
        assert_same(wk, gk)
        assert_same(wp, gp)


@pytest.mark.parametrize("key_null_p", [0.0, 0.2])
def test_sort_by_key_batch_payload_matches_jax(key_null_p):
    rng = np.random.default_rng(11)
    keys = _col(rng, "int32", key_null_p)
    batch = JBatch({
        "w64": _col(rng, "int64", 0.0),
        "b": at.BooleanArray.from_slice((rng.random(N) < 0.5).tolist()),
        "small": _col(rng, "uint8", 0.0),
        "nul": _col(rng, "uint32", 0.3),
    })
    wk, wb = JC.sort_by_key(keys, batch)
    tb = batch_to_torch(batch)
    for method in _routes("int32", key_null_p > 0, False):
        gk, gb = TC.sort_by_key(jax_to_torch(keys), tb, method=method)
        assert_same(wk, gk)
        assert gb.column_names == wb.column_names
        for name in wb.column_names:
            assert_same(wb[name], gb[name])
    gk, none = TC.sort_by_key(jax_to_torch(keys))
    assert none is None
    assert_same(JC.sort_by_key(keys)[0], gk)


@pytest.mark.parametrize("descending", [False, True])
def test_lex_sort_matches_jax(descending):
    rng = np.random.default_rng(13)
    keys = [_col(rng, "uint32", 0.0), _col(rng, "float32", 0.0), _col(rng, "int64", 0.0)]
    payload = _col(rng, "int16", 0.2)
    wks, wp, wo = JC.lex_sort(keys, payload, descending)
    gks, gp, go = TC.lex_sort([jax_to_torch(k) for k in keys], jax_to_torch(payload), descending)
    for w, g in zip(wks, gks):
        assert_same(w, g)
    assert_same(wp, gp)
    np.testing.assert_array_equal(go.raw_values(), wo.raw_values())


def _signed_zeros_and_nans():
    """+0/-0 alternating, then NaNs of both signs among other values."""
    zeros = np.tile(np.array([0.0, -0.0], np.float32), 50)
    other = np.array([_NAN_NEG, 1.0, np.nan, -1.0, np.inf, -np.inf] * 10, np.float32)
    return at.Float32Array.from_slice(np.concatenate([zeros, other]))


def _bits(arr):
    return arr.raw_values().view(np.uint32)


def test_port_float_order_is_the_jax_default_on_every_route():
    col = _signed_zeros_and_nans()
    want = JC.sort(col)
    zeros = _bits(want)[np.abs(want.raw_values()) == 0]
    assert (zeros == np.tile(np.array([0, 0x80000000], np.uint32), 50)).all()  # input order
    for method in ("xla", "radix", "merge", "auto"):
        assert_same(want, TC.sort(jax_to_torch(col), method=method))


def test_jax_float_routes_disagree():
    """The JAX package's radix route orders -0 before +0 and its merge route
    also puts -NaN first, where its default route ties +-0 in input order
    and puts every NaN last."""
    col = _signed_zeros_and_nans()
    default = _bits(JC.sort(col))
    radix = _bits(jax_sort_radix(col, [])[0])
    merge = _bits(JC.sort(col, method="merge"))
    neg_zero = np.uint32(0x80000000)
    assert not (default == radix).all() and not (default == merge).all()
    zeros_default = default[(default == 0) | (default == neg_zero)]
    assert (zeros_default[:2] == [0, neg_zero]).all()  # input order: +0, -0, ...
    for route in (radix, merge):
        zeros = route[(route == 0) | (route == neg_zero)]
        assert (zeros[:50] == neg_zero).all() and (zeros[50:] == 0).all()  # -0 first
    assert np.isnan(radix[-20:].view(np.float32)).all()  # radix: NaNs last
    assert merge[0] == 0xFFC00000 and np.isnan(merge[-10:].view(np.float32)).all()  # merge: -NaN first


def test_sort_rejects_what_it_does_not_take():
    rng = np.random.default_rng(1)
    nullable = jax_to_torch(_col(rng, "int32", 0.3))
    with pytest.raises(Exception):
        TC.sort(nullable, method="radix")
    with pytest.raises(Exception):
        TC.sort(nullable, method="merge")
    with pytest.raises(Exception):
        TC.sort(jax_to_torch(_col(rng, "int64", 0.0)), method="merge")
    with pytest.raises(Exception):
        TC.sort(jax_to_torch(at.BooleanArray.from_slice([True, False])))
    with pytest.raises(Exception):
        TC.lex_sort([nullable])


# -- the one radix gate, and no environment switch --

GATE_N = 16384  # a full buffer (the group-by's radix route takes no other), two of B7's 8192-row runs


def _gate_inputs():
    """CPU columns of GATE_N rows: u32 keys past 2^22 (no dense group-by
    route takes them), i32 values, and a build and a probe side of u32 join
    keys (unique build keys, probe keys half of them missing)."""
    rng = np.random.default_rng(17)
    u32 = lambda vals: att.UInt32Array.from_slice(vals.astype(np.uint32), device="cpu")  # noqa: E731
    return {
        "keys": u32(rng.integers(1 << 23, (1 << 23) + 500, GATE_N)),
        "vals": att.Int32Array.from_slice(rng.integers(-1000, 1000, GATE_N).astype(np.int32), device="cpu"),
        "build": u32(rng.permutation(GATE_N // 2)),
        "probe": u32(rng.integers(0, GATE_N, GATE_N)),
    }


def _planes(out):
    """Every buffer of an operator's output as bytes, in order."""
    if isinstance(out, att.RecordBatch):
        return [b for c in out.columns().values() for b in _planes(c)]
    if isinstance(out, (tuple, list)):
        return [b for o in out for b in _planes(o)]
    if isinstance(out, torch.Tensor):
        return [out.numpy().tobytes()]
    if isinstance(out, int):
        return [out]
    return [out.length, out.data.numpy().tobytes(), None if out.validity is None else out.validity.numpy().tobytes()]


GATED = {  # operator -> (the call under auto, its buffer rows)
    "sort_by_key": (lambda c: TC.sort_by_key(c["keys"], c["vals"]), lambda c: c["keys"].data.shape[0]),
    "hash_aggregate": (lambda c: TC.hash_aggregate(c["keys"], [("mx", c["vals"], "max"), ("n", None, "count")]),
                       lambda c: c["keys"].data.shape[0]),
    "join_indices": (lambda c: TC.join_indices(c["build"], c["probe"]),
                     lambda c: c["build"].data.shape[0] + c["probe"].data.shape[0]),
}


@pytest.mark.parametrize("at_gate", [False, True], ids=["just_above", "at_buffer_rows"])
@pytest.mark.parametrize("op", list(GATED))
def test_one_gate_routes_every_operator(op, at_gate, monkeypatch):
    """``RADIX_AUTO_ROWS`` alone decides whether each operator's ``auto``
    takes kernel B3 (its plain version on these CPU tensors): no B3 pass
    with the gate one row above the call's buffer rows, B3 passes with it
    at them, and the same output either way.  The join runs its merge emit,
    the one with a co-sort."""
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", "merge")
    call, buffer_rows = GATED[op]
    c = _gate_inputs()
    want = _planes(call(c))  # the default gate, far above these buffers
    monkeypatch.setattr(TS, "RADIX_AUTO_ROWS", buffer_rows(c) + (0 if at_gate else 1))
    TR.KERNEL.passes = 0
    got = _planes(call(c))
    assert (TR.KERNEL.passes > 0) == at_gate
    assert got == want


def _every_sort(c):
    """A call of each operator route that a JAX package switch steers there:
    sort and argsort under auto, sort_by_key on the radix route, the
    group-by under auto, and the legacy join emit (the CPU's default)."""
    return (
        TC.sort(c["keys"]), TC.argsort(c["keys"]), TC.sort_by_key(c["keys"], c["vals"], method="radix"),
        TC.hash_aggregate(c["keys"], [("mx", c["vals"], "max"), ("n", None, "count")]),
        TC.join_indices(c["build"], c["probe"]),
    )


@pytest.mark.parametrize("name,value", [
    ("ARROW_TPU_SORT", "radix"), ("ARROW_TPU_FORCE_MERGE", "1"),
    ("ARROW_TPU_FORCE_RADIX_AGG", "1"), ("ARROW_TPU_RADIX_R", "4"),
])
def test_jax_switches_do_not_steer_the_port(name, value, monkeypatch):
    """With the JAX package's switch set, the port's outputs, its B3 passes
    and its calls of B7 are those it gives without it."""
    c = _gate_inputs()
    merges = []
    plain = TM.merge_pass_plain
    monkeypatch.setattr(TM, "merge_pass_plain", lambda *a: merges.append(a[1]) or plain(*a))
    runs = []
    for setting in (None, value):
        if setting is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, setting)
        merges.clear()
        TR.KERNEL.passes = TR.KERNEL_2BIT.passes = 0
        out = _planes(_every_sort(c))
        runs.append((out, TR.KERNEL.passes, TR.KERNEL_2BIT.passes, list(merges)))
    assert runs[0][1] > 0 and runs[0][2] == 0 and runs[0][3] == []
    assert runs[1] == runs[0]
