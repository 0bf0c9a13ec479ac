"""ComputePipeline and LazyArray of arrow_tpu_torch against the JAX package's
pipeline: examples/simple.py's chain, a graph mixing every op family, the
handles' contract (dtype and length before finish(), RuntimeError before
it, delegation after it, finish() once, no recording after it), the freeing
of intermediates during the replay; the kernels umbrella's public names;
and the port driven with jax blocked from import."""

import inspect
import subprocess
import sys
import textwrap
import weakref

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import kernels as JK
from arrow_tpu_torch import kernels as TK
from arrow_tpu_torch.ops.kernel import AV, register
from torch_helpers import ELEMENTWISE_N as N
from torch_helpers import assert_same, edge_values, make_pair


def _both(fn):
    """Run fn(K, pipeline) through each package's pipeline; returns the
    bound results of both, in pairs."""
    jp, tp = at.ComputePipeline(), att.ComputePipeline(device="cpu")
    jouts, touts = fn(JK, jp, 0), fn(TK, tp, 1)
    jp.finish()
    tp.finish()
    return list(zip(jouts, touts))


def test_simple_py_chain():
    """examples/simple.py: add_scalar_dyn and mul_scalar_dyn by a 1-row array,
    eagerly and through the _op_dyn forms in a pipeline."""
    lhs = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    (jl, tl), (jr, tr) = make_pair("float32", lhs), make_pair("float32", np.array([10.0], np.float32))
    eager = TK.mul_scalar_dyn(TK.add_scalar_dyn(tl, tr), tr)
    assert eager.values() == [110.0, 120.0, 130.0, 140.0]
    with att.ComputePipeline(device="cpu") as pipe:
        r1 = TK.add_scalar_op_dyn(tl, tr, pipe)
        r2 = TK.mul_scalar_op_dyn(r1, tr, pipe)
    with at.ComputePipeline() as jpipe:
        j1 = JK.add_scalar_op_dyn(jl, jr, jpipe)
        j2 = JK.mul_scalar_op_dyn(j1, jr, jpipe)
    assert_same(j1.bound(), r1.bound())
    assert_same(j2.bound(), r2.bound())
    assert_same(eager, r2.bound())


def _mixed_graph(K, p, side):
    rng = np.random.default_rng(5)
    f = make_pair("float32", edge_values("float32", N, rng), rng.random(N) < 0.8)[side]
    u = make_pair("uint32", edge_values("uint32", N, rng), rng.random(N) < 0.9)[side]
    i = make_pair("int16", edge_values("int16", N, rng))[side]
    idx = make_pair("uint32", rng.integers(0, N, 50).astype(np.uint32))[side]
    src_idx = make_pair("uint32", rng.integers(0, 50, 45).astype(np.uint32))[side]
    dst_idx = make_pair("uint32", rng.permutation(N)[:40].astype(np.uint32))[side]
    # below 2^24: the JAX package's u32 div rounds its operands to float32
    small = make_pair("uint32", rng.integers(0, 1 << 24, N).astype(np.uint32))[side]
    s = K.add_op(f, f, p)
    mask = K.gt_scalar_op(s, 0.0, p)
    m = K.merge_op(s, K.neg_op(f, p), mask, p)
    c = K.cast_op(K.div_scalar_op(small, 7, p), at.ArrowType.INT64 if side == 0 else att.ArrowType.INT64, p)
    sh = K.bitwise_shr_op(u, K.bitwise_and_op(u, u, p), p)
    b = K.broadcast_op(2.5, N, p, dtype=at.ArrowType.FLOAT32 if side == 0 else att.ArrowType.FLOAT32)
    pw = K.power_op(K.abs_op(f, p), b, p)
    t = K.take_op(m, idx, p)
    put = K.put_op(t, src_idx, K.sqrt_op(pw, p), dst_idx, p)
    return [s, mask, m, c, sh, b, pw, t, put, K.sum_op(c, p), K.sin_op(i, p), K.min_op(f, b, p),
            K.bitwise_not_op(mask, p), K.cast_op(mask, at.ArrowType.UINT8 if side == 0 else att.ArrowType.UINT8, p)]


def test_mixed_graph_matches_jax():
    for j, t in _both(_mixed_graph):
        rtol = 2e-6 if t.dtype.value == "float32" else None  # power, sin, sqrt of a power
        assert_same(j.bound(), t.bound(), rtol=rtol, nan_bits=False)


def test_pipelined_equals_eager():
    rng = np.random.default_rng(8)
    _, f = make_pair("float32", edge_values("float32", N, rng), rng.random(N) < 0.8)
    _, u = make_pair("uint32", edge_values("uint32", N, rng))
    with att.ComputePipeline(device="cpu") as p:
        got = [TK.merge_op(TK.mul_scalar_op(f, 3.0, p), f, TK.lt_op(f, TK.cast_op(u, att.ArrowType.FLOAT32, p), p), p),
               TK.rem_op(u, u, p), TK.log_op(f, p)]
    want = [TK.merge(TK.mul_scalar(f, 3.0), f, TK.lt(f, TK.cast(u, att.ArrowType.FLOAT32))),
            TK.rem(u, u), TK.log(f)]
    for g, w in zip(got, want):
        assert (g.dtype, len(g)) == (w.dtype, len(w))
        np.testing.assert_array_equal(g.data.numpy().view(np.uint8), w.data.numpy().view(np.uint8))
        assert (g.validity is None) == (w.validity is None)
        if w.validity is not None:
            np.testing.assert_array_equal(g.validity.numpy(), w.validity.numpy())


def test_handle_contract():
    a = att.Float32Array.from_slice([1.0, 2.0, 3.0], device="cpu")
    pipe = att.ComputePipeline(device="cpu")
    r = TK.add_scalar_op(a, 1.0, pipe)
    c = TK.cast_op(r, att.ArrowType.INT64, pipe)
    s = TK.sum_op(c, pipe)
    b = TK.broadcast_op(1, 70, pipe, dtype=att.ArrowType.UINT8)
    g = TK.gt_op(r, a, pipe)
    metas = [(h.dtype, len(h)) for h in (r, c, s, b, g)]
    assert metas == [(att.ArrowType.FLOAT32, 3), (att.ArrowType.INT64, 3), (att.ArrowType.INT64, 1),
                     (att.ArrowType.UINT8, 70), (att.ArrowType.BOOL, 3)]
    assert not r.is_bound and "pending" in repr(r)
    with pytest.raises(RuntimeError):
        r.values()
    with pytest.raises(RuntimeError):
        TK.add(r, r)  # eager use of an unbound handle
    pipe.finish()
    assert r.values() == [2.0, 3.0, 4.0] and c.values() == [2, 3, 4] and s.values() == [9]
    assert isinstance(r.bound(), att.Float32Array) and r.data is r.bound().data
    assert TK.add(r, r).values() == [4.0, 6.0, 8.0]  # a bound handle works as its array
    first = r.bound()
    pipe.finish()  # runs once
    assert r.bound() is first
    with pytest.raises(RuntimeError):
        TK.add_op(a, a, pipe)
    # a bound handle feeds another pipeline as a plain input
    with att.ComputePipeline(device="cpu") as p2:
        d = TK.mul_scalar_op(r, 2.0, p2)
    assert d.values() == [4.0, 6.0, 8.0]
    # an operand on another device is refused when it is recorded
    elsewhere = att.make_array(torch.zeros(32, device="meta"), None, 3, att.ArrowType.FLOAT32)
    with pytest.raises(ValueError):
        TK.add_op(elsewhere, elsewhere, att.ComputePipeline(device="cpu"))


PROBED = []


@register("test_probe")
def _probe(a: AV) -> AV:
    """neg, recording a weak reference to each output buffer and whether the
    output two ops back was already freed when this one ran."""
    PROBED.append((weakref.ref(a.data), len(PROBED) < 2 or PROBED[-2][0]() is None))
    out = -a.data
    PROBED[-1] = (weakref.ref(out), PROBED[-1][1])
    return AV(out, a.validity, a.length, a.dtype)


def test_intermediates_freed_after_last_use():
    PROBED.clear()
    a = att.Float32Array.from_slice(np.arange(64, dtype=np.float32), device="cpu")
    pipe = att.ComputePipeline(device="cpu")
    h = a
    for _ in range(5):
        h = TK.dispatch("test_probe", [h], pipeline=pipe)  # only the last handle is kept
    pipe.finish()
    assert all(freed for _, freed in PROBED)
    assert [ref() is None for ref, _ in PROBED] == [True] * 4 + [False]
    assert h.values() == (-np.arange(64)).tolist()


def _public(module):
    """Public names, without modules and typing/__future__ artifacts (the
    JAX package's umbrella also leaks jnp, dt and B, Optional and
    annotations from its star imports)."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v) and n not in ("Optional", "annotations")}


def test_kernels_umbrella_names_match_jax():
    assert _public(TK) == _public(JK)
    assert att.ComputePipeline and att.LazyArray and att.io.save_table and att.io.load_table


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import arrow_tpu_torch as att
        from arrow_tpu_torch import kernels as K
        from arrow_tpu_torch import io, ops, runtime  # noqa: F401
        a = att.Float32Array.from_slice([1.0, 2.0], device="cpu")
        with att.ComputePipeline(device="cpu") as p:
            r = K.mul_scalar_op(K.add_scalar_op(a, 1.0, p), 2.0, p)
        assert K.sqrt(a).values()[0] == 1.0 and r.values() == [4.0, 6.0]
        assert not any(m == "jax" or m.startswith(("jax.", "arrow_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


BROADCAST_VALUES = {"bool": True, "float32": -2.5, "float64": 1e300, "uint8": 255, "uint16": 40000,
                    "uint32": 2**32 - 1, "uint64": 2**64 - 1, "int8": -128, "int16": -7, "int32": 7,
                    "int64": -(2**63), "date32": 19000}


@pytest.mark.parametrize("n", [0, 1, 70])
@pytest.mark.parametrize("name", list(BROADCAST_VALUES))
def test_broadcast_matches_jax(name, n):
    v = BROADCAST_VALUES[name]
    want = JK.broadcast(v, n, at.ArrowType(name))
    assert_same(want, TK.broadcast(v, n, att.ArrowType(name)))
    with att.ComputePipeline(device="cpu") as p:
        got = TK.broadcast_op(v, n, p, dtype=att.ArrowType(name))
    assert (got.dtype, len(got)) == (att.ArrowType(name), n)
    assert_same(want, got.bound())
    assert_same(JK.broadcast(at.Scalar.of(3, at.ArrowType.INT16), n), TK.broadcast(att.Scalar.of(3, att.ArrowType.INT16), n))
