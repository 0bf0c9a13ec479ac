"""The pipeline's fusion (arrow_tpu_torch.runtime.fusion) on the CPU: the plans
of chip_smoke.py's 6-op chain and of the mixed graph of
test_torch_pipeline.py, dropped intermediates, the plan cache (the port's
counterpart of tests/test_pipeline.py::test_pipeline_cache_hit), the
generated source, and the generated row code itself: each group's host
form (the same row expressions, compiled with g++) against the eager replay
of its ops, over every op and dtype case of chip_smoke.py's elementwise
phase and over the mixed graph, on seeded inputs with the types' edge
values and nulls.  The CUDA form runs on the card only (chip_smoke.py)."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
import chip_smoke
from arrow_tpu import kernels as JK
from arrow_tpu_torch import kernels as TK
from arrow_tpu_torch.ops.kernel import execute
from arrow_tpu_torch.runtime import fusion
from test_torch_pipeline import _mixed_graph
from torch_helpers import assert_same, edge_values, make_pair

N = 300  # rows of each input: nine words and a partial one


def _steps(pipe):
    """The plan's steps as ("group", node indices, output slot ids) and
    ("boundary", node index)."""
    return [("group", s.nodes, tuple(o.oid for o in s.outputs)) if isinstance(s, fusion.Group)
            else ("boundary", s.node) for s in pipe.plan().steps]


def _f32(n=N, valid=True, seed=0):
    rng = np.random.default_rng(seed)
    return make_pair("float32", edge_values("float32", n, rng), rng.random(n) < 0.8 if valid else None)[1]


def test_ew_chain_is_one_group():
    """|2x + float(k)| by a compare and a merge: six ops, one group, one
    output (the merge)."""
    rng = np.random.default_rng(1)
    x = _f32()
    k = make_pair("uint32", edge_values("uint32", N, rng))[1]
    pipe = att.ComputePipeline(device="cpu")
    out = chip_smoke._ew_chain(TK, x, k, pipe)
    assert _steps(pipe) == [("group", (0, 1, 2, 3, 4, 5), (out._node_id,))]
    group = pipe.plan().groups[0]
    # x, k and their validity (k has none: its pointer is null at the launch)
    assert [op.plane for op in group.operands] == ["data", "data", "validity", "validity"]
    pipe.finish()
    assert_same(out.bound(), chip_smoke._ew_chain(TK, x, k))


def test_mixed_graph_plan():
    """Groups split at broadcast, take, put and sum; a group writes what a
    live handle or a later step reads, no dropped intermediate."""
    pipe = att.ComputePipeline(device="cpu")
    outs = _mixed_graph(TK, pipe, 1)
    ids = {name: h._node_id for name, h in zip(
        ("s", "mask", "m", "c", "sh", "b", "pw", "t", "put", "sum", "sin", "min", "not", "cast"), outs)}
    assert _steps(pipe) == [
        ("group", (0, 1, 2, 3, 4, 5, 6, 7), (ids["s"], ids["mask"], ids["m"], ids["c"], ids["sh"])),
        ("boundary", 8),  # broadcast
        ("group", (9, 10), (ids["pw"],)),  # abs then power: abs stays in registers
        ("boundary", 11),  # take
        ("group", (12,), (12,)),  # sqrt, which put reads
        ("boundary", 13),  # put
        ("boundary", 14),  # sum
        ("group", (15, 16, 17, 18), (ids["sin"], ids["min"], ids["not"], ids["cast"])),
    ]


@pytest.mark.parametrize("keep", [False, True])
def test_dropped_intermediates_are_not_written(keep):
    a = _f32()
    pipe = att.ComputePipeline(device="cpu")
    r1 = TK.add_scalar_op(a, 1.0, pipe)
    r = TK.mul_scalar_op(r1, 3.0, pipe)
    kept = r1 if keep else None
    del r1
    (step,) = _steps(pipe)
    assert step == ("group", (0, 1), (0, 1) if keep else (1,))
    pipe.finish()
    assert_same(r.bound(), TK.mul_scalar(TK.add_scalar(a, 1.0), 3.0))
    assert kept is None or kept.is_bound


def test_pipeline_cache_hit():
    """The same signature twice adds one plan; so does another length (the
    row count is a kernel argument); another dtype adds another."""
    def run(n, dtype=att.ArrowType.FLOAT32):
        a = att.PrimitiveArray.from_slice(np.arange(n) % 5, dtype=dtype, device="cpu")
        with att.ComputePipeline(device="cpu") as pipe:
            r = TK.add_scalar_op(a, 2, pipe)
        return r.values()

    before = fusion.plan.cache_info()
    assert run(2) == run(2) == [2, 3]
    after = fusion.plan.cache_info()
    assert after.currsize <= before.currsize + 1 and after.hits >= before.hits + 1
    assert run(70)[:3] == [2, 3, 4]
    assert fusion.plan.cache_info().currsize <= before.currsize + 1
    run(2, att.ArrowType.INT16)
    assert fusion.plan.cache_info().currsize <= before.currsize + 2


def test_generated_source_is_deterministic():
    pipe = att.ComputePipeline(device="cpu")
    _outs = _mixed_graph(TK, pipe, 1)
    sig = pipe.signature()
    first, second = fusion.plan.__wrapped__(sig), fusion.plan.__wrapped__(sig)
    assert first.source == second.source and first.host_source == second.host_source
    groups = first.groups
    assert len(re.findall(r"__global__", first.source)) == len(groups) == 4
    for g in groups:
        assert f'extern "C" int {g.symbol}(' in first.source
        assert f'extern "C" void {g.symbol}(' in first.host_source
    assert "__ballot_sync" in first.source and "__ballot_sync" not in first.host_source


# -- the generated row code, built for the host --------------------------------


def _cases():
    """chip_smoke.py's elementwise cases that record an op, by ops module."""
    by_module = {}
    for label, fn, rtol, op in chip_smoke._ew_cases():
        if op is not None:
            by_module.setdefault(chip_smoke.ew_module(op), []).append((label, fn, rtol, op))
    return by_module


CASES = _cases()


@pytest.fixture(scope="module")
def inputs():
    return {key: pair[1] for key, pair in chip_smoke._ew_inputs(n=N, device="cpu").items()}


def _compile_host(source, tmp_path):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the generated row code for the host")
    src, lib = tmp_path / "fused_host.cpp", tmp_path / "fused_host.so"
    src.write_text(source)
    proc = subprocess.run([cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib))


def _same_av(label, got, want, rtol):
    assert (got.dtype, got.length) == (want.dtype, want.length), label
    assert (got.validity is None) == (want.validity is None), f"{label}: validity buffer"
    if want.validity is not None:
        assert torch.equal(got.validity, want.validity), f"{label}: validity bits"
    g, w = got.data, want.data
    assert g.shape == w.shape, label
    if not w.is_floating_point():
        assert torch.equal(g, w), f"{label}: values"
        return
    nan = torch.isnan(w)
    assert torch.equal(torch.isnan(g), nan), f"{label}: NaN rows"
    if rtol is None:
        bits = torch.int32 if w.dtype is torch.float32 else torch.int64
        assert torch.equal(g[~nan].view(bits), w[~nan].view(bits)), f"{label}: bits"
    else:
        torch.testing.assert_close(g[~nan], w[~nan], rtol=rtol, atol=0, msg=label)


def _run_host(pipe, lib, rtols):
    """Run the plan of `pipe` (not finished) step by step: boundaries
    eagerly, each group both by its host code and by the eager replay of its
    ops, which must agree (`rtols`: slot id -> rtol of a float output).
    Returns the number of groups."""
    p = pipe.plan()
    env = {}

    def value(ref):
        return env[ref[1]] if ref[0] == "node" else pipe._inputs[ref[1]]

    for step in p.steps:
        if isinstance(step, fusion.Boundary):
            node = pipe._nodes[step.node]
            env.update(zip(node.out_ids, execute(node.op, [value(r) for r in node.inputs], node.params)))
            continue
        want = fusion.run_group_plain(pipe._nodes, step, value)
        got = fusion.run_group_host(lib, step, value)
        for oid, w in want.items():
            _same_av(f"group {step.index} slot {oid}", got[oid], w, rtols.get(oid))
        env.update(want)
    return len(p.groups)


@pytest.mark.parametrize("module", sorted(CASES))
def test_generated_row_code_matches_eager(module, inputs, tmp_path):
    """Every case of the module, recorded into one pipeline: each is fused
    (no boundary), and the host build of the generated code equals the eager
    ops: exact, a NaN matching any NaN, transcendental ops within the
    elementwise phase's rtol."""
    pipe = att.ComputePipeline(device="cpu")
    handles = [(label, fn(inputs, pipe), rtol) for label, fn, rtol, _ in CASES[module]]
    p = pipe.plan()
    assert not any(isinstance(s, fusion.Boundary) for s in p.steps), module
    assert sum(len(g.outputs) for g in p.groups) == len(handles)
    lib = _compile_host(p.host_source, tmp_path)
    assert _run_host(pipe, lib, {h._node_id: rtol for _, h, rtol in handles}) == len(p.groups)


def test_generated_row_code_matches_eager_on_the_mixed_graph(tmp_path):
    pipe = att.ComputePipeline(device="cpu")
    outs = _mixed_graph(TK, pipe, 1)
    lib = _compile_host(pipe.plan().host_source, tmp_path)
    rtols = {h._node_id: 2e-6 for h in outs}  # sin, the power
    assert _run_host(pipe, lib, rtols) == 4


def test_validity_resolves_as_the_eager_ops():
    """An output's validity is none, one operand's buffer itself, or a new
    buffer, as merged_validity and the merge's 4-way composition give."""
    a, b = ("input", 0), ("input", 1)
    and_ab = fusion._and([("src", a), ("src", b)])
    merge = ("merge", ("src", a), ("src", b), "m", ("src", ("input", 2)))
    for present, want_and, want_merge in [
        ({a: False, b: False, ("input", 2): False}, None, None),
        ({a: True, b: False, ("input", 2): False}, ("alias", a), "computed"),
        ({a: True, b: True, ("input", 2): True}, "computed", "computed"),
        ({a: False, b: False, ("input", 2): True}, None, ("alias", ("input", 2))),
    ]:
        assert fusion.resolve_validity(and_ab, present.get) == want_and
        assert fusion.resolve_validity(merge, present.get) == want_merge
    assert fusion._and([("src", a), ("src", a)]) == ("src", a)


def test_pipeline_matches_jax_through_the_plan():
    """A chain the JAX package fuses into one program, through both
    pipelines: the port's plan is one group of three ops."""
    rng = np.random.default_rng(3)
    (jf, tf) = make_pair("float64", edge_values("float64", N, rng), rng.random(N) < 0.6)
    (ju, tu) = make_pair("uint16", edge_values("uint16", N, rng), rng.random(N) < 0.6)
    with at.ComputePipeline() as jp:
        j = JK.merge_op(jf, JK.neg_op(jf, jp), JK.lt_op(JK.cast_op(ju, at.ArrowType.FLOAT64, jp), jf, jp), jp)
    tp = att.ComputePipeline(device="cpu")
    t = TK.merge_op(tf, TK.neg_op(tf, tp), TK.lt_op(TK.cast_op(tu, att.ArrowType.FLOAT64, tp), tf, tp), tp)
    assert _steps(tp) == [("group", (0, 1, 2, 3), (t._node_id,))]
    tp.finish()
    assert_same(j.bound(), t.bound())


def test_cuda_group_needs_the_card():
    """Building a generated source needs a CUDA device; without one it
    raises (the CPU runs the plain version, never the build)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pipe = att.ComputePipeline(device="cpu")
    TK.neg_op(_f32(), pipe)
    with pytest.raises(RuntimeError, match="CUDA device"):
        fusion.prepare([pipe.plan()])


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_generated_row_code_on_float_edge_pairs(name, tmp_path):
    """Every pair of float edge values, row by row: min and max on +-0 and
    NaN, the compares, division and remainder by +-0 and +-inf.  (No float32
    pair's quotient overflows: torch's CPU float32 fmod gives NaN there, for
    example fmod(1e30, -1e-30), where C's fmodf and the card give the
    remainder.)"""
    tiny = -1e-30 if name == "float64" else -1e-3
    edges = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 3.5, 1e30, tiny], name)
    a, b = np.repeat(edges, edges.size), np.tile(edges, edges.size)
    x, y = make_pair(name, a)[1], make_pair(name, b)[1]
    pipe = att.ComputePipeline(device="cpu")
    handles = [getattr(TK, op)(x, y, pipeline=pipe)
               for op in ("min", "max", "eq", "gt", "gteq", "lt", "lteq", "add", "sub", "mul", "div", "rem")]
    handles.append(TK.power(x, y, pipeline=pipe))
    lib = _compile_host(pipe.plan().host_source, tmp_path)
    assert _run_host(pipe, lib, {handles[-1]._node_id: 2e-6}) == 1


def test_every_pair_the_table_claims_generates_code():
    """Each (op, operand dtypes, target dtype) that RULES accepts, recorded
    as a node of its own in one synthetic signature, lands in a fused group
    whose kernel and host code name it; the others are not claimed."""
    import itertools

    from arrow_tpu_torch import dtypes as dt

    types = list(dt.ArrowType)
    nodes, inputs, claimed = [], [], 0
    for op, rule in sorted(fusion.RULES.items()):
        targets = types if op in ("cast", "bitcast") else [None]
        for ts in itertools.product(types, repeat=len(rule.positions)):
            for to in targets:
                params = {} if to is None else {"to": to}
                if not rule.accepts(list(ts), params):
                    continue
                refs = []
                for t, pos in zip(ts, rule.positions):
                    refs.append(("input", len(inputs)))
                    inputs.append((t, "array" if pos == "row" else "host", 0 if pos == "row" else -1))
                oid = len(nodes)
                nodes.append(fusion.SigNode(op, tuple(refs), tuple(sorted(params.items())), (oid,),
                                            ((rule.out_dtype(ts[0], params), 0),)))
                claimed += 1
    p = fusion.plan.__wrapped__((tuple(nodes), tuple(inputs), tuple(range(len(nodes)))))
    assert not any(isinstance(s, fusion.Boundary) for s in p.steps)
    assert sorted(i for g in p.groups for i in g.nodes) == list(range(claimed))
    assert sum(len(g.outputs) for g in p.groups) == claimed > 500
    for g in p.groups:
        assert f"{g.symbol}_kernel" in p.source and f'extern "C" void {g.symbol}(' in p.host_source
        assert all(f"v{i} = " in p.source for i in g.nodes)
    assert "math_sqrt" in fusion.RULES and "sum" not in fusion.RULES and "take" not in fusion.RULES
