"""join_indices / hash_join of arrow_tpu_torch against arrow_tpu.compute,
compared as pair sets (output order is implementation-defined): both emits
of each package through ARROW_TPU_JOIN_EMIT, duplicate keys on both sides,
null keys, empty sides, u64 keys that narrow to one u32 plane and u64 keys
that do not, i64 negatives, the co-sort on the radix route, the merge
emit's two paths (one-match for unique matched build keys, merge-expand for
a repeated one) and their index planes; hash_join's
one take of every output column against ``ops.take`` of each; and the
``merge_len`` group-by under ARROW_TPU_FORCE_MERGE=1 against the JAX
package's.  Exact."""

import functools
import os

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import compute as JC
from arrow_tpu.table import RecordBatch as JBatch
import arrow_tpu_torch as att
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch import kernels as TK
from arrow_tpu_torch.compute import join as TJ
from arrow_tpu_torch.compute import kernels as TCK
from arrow_tpu_torch.compute.kernels import merge as TM
from torch_helpers import assert_same, batch_to_torch, jax_to_torch

NB, NP = 300, 500


def _keys(rng, name, n, domain, null_p):
    if name == "int64":
        vals = rng.integers(-domain, domain, n)
    elif name == "uint64_wide":
        vals = (rng.integers(0, domain, n).astype(np.uint64) << np.uint64(33)) | np.uint64(5)
    else:
        vals = rng.integers(0, domain, n).astype(np.dtype(name.split("_")[0]))
        if name == "uint32":
            vals = vals + np.uint32(2**31 - domain // 2)  # both sides of 2^31
    t = at.ArrowType(name.split("_")[0])
    if not null_p:
        return at.PrimitiveArray.from_slice(vals, dtype=t)
    valid = rng.random(n) >= null_p
    return at.PrimitiveArray.from_optional_slice([v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=t)


CASES = {  # name -> (key type, domain, build null share, probe null share)
    "u32_dups": ("uint32", 40, 0.0, 0.0),
    "u32_nulls": ("uint32", 40, 0.2, 0.3),
    "i64_negative": ("int64", 30, 0.1, 0.0),
    "u64_narrow": ("uint64", 60, 0.0, 0.0),
    "u64_wide": ("uint64_wide", 25, 0.0, 0.1),
    "no_match": ("int32", 10, 0.0, 0.0),
    # built below: unique build keys (probe misses and nulls); unique matched
    # build keys beside repeated unmatched ones; one repeated matched key
    "unique_build": ("int32", 2 * NB, 0.1, 0.2),
    "unique_matched": ("uint32", NB // 2 + 50, 0.0, 0.1),
    "one_repeat": ("int64", NB, 0.0, 0.0),
}
#: case -> whether every matched probe row meets one build row, so that the
#: merge emit takes its one-match path
ONE_MATCH = {"unique_build": True, "unique_matched": True, "one_repeat": False, "u32_nulls": False}


def _array(vals, name, valid=None):
    t = at.ArrowType(name)
    if valid is None:
        return at.PrimitiveArray.from_slice(vals.astype(np.dtype(name)), dtype=t)
    return at.PrimitiveArray.from_optional_slice(
        [v if ok else None for v, ok in zip(vals.astype(np.dtype(name)).tolist(), valid)], dtype=t
    )


def _one_match_case(case, rng):
    name, domain, bnull, pnull = CASES[case]
    if case == "unique_build":
        bvals = rng.permutation(NB)
    elif case == "unique_matched":  # and keys 1000-1009 15 times each, never probed
        bvals = rng.permutation(np.concatenate([np.arange(NB // 2), np.repeat(np.arange(1000, 1010), 15)]))
    else:  # one_repeat: unique keys around zero, and key 7 twice
        bvals = rng.permutation(np.concatenate([np.arange(NB - 1) - NB // 2, [7]]))
    pvals = rng.integers(0, domain, NP) - (NB // 2 if case == "one_repeat" else 0)
    if case == "one_repeat":
        pvals[rng.integers(0, NP)] = 7
    bvalid = rng.random(bvals.shape[0]) >= bnull if bnull else None
    pvalid = rng.random(NP) >= pnull if pnull else None
    return _array(bvals, name, bvalid), _array(pvals, name, pvalid)


def _case(case):
    name, domain, bnull, pnull = CASES[case]
    rng = np.random.default_rng(len(case))
    if case in ONE_MATCH and not case.startswith("u32"):
        return _one_match_case(case, rng)
    build = _keys(rng, name, NB, domain, bnull)
    probe = _keys(rng, name, NP, domain, pnull)
    if case == "no_match":
        probe = at.Int32Array.from_slice(rng.integers(100, 200, NP).astype(np.int32))
    return build, probe


def _pairs(pi, bi, t):
    assert pi.length == bi.length == t
    return sorted(zip(pi.raw_values().tolist(), bi.raw_values().tolist()))


@functools.lru_cache(maxsize=None)
def _jax_pairs(case, emit="legacy"):
    build, probe = _case(case)
    saved = os.environ.get("ARROW_TPU_JOIN_EMIT")
    os.environ["ARROW_TPU_JOIN_EMIT"] = emit
    try:
        return _pairs(*JC.join_indices(build, probe))
    finally:
        if saved is None:
            os.environ.pop("ARROW_TPU_JOIN_EMIT")
        else:
            os.environ["ARROW_TPU_JOIN_EMIT"] = saved


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("emit", ["legacy", "merge"])
def test_join_indices_match_jax(case, emit, monkeypatch):
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", emit)
    if case == "u64_narrow":  # narrow at any size, so the one-plane co-sort runs
        monkeypatch.setattr(TJ, "NARROW_MIN_ROWS", 0)
        assert TJ._narrow_ok(*(jax_to_torch(a) for a in _case(case)))
    build, probe = _case(case)
    got = _pairs(*TC.join_indices(jax_to_torch(build), jax_to_torch(probe)))
    assert got == _jax_pairs(case)
    assert (len(got) == 0) == (case == "no_match")


def test_jax_merge_emit_agrees():
    """The JAX package's own merge-expand emit gives the same pair set."""
    assert _jax_pairs("u32_dups", "merge") == _jax_pairs("u32_dups")


def test_expand_fills_three_planes_in_one_scan(monkeypatch):
    """The merge-expand emit fills (key, probe row, lo) with one B2 call of
    three planes, as the JAX package's ``segscan_pallas((kt, m1, m2), ...)``
    does."""
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", "merge")
    planes_per_call = []
    multi = TCK.segmented_scan_multi

    def spy(planes, *args):
        planes_per_call.append(len(planes))
        return multi(planes, *args)

    monkeypatch.setattr(TCK, "segmented_scan_multi", spy)
    build, probe = _case("u32_dups")
    assert _pairs(*TC.join_indices(jax_to_torch(build), jax_to_torch(probe))) == _jax_pairs("u32_dups")
    assert planes_per_call == [3]


def test_radix_cosort_route(monkeypatch):
    """The co-sort on kernel B3's route (CUDA at scale) gives the same pairs;
    here the gate is opened for the CPU, where B3 runs its plain version."""
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", "merge")
    monkeypatch.setattr(TJ, "_radix_cosort", lambda rows, device: True)
    for case in ("u32_dups", "u32_nulls", "unique_matched"):
        build, probe = _case(case)
        assert _pairs(*TC.join_indices(jax_to_torch(build), jax_to_torch(probe))) == _jax_pairs(case)


def _refuse(name):
    def call(*args, **kwargs):
        raise AssertionError(f"{name} ran")
    return call


@pytest.mark.parametrize("case", list(ONE_MATCH))
def test_merge_emit_path(case, monkeypatch):
    """The merge emit takes its one-match path (no B7 expand, no rank fill)
    exactly when every matched probe row meets one build row, repeated
    unmatched build keys included, and the merge-expand path for a repeated
    matched build key; either gives the JAX package's pairs and the legacy
    emit's, on index planes of ``_bucket(total)`` rows, zero past total."""
    build, probe = (jax_to_torch(k) for k in _case(case))
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", "legacy")
    legacy = _pairs(*TC.join_indices(build, probe))
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", "merge")
    for name in ("_expand", "_rank_fill") if ONE_MATCH[case] else ("_one_match",):
        monkeypatch.setattr(TJ, name, _refuse(name))
    pi, bi, total = TC.join_indices(build, probe)
    assert _pairs(pi, bi, total) == legacy == _jax_pairs(case)
    assert total > 0
    for plane in (pi.data, bi.data):
        assert plane.shape[0] == TJ._bucket(total) and not plane[total:].any()


def test_legacy_emit_on_merge_sorts(monkeypatch):
    """Under ARROW_TPU_FORCE_MERGE=1 probe_bounds and build_order sort on
    merge_lex_sort (kernel B7's route), 64-bit keys as two limbs."""
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", "legacy")
    monkeypatch.setenv("ARROW_TPU_FORCE_MERGE", "1")
    for case in ("u64_wide", "i64_negative", "u32_dups"):
        build, probe = _case(case)
        assert _pairs(*TC.join_indices(jax_to_torch(build), jax_to_torch(probe))) == _jax_pairs(case)


@pytest.mark.parametrize("emit", ["legacy", "merge"])
def test_join_empty_sides(emit, monkeypatch):
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", emit)
    some = at.UInt32Array.from_slice(np.arange(10, dtype=np.uint32))
    none = at.UInt32Array.from_slice(np.zeros(0, np.uint32))
    for b, p in ((none, some), (some, none), (none, none)):
        pi, bi, t = TC.join_indices(jax_to_torch(b), jax_to_torch(p))
        assert t == 0 and pi.length == 0 and bi.length == 0
        assert JC.join_indices(b, p)[2] == 0


def _rows(batch):
    d = batch.to_pydict()
    return sorted(zip(*(d[c] for c in batch.column_names)), key=repr)


@pytest.mark.parametrize("emit", ["legacy", "merge"])
def test_hash_join_matches_jax(emit, monkeypatch):
    rng = np.random.default_rng(5)
    left = JBatch({
        "k": _keys(rng, "uint32", NP, 40, 0.1),
        "v": at.Float32Array.from_slice(rng.standard_normal(NP).astype(np.float32)),
        "x": at.Int64Array.from_slice(rng.integers(-9, 9, NP)),
    })
    right = JBatch({
        "key": _keys(rng, "uint32", NB, 40, 0.0),
        "x": at.BooleanArray.from_slice((rng.random(NB) < 0.5).tolist()),
    })
    want = JC.hash_join(left, right, "k", "key")
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", emit)
    got = TC.hash_join(batch_to_torch(left), batch_to_torch(right), "k", "key")
    assert got.column_names == want.column_names == ["k", "v", "x_l", "key", "x_r"]
    assert _rows(got) == _rows(want)


def _payload(rng, name, n, null_p):
    """A CPU column of `n` rows of type `name` with a `null_p` share of nulls."""
    if name == "bool":
        vals = (rng.random(n) < 0.5).tolist()
        return (att.BooleanArray.from_optional_slice([v if ok else None for v, ok in zip(vals, rng.random(n) >= null_p)],
                                                       device="cpu") if null_p
                else att.BooleanArray.from_slice(vals, device="cpu"))
    vals = rng.integers(-100, 100, n).astype(name) if name[0] in "iu" else rng.standard_normal(n).astype(name)
    t = att.ArrowType(name)
    if not null_p:
        return att.PrimitiveArray.from_slice(vals, dtype=t, device="cpu")
    valid = rng.random(n) >= null_p
    return att.PrimitiveArray.from_optional_slice([v if ok else None for v, ok in zip(vals.tolist(), valid)],
                                                    dtype=t, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("emit", ["legacy", "merge"])
def test_hash_join_take_equals_a_take_per_column(case, emit, monkeypatch):
    """hash_join's one take of every output column gives the batch that
    join_indices and ``ops.take`` of each column give, bit for bit: every
    element width, BOOL, validity or none, both sides, both emits."""
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", emit)
    build, probe = (jax_to_torch(k) for k in _case(case))
    rng = np.random.default_rng(len(case) + 11)
    left = att.RecordBatch({
        "k": probe, "v": _payload(rng, "float64", NP, 0.2), "b": _payload(rng, "bool", NP, 0.0),
        "s": _payload(rng, "int16", NP, 0.1), "x": _payload(rng, "uint8", NP, 0.0),
    })
    right = att.RecordBatch({
        "k": build, "w": _payload(rng, "float32", NB, 0.3), "b": _payload(rng, "bool", NB, 0.2),
        "x": _payload(rng, "int64", NB, 0.0),
    })
    got = TC.hash_join(left, right, "k", "k")
    pi, bi, total = TC.join_indices(build, probe)
    want = {"k": TK.take(probe, pi), "v": TK.take(left["v"], pi), "b_l": TK.take(left["b"], pi),
            "s": TK.take(left["s"], pi), "x_l": TK.take(left["x"], pi), "w": TK.take(right["w"], bi),
            "b_r": TK.take(right["b"], bi), "x_r": TK.take(right["x"], bi)}
    assert got.column_names == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype is w.dtype and g.length == w.length == total, name
        assert g.data.dtype == w.data.dtype and torch.equal(g.data.view(torch.uint8), w.data.view(torch.uint8)), name
        assert (g.validity is None) == (w.validity is None), name
        assert g.validity is None or torch.equal(g.validity, w.validity), name


@pytest.mark.parametrize("vname", ["float32", "uint16"])
def test_merge_len_groupby_matches_jax(vname, monkeypatch):
    monkeypatch.setenv("ARROW_TPU_FORCE_MERGE", "1")
    rng = np.random.default_rng(9)
    n = 16384 - 300
    keys = at.UInt32Array.from_slice(rng.integers(2**31 - 100, 2**31 + 100, n).astype(np.uint32))
    vals = rng.standard_normal(n) * 100 if vname == "float32" else rng.integers(0, 1000, n)
    valid = rng.random(n) >= 0.2
    col = at.PrimitiveArray.from_optional_slice(
        [v if ok else None for v, ok in zip(vals.astype(vname).tolist(), valid)], dtype=at.ArrowType(vname)
    )
    spec = [("s", "sum"), ("mx", "max")]
    want = JC.hash_aggregate(keys, [(o, col, a) for o, a in spec] + [("rows", None, "count")], method="sort")
    tcol = jax_to_torch(col)
    passes = []
    plain = TM.merge_pass_plain
    monkeypatch.setattr(TM, "merge_pass_plain", lambda *a: passes.append(a[1]) or plain(*a))
    got = TC.hash_aggregate(jax_to_torch(keys), [(o, tcol, a) for o, a in spec] + [("rows", None, "count")])
    assert passes == [8192]  # runs of 8192 and 7892 rows: one B7 pass
    assert got.column_names == want.column_names
    for name in want.column_names:
        assert_same(want[name], got[name], rtol=1e-6 if vname == "float32" else None)
