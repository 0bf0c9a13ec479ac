"""join_indices / hash_join of arrow_tpu_torch against arrow_tpu.compute,
compared as pair sets (output order is implementation-defined): both emits
of each package through ARROW_TPU_JOIN_EMIT, duplicate keys on both sides,
null keys, empty sides, u64 keys that narrow to one u32 plane and u64 keys
that do not, i64 negatives, the co-sort on the radix route; and the
``merge_len`` group-by under ARROW_TPU_FORCE_MERGE=1 against the JAX
package's.  Exact."""

import functools
import os

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu import compute as JC
from arrow_tpu.table import RecordBatch as JBatch
from arrow_tpu_torch import compute as TC
from arrow_tpu_torch.compute import join as TJ
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
}


def _case(case):
    name, domain, bnull, pnull = CASES[case]
    rng = np.random.default_rng(len(case))
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


def test_radix_cosort_route(monkeypatch):
    """The co-sort on kernel B3's route (CUDA at scale) gives the same pairs;
    here the gate is opened for the CPU, where B3 runs its plain version."""
    monkeypatch.setenv("ARROW_TPU_JOIN_EMIT", "merge")
    monkeypatch.setattr(TJ, "_radix_cosort", lambda rows, device: True)
    for case in ("u32_dups", "u32_nulls"):
        build, probe = _case(case)
        assert _pairs(*TC.join_indices(jax_to_torch(build), jax_to_torch(probe))) == _jax_pairs(case)


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
