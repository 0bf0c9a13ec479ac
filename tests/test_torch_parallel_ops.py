"""arrow_tpu_torch.parallel's aggregate and joins against arrow_tpu.parallel.

The scenarios, the spawned worlds and the comparisons are
test_torch_parallel.py's (see its docstring); this module runs its
aggregate and join scenarios in worlds of their own, so that the two modules
run side by side under pytest-xdist.  distributed_aggregate (with and
without pre-aggregation, null keys, the 95%-skew case) compares exactly
shard by shard, float sums within rtol 1e-6 (f32) and means within 1e-12
(f64); the joins compare as pair or row multisets a shard.
"""

import numpy as np
import pytest

import test_torch_parallel as base


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    worlds = base.launch_worlds(tmp_path_factory.mktemp("port_ranks_ops"), base.OPS_SCENARIOS)
    yield worlds
    base.join_worlds(worlds)


@pytest.mark.parametrize("world", base.WORLDS)
@pytest.mark.parametrize("scenario", ["agg_pre", "agg_raw", "agg_skew"])
def test_aggregate_shards_match_jax(port, scenario, world):
    """distributed_aggregate: every shard's groups (keys, sums, counts,
    min/max, means) equal the JAX package's shard, in its column order."""
    base.assert_shards_match(port, scenario, world)


@pytest.mark.parametrize("world", base.WORLDS)
@pytest.mark.parametrize("scenario", ["join_fused", "join_unfused"])
def test_join_rows_match_jax(port, scenario, world):
    """distributed_join, fused and unfused: each shard's rows as a multiset
    equal to the JAX package's fused join's (whose rows its unfused join
    gives too, tests/test_parallel.py), the suffixed column names, and
    fused == unfused."""
    want = base.jax_result("join_fused", base.shard_count(world))
    for r, (want_arrays, want_meta) in enumerate(want):
        got_arrays, got_meta = port[world].rank(scenario, r)
        assert "error" not in got_meta, got_meta.get("error")
        assert got_meta["columns"] == want_meta["columns"] == ["k", "lv", "x_l", "rv", "x_r"]
        assert got_meta["counts"] == want_meta["counts"] and got_meta["tails_zero"]
        assert base.row_multiset(got_arrays, got_meta["columns"]) == base.row_multiset(want_arrays, want_meta["columns"])
        other = port[world].rank("join_unfused" if scenario == "join_fused" else "join_fused", r)[0]
        assert base.row_multiset(got_arrays, got_meta["columns"]) == base.row_multiset(other, got_meta["columns"])


@pytest.mark.parametrize("world", base.WORLDS)
def test_join_indices_pairs_match_jax(port, world):
    """distributed_join_indices: each shard's (probe lv, build rv) pairs as a
    multiset, and the match counts."""
    want = base.jax_result("join_idx", base.shard_count(world))
    total = 0
    for r, (want_arrays, want_meta) in enumerate(want):
        got_arrays, got_meta = port[world].rank("join_idx", r)
        assert got_meta["counts"] == want_meta["counts"]
        assert sorted(map(tuple, got_arrays["pairs"].tolist())) == sorted(map(tuple, want_arrays["pairs"].tolist()))
        total += len(got_arrays["pairs"])
    left, right = base.join_left(), base.join_right()
    per_key = np.bincount(right["k"][1].astype(np.int64), minlength=500)
    assert total == int(per_key[left["k"][1].astype(np.int64)].sum())
