"""Kernel B7's plain version (arrow_tpu_torch ``merge_pass_plain``) and
``sort_kv`` against arrow_tpu's ``merge_pass_pallas`` / ``sort_kv_pallas``
in interpret mode, at n in {8192, 3 x 8192} (a bye in the last pair), with
heavy duplicates, the int32 extremes, payload planes and the unique-payload
mode, and on one pair of 8192-row runs of each edge shape of
``torch_helpers.merge_edge_planes``.  Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu.compute.kernels.merge import merge_pass_pallas, sort_kv_pallas
from arrow_tpu_torch.compute import kernels as TCK
from arrow_tpu_torch.compute.kernels import merge as M
from torch_helpers import MERGE_PATTERNS, merge_edge_planes

RUN = 8192


def _sorted_runs(rng, n, unique, nplanes):
    keys = rng.choice(np.array([-(2**31), -5, 0, 1, 7, 2**31 - 2, 2**31 - 1], np.int32), n)
    rows = np.arange(n, dtype=np.int32)
    for lo in range(0, n, RUN):
        o = np.argsort(keys[lo : lo + RUN], kind="stable")
        keys[lo : lo + RUN] = keys[lo : lo + RUN][o]
        rows[lo : lo + RUN] = rows[lo : lo + RUN][o]
    extra = [rng.integers(-(2**31), 2**31, n).astype(np.int32) for _ in range(nplanes - 2)]
    return [keys, rows, *extra][:nplanes] if not unique else [keys, rows]


@pytest.mark.parametrize("n,unique,nplanes", [
    (RUN, False, 1), (3 * RUN, False, 3), (3 * RUN, True, 2), (2 * RUN, True, 2),
])
def test_merge_pass_plain_matches_pallas(n, unique, nplanes):
    rng = np.random.default_rng(n + nplanes)
    planes = _sorted_runs(rng, n, unique, nplanes)
    want = merge_pass_pallas(tuple(jnp.asarray(p) for p in planes), RUN, unique_payload=unique, interpret=True)
    got = M.merge_pass_plain([torch.from_numpy(p) for p in planes], RUN, unique)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("pattern", MERGE_PATTERNS)
@pytest.mark.parametrize("unique", [False, True])
def test_merge_pass_plain_matches_pallas_on_edge_patterns(pattern, unique):
    planes = merge_edge_planes(pattern, 2 * RUN, RUN, unique)
    want = merge_pass_pallas(tuple(jnp.asarray(p) for p in planes), RUN, unique_payload=unique, interpret=True)
    got = M.merge_pass_plain([torch.from_numpy(p) for p in planes], RUN, unique)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("key_dtype,unique,length", [
    ("float32", False, None), ("int32", True, 3 * RUN - 1000), ("uint32", True, 3 * RUN - 1000),
])
def test_sort_kv_matches_pallas(key_dtype, unique, length):
    rng = np.random.default_rng(3)
    n = 3 * RUN
    if key_dtype == "float32":
        keys = rng.choice(np.array([-1.5, 0.0, 2.0, np.inf, -np.inf], np.float32), n)
    else:
        keys = rng.integers(0, 40, n).astype(key_dtype)
        keys[:3] = np.iinfo(key_dtype).max
    rows = np.arange(n, dtype=np.uint32)
    payloads = (rows,) if unique else (rows, rng.standard_normal(n).astype(np.float32))
    wk, wps = sort_kv_pallas(
        jnp.asarray(keys), tuple(jnp.asarray(p) for p in payloads), length=length,
        unique_payload=unique, interpret=True,
    )
    tkeys = torch.from_numpy(keys.view(np.int32) if key_dtype == "uint32" else keys)
    tpays = [torch.from_numpy(p.view(np.int32) if p.dtype == np.uint32 else p) for p in payloads]
    gk, gps = TCK.sort_kv(tkeys, tpays, length, unique, unsigned=key_dtype == "uint32")
    live = slice(0, length or n)  # rows past `length` are implementation-defined
    np.testing.assert_array_equal(gk.numpy().view(keys.dtype)[live], np.asarray(wk)[live])
    for g, w in zip(gps, wps):
        np.testing.assert_array_equal(g.numpy().view(np.asarray(w).dtype)[live], np.asarray(w)[live])


def test_sort_kv_with_more_payloads_than_a_pass_moves():
    rng = np.random.default_rng(4)
    n = 2 * RUN + 77
    keys = rng.integers(0, 30, n).astype(np.int32)
    pays = [rng.integers(-(2**31), 2**31, n).astype(np.int32) for _ in range(M.MAX_PLANES)]
    gk, gps = TCK.sort_kv(torch.from_numpy(keys), [torch.from_numpy(p) for p in pays], n - 50)
    order = np.argsort(keys[: n - 50], kind="stable")
    np.testing.assert_array_equal(gk.numpy()[: n - 50], keys[order])
    for g, p in zip(gps, pays):
        np.testing.assert_array_equal(g.numpy()[: n - 50], p[order])


def test_sortable_i32_round_trips_and_orders():
    f = np.array([-np.nan, -np.inf, -1.0, -0.0, 0.0, 1.0, np.inf, np.nan], np.float32)
    u = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    for vals, unsigned in ((f, False), (u, True)):
        t = torch.from_numpy(vals.view(np.int32) if unsigned else vals)
        k = M.to_sortable_i32(t, unsigned)
        assert (np.diff(k.numpy().astype(np.int64)) > 0).all()  # strictly ascending
        back = M.from_sortable_i32(k, t.dtype, unsigned)
        assert back.numpy().tobytes() == t.numpy().tobytes()


def test_merge_pass_rejects_what_it_does_not_take():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        M.merge_pass_plain([k.float()], 4)
    with pytest.raises(ValueError):
        M.merge_pass_plain([k, k, k], 4, unique_payload=True)
    with pytest.raises(ValueError):
        M.merge_pass_plain([k], 0)
    with pytest.raises(ValueError):
        M.merge_pass_plain([k] * 9, 4)
