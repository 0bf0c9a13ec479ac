"""arrow_tpu_torch.tools (dist_sort_1b, scaling_bench, overlap_ab) on the
CPU, and the rank spawner's backend.

The tools' own code runs on P spawned gloo ranks (``parallel.dryrun.launch``,
P = 1, 2 and 4, all worlds started at the module's first test): each rank
runs dist_sort_1b's ``run`` with and without the payload, scaling_bench's
three operators and overlap_ab's ``run``, writes what it got to an .npz and
a .json, and checks that it never imported jax.  The JAX side runs in the
pytest process on a mesh of P of conftest.py's 8 virtual CPU devices, on the
same numpy data.  Each tool's command line also runs once, as ``python -m``
with jax blocked, into ``tmp_path``; its ranks check too that they never
imported jax.

Tolerance: exact everywhere (keys, payloads, counts, group sums); join
pairs as row multisets a shard (their emit order is implementation-defined).
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import arrow_tpu_torch as att
from arrow_tpu_torch.parallel import dryrun as TD
from arrow_tpu_torch.parallel.mesh import MeshRuntime
from arrow_tpu_torch.tools import common
from arrow_tpu_torch.tools import dist_sort_1b as DS
from arrow_tpu_torch.tools import overlap_ab as OA
from arrow_tpu_torch.tools import scaling_bench as SB
from torch_helpers import make_pair, sharded_to_numpy

WORLDS = (1, 2, 4)
HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
RANK_TIMEOUT = 240.0
SORT_ROWS = 1 << 12  # dist_sort_1b's rows a rank
SCALING_ROWS = 4096  # scaling_bench's rows a shard
OVERLAP_ROWS = 1 << 10  # overlap_ab's rows a side
SCALING_OPS = tuple(SB.OPS)

# the JAX scripts' report keys
DIST_SORT_1B_KEYS = json.loads((ROOT / "DIST_SORT_1B.json").read_text()).keys() - {"infeasible_at_1b_on_this_host"}
SCALING_KEYS = json.loads((ROOT / "SCALING.json").read_text()).keys()
OVERLAP_AB_KEYS = json.loads((ROOT / "OVERLAP_AB.json").read_text()).keys()
PORT_FIELDS = {"device", "backend", "shared_card", "gpu"}


# ---------------------------------------------------------------------------
# the port's side: one spawned rank
# ---------------------------------------------------------------------------


def _join_rows(res, rank):
    """A join_indices result's pairs on this rank as rows (probe k, probe v,
    build v), sorted."""
    counts, pidx, bidx, pb, pp = res
    k = int(counts[rank])
    p, b = pidx.data[:k].long(), bidx.data[:k].long()
    rows = torch.stack([pp.columns["k"].data[p].long() & 0xFFFFFFFF, pp.columns["v"].data[p].long(),
                        pb.columns["v"].data[b].long()], 1).numpy()
    return rows[np.lexsort(rows.T[::-1])]


def tools_rank(outdir: str) -> None:
    """One rank: the tools' functions on this rank's shards; writes
    rank<r>.npz (shards) and rank<r>.json (reports)."""
    rt = MeshRuntime.create(devices="cpu")
    arrays, meta = {}, {}
    for payload in (False, True):
        report, out = DS.run(rt, SORT_ROWS, payload)
        meta[f"sort{int(payload)}"] = report
        arrays.update({f"sort{int(payload)}|{k}": v for k, v in TD.shard_prefix(out).items()})
    sb = SB.shard_batch(rt, SCALING_ROWS)
    for name, op in SB.OPS.items():
        res = op(sb)
        if name == "dist_join":
            arrays[f"{name}|rows"] = _join_rows(res, rt.rank)
        else:
            arrays.update({f"{name}|{k}": v for k, v in TD.shard_prefix(res).items()})
            meta[name] = {"counts": res.counts.tolist(), "columns": res.column_names}
    meta["overlap"] = OA.run(rt, OVERLAP_ROWS)
    np.savez(pathlib.Path(outdir) / f"rank{rt.rank}.npz", **arrays)
    common.write_rank(outdir, rt.rank, meta)  # raises if this rank imported jax


class World:
    def __init__(self, outdir: pathlib.Path, p: int, ranks):
        self._outdir, self._p, self._ranks, self._loaded = outdir, p, ranks, None

    def rank(self, r):
        if self._loaded is None:
            self._ranks.join()
            self._loaded = []
            for s in range(self._p):
                with np.load(self._outdir / f"rank{s}.npz") as z:
                    arrays = {k: z[k] for k in z.files}
                self._loaded.append((arrays, json.loads((self._outdir / f"rank{s}.json").read_text())))
        return self._loaded[r]

    def arrays(self, r, prefix):
        arrays = self.rank(r)[0]
        return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "|")}


#: each tool's command line, run once with jax blocked: (module, arguments)
CLI = {
    "dist_sort_1b": ["--device", "cpu", "--rows-per-shard", str(SORT_ROWS), "--payload", "--procs", "2"],
    "scaling_bench": ["--device", "cpu", "--procs", "1", "2", "--rows-per-shard", str(SCALING_ROWS),
                      "--iters", "1"],
    "overlap_ab": ["--cpu", "--procs", "2", "--rows", str(OVERLAP_ROWS)],
}
BLOCK_JAX = ("import runpy, sys; sys.modules['jax'] = None; sys.argv = sys.argv[1:]; "
             "runpy.run_module(sys.argv[0], run_name='__main__')")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """P -> World, and tool -> (Popen of its command line, its report path):
    every spawned world and command line started at once."""
    root = tmp_path_factory.mktemp("tools")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    clis = {}
    for tool, argv in CLI.items():
        out = root / f"{tool}.json"
        clis[tool] = (subprocess.Popen([sys.executable, "-c", BLOCK_JAX, f"arrow_tpu_torch.tools.{tool}", *argv,
                                        "--out", str(out)], env=env, cwd=str(root), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), out)
    result = {}
    for p in WORLDS:
        out = root / f"p{p}"
        out.mkdir()
        with pytest.MonkeyPatch.context() as mp:  # the ranks import this module
            mp.setenv("PYTHONPATH", os.pathsep.join([str(HERE), os.environ.get("PYTHONPATH", "")]))
            ranks = TD.launch(f"{__name__}:tools_rank", p, [str(out)], device="cpu", timeout=RANK_TIMEOUT)
        result[p] = World(out, p, ranks)
    yield result, clis
    for proc, _ in clis.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    for w in result.values():
        w._ranks.kill()


def _cli_report(worlds, tool):
    proc, path = worlds[1][tool]
    log, _ = proc.communicate(timeout=RANK_TIMEOUT)
    assert proc.returncode == 0, log.decode(errors="replace")[-4000:]
    return json.loads(path.read_text())


# ---------------------------------------------------------------------------
# the JAX package's side, in this process
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_mesh(p):
    from arrow_tpu import parallel as JPP

    return JPP.MeshRuntime.create(num_devices=p)


def _jax_sharded(p, columns, capacity):
    from arrow_tpu import parallel as JPP
    from arrow_tpu.table import RecordBatch

    batch = RecordBatch({name: make_pair(typ, vals)[0] for name, (typ, vals) in columns.items()})
    return JPP.shard_batch(batch, _jax_mesh(p), capacity=capacity)


@functools.lru_cache(maxsize=None)
def jax_sorted(p, payload):
    """The JAX package's distributed_sort of dist_sort_1b's data at P = p."""
    from arrow_tpu import parallel as JPP

    keys = np.concatenate([DS.draw_keys(r, SORT_ROWS, "cpu").numpy().view(np.uint32) for r in range(p)])
    cols = {"k": ("uint32", keys)}
    if payload:
        cols["v"] = ("uint32", np.arange(p * SORT_ROWS, dtype=np.uint32))
    out = JPP.distributed_sort(_jax_sharded(p, cols, SORT_ROWS), "k", out_capacity=SORT_ROWS * 3 // 2)
    return sharded_to_numpy(out)


@functools.lru_cache(maxsize=None)
def jax_scaling(p, op):
    """The JAX scaling worker's operator on scaling_bench's data at P = p:
    (counts, shards), or for dist_join each shard's pair rows."""
    from arrow_tpu import parallel as JPP

    keys, vals = [], []
    for r in range(p):  # SB.shard_batch's draw, rank by rank
        rng = np.random.default_rng(r)
        keys.append(rng.integers(0, SB.KEY_DOMAIN, SCALING_ROWS).astype(np.uint32))
        vals.append(rng.integers(0, SB.VALUE_DOMAIN, SCALING_ROWS).astype(np.int32))
    sb = _jax_sharded(p, {"k": ("uint32", np.concatenate(keys)), "v": ("int32", np.concatenate(vals))},
                      SCALING_ROWS)
    if op == "dist_sort":
        return sharded_to_numpy(JPP.distributed_sort(sb, "k", check=False))
    if op == "dist_agg":
        return sharded_to_numpy(JPP.distributed_aggregate(sb, "k", [("s", "v", "sum")]))
    counts, pidx, bidx, pb, pp = JPP.distributed_join_indices(sb, sb, "k", "k", out_capacity=4 * SCALING_ROWS,
                                                              check=False)
    pk, pv, bv = (np.asarray(c.data) for c in (pp.columns["k"], pp.columns["v"], pb.columns["v"]))
    pi, bi = np.asarray(pidx.data), np.asarray(bidx.data)
    shards = []
    for s, k in enumerate(np.asarray(counts)):
        rows = np.stack([pk[s][pi[s, :k]].astype(np.int64), pv[s][pi[s, :k]].astype(np.int64),
                         bv[s][bi[s, :k]].astype(np.int64)], 1)
        shards.append(rows[np.lexsort(rows.T[::-1])])
    return shards


def _assert_shards(world, prefix, counts, shards):
    for r, want in enumerate(shards):
        got = world.arrays(r, prefix)
        assert sorted(got) == sorted(want), r
        for name in want:
            assert got[name].dtype == want[name].dtype, (r, name)
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"rank {r} column {name}")


# ---------------------------------------------------------------------------
# (a) dist_sort_1b against the JAX package's distributed_sort
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("p", WORLDS)
def test_dist_sort_report_is_true(worlds, p, payload):
    """Every check true, on every rank, with the JAX script's keys."""
    for r in range(p):
        report = worlds[0][p].rank(r)[1][f"sort{int(payload)}"]
        assert DIST_SORT_1B_KEYS | PORT_FIELDS <= report.keys()
        assert report["ok"] and report["row_conservation_ok"] and report["globally_sorted_ok"]
        assert report["key_checksum_ok"]
        assert report["payload_follows_key_ok"] is (True if payload else None)
        assert report["stable_order_ok"] is (True if payload else None)
        assert (report["rows_total"], report["shards"], report["with_payload"]) == (p * SORT_ROWS, p, payload)
        assert report["sort_seconds_cpu_mesh"] == report["sort_seconds"] > 0
        assert report["backend"] == (None if p == 1 else "gloo") and report["gpu"] is None
        assert report["launches"] == {} and report["peak_device_bytes"] is None


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("p", WORLDS)
def test_dist_sort_shards_match_jax(worlds, p, payload):
    """Shard by shard, the keys (and payloads) equal the JAX package's
    distributed_sort on the same data with the JAX script's out_capacity."""
    counts, shards = jax_sorted(p, payload)
    for r in range(p):
        assert worlds[0][p].rank(r)[1][f"sort{int(payload)}"]["key_checksum"] == int(
            np.concatenate([s["k"] for s in shards]).astype(np.int64).sum())
    _assert_shards(worlds[0][p], f"sort{int(payload)}", counts, shards)


# ---------------------------------------------------------------------------
# (b) the checks catch a broken sort
# ---------------------------------------------------------------------------


def _swap(t, i, j):
    t[[i, j]] = t[[j, i]]


def _raise_last_key(out):  # the shard stays in order
    out.columns["k"].data[SORT_ROWS - 1] += 1


def _tie(out):
    """The first row whose key equals the next row's."""
    k = out.columns["k"].data[:SORT_ROWS]
    return int(torch.nonzero(k[1:] == k[:-1])[0])


def _copy_payload_over_tie(out):  # both rows of one key hold the same payload
    v, i = out.columns["v"].data, _tie(out)
    v[i + 1] = v[i]


def _swap_tie(out):  # two rows of one key out of their input order
    i = _tie(out)
    _swap(out.columns["v"].data, i, i + 1)


TIED = 64  # a key bound that gives a 4096-row shard many equal keys
FAULTS = {  # fault -> (the keys' bound, how, the checks it must fail)
    "none": (DS.KEY_BOUND, lambda out: None, set()),
    "none_tied": (TIED, lambda out: None, set()),
    "rows_swapped": (DS.KEY_BOUND, lambda out: [_swap(out.columns[c].data, 10, 3000) for c in ("k", "v")],
                     {"globally_sorted_ok", "stable_order_ok"}),
    "key_changed": (DS.KEY_BOUND, _raise_last_key, {"key_checksum_ok", "payload_follows_key_ok"}),
    "payload_moved": (DS.KEY_BOUND, lambda out: _swap(out.columns["v"].data, 10, 3000), {"payload_follows_key_ok"}),
    "payload_duplicated": (TIED, _copy_payload_over_tie, {"stable_order_ok"}),
    "equal_keys_swapped": (TIED, _swap_tie, {"stable_order_ok"}),
}


@functools.lru_cache(maxsize=None)
def _local_sort(key_bound):
    """A world of one's sort of keys below `key_bound` (the caller patches
    DS.KEY_BOUND to it, for the draw and for the checks' draw again)."""
    assert DS.KEY_BOUND == key_bound
    rt = MeshRuntime.create(devices="cpu")
    report, out = DS.run(rt, SORT_ROWS, True)
    return rt, report, out


@pytest.mark.parametrize("fault", list(FAULTS))
def test_checks_fail_on_a_broken_sort(monkeypatch, fault):
    """Two rows swapped break the order, a changed key the checksum and the
    payload check, a payload moved to another key the payload check;
    two rows of one key holding one payload, or swapped, break the stable
    order alone (every other check passes them); an untouched shard passes
    every check."""
    bound, how, fails = FAULTS[fault]
    monkeypatch.setattr(DS, "KEY_BOUND", bound)
    rt, report, out = _local_sort(bound)
    assert report["ok"]
    broken = att.parallel.ShardedBatch({n: att.parallel.ShardedColumn(c.data.clone(), None, c.dtype)
                                        for n, c in out.columns.items()}, out.counts, rt)
    assert broken.columns["k"].data[10] != broken.columns["k"].data[3000]
    how(broken)
    checks = DS.check_sort(rt, broken, SORT_ROWS, True, report["key_checksum"])
    assert {k for k, v in checks.items() if v is False} == fails


# ---------------------------------------------------------------------------
# (c) scaling_bench's operators against the JAX scaling worker's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", SCALING_OPS)
@pytest.mark.parametrize("p", WORLDS)
def test_scaling_ops_match_jax(worlds, p, op):
    """dist_sort's and dist_agg's shards (sorted keys and values; groups and
    sums) equal the JAX package's exactly; dist_join's pairs equal its
    pairs as row multisets a shard."""
    want = jax_scaling(p, op)
    world = worlds[0][p]
    if op == "dist_join":
        for r, rows in enumerate(want):
            np.testing.assert_array_equal(world.arrays(r, op)["rows"], rows, err_msg=f"rank {r}")
        return
    counts, shards = want
    for r in range(p):
        assert world.rank(r)[1][op]["counts"] == counts
    _assert_shards(world, op, counts, shards)


def test_scaling_cli_report(worlds):
    """The command line's sweep (P = 1 and 2) has SCALING.json's keys, each
    op's numbers, P = 1's efficiency 1.0 and P = 2's from the rows/s."""
    report = _cli_report(worlds, "scaling_bench")
    assert SCALING_KEYS <= report.keys()
    assert report["rows_per_shard"] == SCALING_ROWS and report["overhead_decomposition"] == {}
    points = report["sweep"][str(SCALING_ROWS)]
    assert points == report["points"] and sorted(points) == ["1", "2"]
    for op in SCALING_OPS:
        one, two = points["1"][op], points["2"][op]
        assert one["efficiency_vs_linear"] == 1.0 and not one["shared_card"]
        assert two["efficiency_vs_linear"] == pytest.approx(two["rows_per_s"] / (2 * one["rows_per_s"]))
        assert one["rows_per_s"] == pytest.approx(SCALING_ROWS / one["seconds_per_iter"])
    assert report["ranks"]["2"]["backend"] == "gloo" and report["ranks"]["1"]["backend"] is None
    assert report["failed"] == []


def test_sweep_lists_failed_points(monkeypatch):
    """A point that fails is left out of the sweep and listed under
    failed, with its size, P and error."""
    def point(p, rows, iters, device, timeout):
        if p == 2:
            raise RuntimeError("lost")
        return {"ops": {"dist_sort": {"rows": rows, "seconds_per_iter": 1.0, "rows_per_s": float(rows)}},
                "device": device, "backend": None, "shared_card": False, "gpu": None}

    monkeypatch.setattr(SB, "point", point)
    report = SB.sweep([1, 2], [64], 1, "cpu", 10.0)
    assert report["failed"] == [{"rows": 64, "P": 2, "error": "RuntimeError: lost"}]
    assert sorted(report["sweep"]["64"]) == ["1"]


def _point(seconds):
    return {op: {"seconds_per_iter": s} for op, s in seconds.items()}


def test_overhead_decomposition_hand_worked():
    """t = fixed + rows x per-row cost through the smallest and largest
    sizes: 1000 rows in 3 ms and 5000 in 11 ms give 1 ms fixed and 2 ms a
    thousand rows (2000 s a million); a fixed part below 0 is 0."""
    sweep = {"1000": {"1": _point({"a": 0.003, "b": 0.001}), "2": _point({"a": 0.004, "b": 0.002})},
             "3000": {"1": _point({"a": 0.007, "b": 0.0})},
             "5000": {"1": _point({"a": 0.011, "b": 0.009})}}
    got = SB.overhead_decomposition(sweep)
    assert sorted(got) == ["1"]  # P = 2 has no largest size
    a, b = got["1"]["a"], got["1"]["b"]
    assert a["fixed_s"] == pytest.approx(0.001) and a["per_mrow_s"] == pytest.approx(2.0)
    assert a["fixed_fraction_at_small"] == pytest.approx(1 / 3)
    assert a["fixed_fraction_at_large"] == pytest.approx(1 / 11)
    assert b["fixed_s"] == 0.0 and b["per_mrow_s"] == pytest.approx(2.0)
    assert b["fixed_fraction_at_small"] == 0.0 and b["fixed_fraction_at_large"] == 0.0
    assert SB.overhead_decomposition({"1000": sweep["1000"]}) == {}


def test_shared_card_points_get_no_efficiency():
    """P > 1 ranks sharing one card are marked and get no efficiency; P = 1
    gets 1.0."""
    res = {p: {"ops": {"dist_sort": {"rows_per_s": 10.0 * p, "seconds_per_iter": 1.0}}, "shared_card": p > 1}
           for p in (1, 2)}
    points = SB.efficiencies(res)
    assert points["1"]["dist_sort"]["efficiency_vs_linear"] == 1.0
    assert "efficiency_vs_linear" not in points["2"]["dist_sort"] and points["2"]["dist_sort"]["shared_card"]


# ---------------------------------------------------------------------------
# (d) overlap_ab
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", WORLDS)
def test_overlap_report(worlds, p):
    """Fused and composed give the same rows on every rank, the report has
    OVERLAP_AB.json's keys and its top ops, and the route hash is profiled
    where rows are routed (P > 1)."""
    for r in range(p):
        report = worlds[0][p].rank(r)[1]["overlap"]
        assert OVERLAP_AB_KEYS | PORT_FIELDS <= report.keys()
        assert report["fused_equals_composed"] and report["joined_rows"] > 0
        assert report["mesh_devices"] == p and report["rows_per_side"] == OVERLAP_ROWS
        assert report["top_kernels"] and len(report["top_kernels"]) <= OA.TOP
        assert report["fused_speedup"] == pytest.approx(report["composed_s"] / report["fused_s"])
        assert report["profiled_on"] == "cpu"
        assert (report["route_hash_share"] is None) == (p == 1)


def test_overlap_rows_match_numpy(worlds):
    """The joined row count is numpy's: each probe key's build matches."""
    rng = np.random.default_rng(3)
    bk, pk = (rng.integers(0, OVERLAP_ROWS, OVERLAP_ROWS) for _ in range(2))
    want = int(np.bincount(bk, minlength=OVERLAP_ROWS)[pk].sum())
    for p in WORLDS:
        assert worlds[0][p].rank(0)[1]["overlap"]["joined_rows"] == want


# ---------------------------------------------------------------------------
# the command lines, with jax blocked
# ---------------------------------------------------------------------------


def test_dist_sort_cli(worlds):
    report = _cli_report(worlds, "dist_sort_1b")
    assert DIST_SORT_1B_KEYS | PORT_FIELDS <= report.keys()
    assert report["ok"] and report["shards"] == 2 and report["backend"] == "gloo"
    assert report["key_checksum"] == worlds[0][2].rank(0)[1]["sort1"]["key_checksum"]


def test_overlap_cli(worlds):
    report = _cli_report(worlds, "overlap_ab")
    assert OVERLAP_AB_KEYS | PORT_FIELDS <= report.keys()
    assert report["fused_equals_composed"] and report["mesh_devices"] == 2 and report["top_kernels"]


def test_world_of_one_on_the_cpu_joins_no_group():
    """A tool's world of one on the CPU runs without a process group."""
    with common.rank_runtime("cpu") as rt:
        assert rt.num_shards == 1 and not rt.distributed
        assert common.report_fields(rt) == {"device": "cpu", "backend": None, "shared_card": False, "gpu": None}
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# (e) the rank spawner's backend
# ---------------------------------------------------------------------------


class _NoPopen:
    def __init__(self, *a, **k):
        raise AssertionError("a process was spawned")


def test_nccl_refuses_more_ranks_than_gpus(monkeypatch):
    """NCCL takes one GPU a rank: with fewer GPUs than ranks (here none),
    launch raises before it spawns anything."""
    monkeypatch.setattr(TD.subprocess, "Popen", _NoPopen)
    with pytest.raises(att.ArrowTorchError, match="one GPU a rank"):
        TD.launch("time:sleep", 1, [0], backend="nccl")
    with pytest.raises(att.ArrowTorchError, match="not one of"):
        TD.launch("time:sleep", 1, [0], backend="mpi")


@pytest.mark.parametrize("device, procs, gpus, want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 4, 8, "gloo"), ("cuda:0", 1, 1, "nccl"), ("cuda:0", 4, 4, "nccl"),
    ("cuda:0", 4, 1, "gloo"), ("cuda:0", 1, 0, "gloo")])
def test_backend_for(monkeypatch, device, procs, gpus, want):
    """NCCL where the device is a card and each rank can have its own GPU;
    gloo otherwise (the CPU, or ranks sharing a card)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    assert common.backend_for(device, procs) == want


@pytest.mark.parametrize("gloo, backend, rank_device", [(False, "nccl", None), (True, "gloo", "cuda:0")])
def test_run_ranks_picks_the_backend(monkeypatch, gloo, backend, rank_device):
    """run_ranks spawns in backend_for's group unless told gloo, and hands
    each rank the device its group gives it (None: cuda:LOCAL_RANK)."""
    seen = {}

    def spawn(target, procs, args, device, timeout, backend):
        seen.update(args=args, device=device, backend=backend)
        for r in range(procs):
            (pathlib.Path(args[-1]) / f"rank{r}.json").write_text(json.dumps({"rank": r}))

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(common.dryrun, "spawn", spawn)
    got = common.run_ranks("m:f", 2, [7], "cuda:0", 10.0, gloo=gloo)
    assert got == [{"rank": 0}, {"rank": 1}]
    assert seen["backend"] == backend and seen["device"] == rank_device and seen["args"][:2] == [7, rank_device]


class _FakePopen:
    calls = []

    def __init__(self, argv, env, **kwargs):
        self.spec, self.env = json.loads(argv[-1]), env
        _FakePopen.calls.append(self)

    def poll(self):
        return 0

    def kill(self):
        pass

    def wait(self):
        return 0


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_launch_places_ranks(monkeypatch, backend):
    """nccl puts rank r on cuda:r with LOCAL_RANK=r; gloo puts every rank on
    the given device; the spec carries the backend."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(TD.subprocess, "Popen", _FakePopen)
    _FakePopen.calls = []
    TD.launch("time:sleep", 2, [0], device="cpu", backend=backend).kill()
    for r, call in enumerate(_FakePopen.calls):
        assert call.spec["backend"] == backend and call.spec["rank"] == r
        if backend == "nccl":
            assert call.spec["device"] == f"cuda:{r}" and call.env["LOCAL_RANK"] == str(r)
        else:
            assert call.spec["device"] == "cpu" and call.env.get("LOCAL_RANK") == os.environ.get("LOCAL_RANK")


CALLED = []


def record_call(*args):
    CALLED.append(args)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_rank_main_hands_the_backend_on(monkeypatch, backend):
    """rank_main passes the spec's backend to initialize_distributed."""
    seen = {}
    monkeypatch.setattr(TD, "initialize_distributed", lambda *a, **k: seen.update(k, args=a))
    spec = {"target": f"{__name__}:record_call", "rank": 0, "world": 2, "args": [1, "x"], "device": "cpu",
            "backend": backend, "init_method": "file:///nonexistent"}
    monkeypatch.setattr(sys, "argv", ["-c", json.dumps(spec)])
    monkeypatch.setattr(TD.os, "_exit", lambda code: pytest.fail(f"rank_main failed ({code})"))
    threads = torch.get_num_threads()
    CALLED.clear()
    try:
        TD.rank_main()
    finally:
        torch.set_num_threads(threads)
    assert seen["backend"] == backend and seen["device"] == "cpu"
    assert seen["args"] == ("file:///nonexistent", 2, 0)
    assert CALLED == [(1, "x")]


# ---------------------------------------------------------------------------
# the distributed join keeps its first out_capacity matches, and expands no
# more (scaling_bench's self-join at 2^27 rows a shard has ~2^34 matches)
# ---------------------------------------------------------------------------


def _hot_join_table(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(n) < 0.3, 7, rng.integers(0, 50, n)).astype(np.uint32)
    return keys, np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("limit", [None, 100, 1500, 1 << 20])
def test_legacy_emit_expands_at_most_limit(limit):
    """With a limit, the expansion holds the first `limit` matches of the
    full one (probe-major) in a bucket sized by the limit, and still
    returns the full total."""
    from arrow_tpu_torch.compute import join as TJ

    keys, _ = _hot_join_table()
    k = torch.from_numpy(keys.view(np.int32))
    valid = torch.ones(len(keys), dtype=torch.bool)
    full_p, full_b, total = TJ.legacy_emit(k, valid, k, valid, att.ArrowType.UINT32)
    p, b, t = TJ.legacy_emit(k, valid, k, valid, att.ArrowType.UINT32, limit=limit)
    kept = total if limit is None else min(total, limit)
    assert t == total == int(np.bincount(keys)[keys].sum()) > 1500
    assert p.shape[0] == b.shape[0] == TJ._bucket(kept)
    assert torch.equal(p[:kept], full_p[:kept]) and torch.equal(b[:kept], full_b[:kept])
    assert not p[kept:].any() and not b[kept:].any()


def test_truncated_join_matches_jax():
    """distributed_join_indices with check=False and an out_capacity below
    the matches keeps the JAX package's first out_capacity pairs (P = 1)."""
    from arrow_tpu import parallel as JPP

    keys, vals = _hot_join_table()
    cap, out_cap = 4096, 2000
    rt = MeshRuntime.create(devices="cpu")
    sb = att.parallel.shard_batch(att.RecordBatch({
        "k": att.PrimitiveArray.from_slice(keys, dtype=att.ArrowType.UINT32, device="cpu"),
        "v": att.PrimitiveArray.from_slice(vals, dtype=att.ArrowType.INT32, device="cpu")}), rt, capacity=cap)
    counts, pidx, bidx, _, _ = att.parallel.distributed_join_indices(sb, sb, "k", "k", out_capacity=out_cap,
                                                                     check=False)
    jsb = _jax_sharded(1, {"k": ("uint32", keys), "v": ("int32", vals)}, cap)
    jcounts, jpidx, jbidx, _, _ = JPP.distributed_join_indices(jsb, jsb, "k", "k", out_capacity=out_cap,
                                                               check=False)
    assert counts.tolist() == np.asarray(jcounts).tolist() == [out_cap]
    assert pidx.data.shape[0] == out_cap
    np.testing.assert_array_equal(pidx.data.numpy().view(np.uint32), np.asarray(jpidx.data)[0])
    np.testing.assert_array_equal(bidx.data.numpy().view(np.uint32), np.asarray(jbidx.data)[0])
