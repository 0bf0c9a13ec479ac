"""arrow_tpu_torch.parallel against arrow_tpu.parallel, shard by shard.

The JAX side runs in the pytest process on a mesh of P of the 8 virtual CPU
devices that conftest.py provides.  The port runs on P spawned ranks, one
process each (``parallel.dryrun.launch``; a gloo group for P > 1, and a
single rank joins none, as ``initialize_distributed`` is a no-op for one
process), which import this module for
``port_rank`` and write each shard's logical prefix to an .npz; world
"local" runs the same scenarios in this process on a world of one without a
process group (exchanges as local copies), against the JAX package's P = 1.
Every world is spawned once, at the module's first test, and runs every
scenario; the comparisons are parametrised over scenario x world.  This
module imports jax only inside the functions that compute the JAX side, and
every spawned rank checks that it never imported jax.

Tolerance: exact everywhere (values, validity, counts, column names, zero
tails) except float sums, within rtol 1e-6 for f32 and 1e-12 for f64.
Joins compare as pair or row multisets a shard (their emit order is
implementation-defined), and the float-keyed shuffle as a gathered row
multiset (XLA leaves the conversion of negative and NaN floats to uint32 to
the implementation).
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

import arrow_tpu_torch as att
from arrow_tpu_torch import parallel as TPP
from arrow_tpu_torch.parallel import dryrun as TD
from arrow_tpu_torch.parallel import shuffle as TS
from arrow_tpu_torch.utils import bits as TB
from torch_helpers import sharded_to_numpy

WORLDS = ("local", 1, 2, 4, 8)
HERE = pathlib.Path(__file__).resolve().parent
RANK_TIMEOUT = 240.0
RTOL = {"float32": 1e-6, "float64": 1e-12}

# ---------------------------------------------------------------------------
# tables: name -> (Arrow type, numpy values, valid mask or None); every
# builder is seeded and independent of the world size
# ---------------------------------------------------------------------------


def _mixed():
    rng = np.random.default_rng(11)
    n = 5003  # shards start at rows that are not multiples of 32
    rows = np.arange(n)
    return {"k": ("uint32", rng.integers(0, 500, n).astype(np.uint32), None),
            "x": ("int32", rng.integers(-1000, 1000, n).astype(np.int32), rows % 7 != 0),
            "b": ("bool", rng.random(n) < 0.5, rows % 5 != 0),
            "f": ("bool", rng.random(n) < 0.3, None),
            "w": ("uint64", rng.integers(0, 2**64, n, dtype=np.uint64), None),
            "s": ("int16", rng.integers(-2**15, 2**15, n).astype(np.int16), None)}


def _u64():
    rng = np.random.default_rng(12)
    n = 6000
    keys = np.where(rng.random(n) < 0.5, rng.integers(0, 300, n), rng.integers(0, 2**64, n, dtype=np.uint64))
    return {"k": ("uint64", keys.astype(np.uint64), None),
            "s": ("int16", rng.integers(-128, 127, n).astype(np.int16), None),
            "t": ("uint8", rng.integers(0, 256, n).astype(np.uint8), None),
            "x": ("int32", rng.integers(-10**6, 10**6, n).astype(np.int32), np.arange(n) % 3 != 0),
            "d": ("float64", rng.standard_normal(n), None)}


def _trunc():
    rng = np.random.default_rng(13)
    n = 6000
    keys = np.where(rng.random(n) < 0.6, 77, rng.integers(0, 1000, n)).astype(np.uint32)
    return {"k": ("uint32", keys, None), "v": ("int32", np.arange(n, dtype=np.int32), None)}


def _hot():
    n = 16_000
    return {"k": ("uint32", np.full(n, 77, np.uint32), None), "v": ("int32", np.arange(n, dtype=np.int32), None)}


def _float_keys():
    rng = np.random.default_rng(14)
    n = 4000
    keys = rng.integers(0, 100, n).astype(np.float32)
    keys[::7] += 0.5
    keys[::11] = -keys[::11] - 1
    keys[::97] = np.nan
    keys[::101] = np.inf
    keys[::103] = 3e9
    return {"k": ("float32", keys, None), "v": ("int32", np.arange(n, dtype=np.int32), None)}


def _filter():
    rng = np.random.default_rng(15)
    n = 8000
    rows = np.arange(n)
    return {"v": ("int32", rng.integers(0, 100, n).astype(np.int32), None),
            "m": ("bool", rng.random(n) < 0.5, rows % 9 != 0),
            "x": ("float64", rng.standard_normal(n), rows % 4 != 0),
            "b": ("bool", rng.random(n) < 0.5, None)}


def _agg():
    rng = np.random.default_rng(16)
    n = 10_000
    return {"k": ("uint32", rng.integers(0, 500, n).astype(np.uint32), np.arange(n) % 11 != 0),
            "v": ("int32", rng.integers(-1000, 1000, n).astype(np.int32), np.arange(n) % 6 != 0),
            # quarter-integers below 2^22: every f32 sum of them is exact
            "f": ("float32", (rng.integers(-1000, 1000, n) / 4).astype(np.float32), None)}


def _skew():
    """_agg's columns (its null keys too, so that the JAX package reuses the
    group-by programs) with one key in 95% of the rows, 13 in the others:
    with pre-aggregation each shard sends at most 2 rows, far below the
    pinned bucket of 1024 that the raw rows would overflow."""
    table = _agg()
    n = len(table["k"][1])
    keys = np.where(np.random.default_rng(5).random(n) < 0.95, 7, 13).astype(np.uint32)
    return {**table, "k": ("uint32", keys, table["k"][2])}


def _sort_u32():
    rng = np.random.default_rng(18)
    n = 12_000
    return {"k": ("uint32", rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), None),
            "p": ("int32", np.arange(n, dtype=np.int32), None),
            "t": ("uint8", rng.integers(0, 256, n).astype(np.uint8), None)}


def _sort_equal():
    n = 4096
    return {"k": ("uint32", np.full(n, 7, np.uint32), None), "v": ("int32", np.arange(n, dtype=np.int32), None)}


def _sums():
    rng = np.random.default_rng(19)
    n = 7000
    return {"i32": ("int32", rng.integers(-2**31, 2**31, n).astype(np.int32), None),
            "u32": ("uint32", rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), None),
            "i64": ("int64", rng.integers(-2**62, 2**62, n), np.arange(n) % 4 != 0),  # wraps
            "u64": ("uint64", rng.integers(0, 2**64, n, dtype=np.uint64), None),  # wraps
            "u8": ("uint8", rng.integers(0, 256, n).astype(np.uint8), None),
            "f32": ("float32", (rng.integers(-1000, 1000, n) / 4).astype(np.float32), None),
            "f64": ("float64", rng.standard_normal(n), None)}


def join_left():
    rng = np.random.default_rng(20)
    n = 3000
    return {"k": ("uint64", rng.integers(0, 500, n).astype(np.uint64), None),
            "lv": ("int32", np.arange(n, dtype=np.int32), None),
            "x": ("int16", rng.integers(-100, 100, n).astype(np.int16), None)}


def join_right():
    rng = np.random.default_rng(21)
    n = 1500
    return {"k": ("uint64", rng.integers(0, 500, n).astype(np.uint64), None),
            "rv": ("int32", np.arange(n, dtype=np.int32), None),
            "x": ("float32", rng.standard_normal(n).astype(np.float32), None)}


AGGS_PRE = [("s", "v", "sum"), ("n", None, "count"), ("c", "v", "count"), ("mx", "v", "max"), ("fs", "f", "sum")]
AGGS_RAW = [("s", "v", "sum"), ("mean", "v", "mean"), ("n", None, "count")]


class Scenario(NamedTuple):
    tables: tuple  # table builders, one sharded batch each
    op: object  # (parallel package, *sharded batches) -> result
    kind: str  # what the result is and how it is compared
    rtol: dict = {}  # column -> rtol of a float sum


SCENARIOS = {
    "shard": Scenario((_mixed,), lambda PP, a: a, "batch"),
    "gather": Scenario((_mixed,), lambda PP, a: PP.gather_batch(a), "host"),
    "hash_mixed": Scenario((_mixed,), lambda PP, a: PP.hash_partition(a, "k"), "batch"),
    "hash_u64": Scenario((_u64,), lambda PP, a: PP.hash_partition(a, "k"), "batch"),
    "hash_trunc": Scenario(
        (_trunc,), lambda PP, a: PP.hash_partition(a, "k", bucket_rows=1024, out_capacity=3072, check=False),
        "batch"),
    "hash_hot": Scenario((_hot,), lambda PP, a: PP.hash_partition(a, "k"), "batch"),
    "hash_float": Scenario((_float_keys,), lambda PP, a: PP.hash_partition(a, "k"), "gathered"),
    "filter": Scenario((_filter,), lambda PP, a: PP.distributed_filter(a, "m"), "batch"),
    "agg_pre": Scenario((_agg,), lambda PP, a: PP.distributed_aggregate(a, "k", AGGS_PRE), "batch",
                        {"fs": RTOL["float32"]}),
    "agg_raw": Scenario((_agg,), lambda PP, a: PP.distributed_aggregate(a, "k", AGGS_RAW, pre_aggregate=False),
                        "batch", {"mean": RTOL["float64"]}),
    "agg_skew": Scenario((_skew,), lambda PP, a: PP.distributed_aggregate(a, "k", AGGS_PRE, bucket_rows=1024),
                         "batch", {"fs": RTOL["float32"]}),
    "sort_u32": Scenario((_sort_u32,), lambda PP, a: PP.distributed_sort(a, "k"), "batch"),
    "sort_equal": Scenario((_sort_equal,), lambda PP, a: PP.distributed_sort(a, "k"), "batch"),
    "sum": Scenario((_sums,), lambda PP, a: {c: PP.distributed_sum(a, c) for c in a.column_names}, "sums"),
    "join_idx": Scenario((join_left, join_right),
                         lambda PP, l, r: PP.distributed_join_indices(r, l, "k", "k"), "pairs"),
    "join_fused": Scenario((join_left, join_right),
                           lambda PP, l, r: PP.distributed_join(l, r, "k", "k", fused=True), "rows"),
    "join_unfused": Scenario((join_left, join_right),
                             lambda PP, l, r: PP.distributed_join(l, r, "k", "k", fused=False), "rows"),
    "overflow": Scenario((_hot,), lambda PP, a: PP.hash_partition(a, "k", bucket_rows=1024, out_capacity=1024),
                         "raises"),
}
#: the scenarios of test_torch_parallel_ops.py; this module runs the others
OPS_SCENARIOS = ("agg_pre", "agg_raw", "agg_skew", "join_idx", "join_fused", "join_unfused")
OWN_SCENARIOS = tuple(n for n in SCENARIOS if n not in OPS_SCENARIOS)
BATCH_SCENARIOS = [n for n in OWN_SCENARIOS if SCENARIOS[n].kind == "batch"]


def _cap(n: int, p: int) -> int:
    """The JAX package's default shard capacity (its pad unit is 8192 rows),
    given to both packages so that their shards have one capacity."""
    per = -(-n // p)
    return max(-(-per // 8192) * 8192, 1024)


def _nrows(table) -> int:
    return len(next(iter(table.values()))[1])


# ---------------------------------------------------------------------------
# the port's side: one rank (or the world of one in this process)
# ---------------------------------------------------------------------------


def _port_batch(table):
    cols = {}
    for name, (typ, vals, valid) in table.items():
        if typ == "bool":
            cols[name] = (att.BooleanArray.from_slice(vals, device="cpu") if valid is None else
                          att.BooleanArray.from_optional_slice(
                              [bool(v) if ok else None for v, ok in zip(vals, valid)], device="cpu"))
        elif valid is None:
            cols[name] = att.PrimitiveArray.from_slice(vals, dtype=att.ArrowType(typ), device="cpu")
        else:
            cols[name] = att.PrimitiveArray.from_optional_slice(
                [v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=att.ArrowType(typ), device="cpu")
    return att.RecordBatch(cols)


def _tails_zero(sb) -> bool:
    """Every buffer of this rank's shard is zero past its count."""
    c = int(sb.local_count())
    for col in sb.columns.values():
        if col.dtype is att.ArrowType.BOOL:
            if TB.unpack_bits(col.data)[c:].any():
                return False
        elif col.data[c:].any():
            return False
        if col.validity is not None and TB.unpack_bits(col.validity)[c:].any():
            return False
    return True


def _int_bits(v) -> int:
    """An integer sum's uint64 bits (both packages' sums wrap at 64 bits)."""
    return int(v) & (2**64 - 1)


def _port_record(kind, res, rank):
    """(arrays, meta) of this rank's part of a result."""
    if kind in ("batch", "rows", "gathered"):
        return TD.shard_prefix(res), {"counts": res.counts.tolist(), "columns": res.column_names,
                                      "tails_zero": _tails_zero(res)}
    if kind == "host":
        arrays = {}
        for name, col in res.columns().items():
            arrays[name] = col.raw_values()
            if col.validity is not None:
                arrays[f"{name}/valid"] = col.null_mask()
        return arrays, {"columns": res.column_names}
    if kind == "sums":
        return {}, {"sums": {c: float(v) if v.is_floating_point() else _int_bits(v) for c, v in res.items()}}
    counts, pidx, bidx, pb, pp_ = res  # pairs
    k = int(counts[rank])
    lv = pp_.columns["lv"].data[pidx.data[:k].long()]
    rv = pb.columns["rv"].data[bidx.data[:k].long()]
    return {"pairs": torch.stack([lv, rv], 1).numpy()}, {"counts": counts.tolist()}


def port_rank(outdir: str, names, spawned: bool = True) -> None:
    """Run the named scenarios on this rank's shards; write rank<r>.npz
    (arrays) and rank<r>.json (counts, columns, tails, sums, errors)."""
    rt = TPP.MeshRuntime.create(devices="cpu")
    arrays, meta = {}, {}
    for name in names:
        sc = SCENARIOS[name]
        tables = [t() for t in sc.tables]
        sbs = [TPP.shard_batch(_port_batch(t), rt, capacity=_cap(_nrows(t), rt.num_shards)) for t in tables]
        try:
            a, m = _port_record(sc.kind, sc.op(TPP, *sbs), rt.rank)
        except att.ArrowTorchError as e:
            a, m = {}, {"error": str(e)}
        arrays.update({f"{name}|{k}": v for k, v in a.items()})
        meta[name] = m
    out = pathlib.Path(outdir)
    np.savez(out / f"rank{rt.rank}.npz", **arrays)
    (out / f"rank{rt.rank}.json").write_text(json.dumps(meta))
    if spawned and "jax" in sys.modules:
        raise RuntimeError("a rank of the port imported jax")


class PortWorld:
    """The port's results of one world: rank r's arrays and meta."""

    def __init__(self, outdir: pathlib.Path, world: int, ranks=None):
        self._outdir, self._world, self._ranks, self._loaded = outdir, world, ranks, None

    def load(self):
        if self._loaded is None:
            if self._ranks is not None:
                self._ranks.join()
            self._loaded = []
            for r in range(self._world):
                with np.load(self._outdir / f"rank{r}.npz") as z:
                    arrays = {k: z[k] for k in z.files}
                meta = json.loads((self._outdir / f"rank{r}.json").read_text())
                self._loaded.append((arrays, meta))
        return self._loaded

    def rank(self, scenario, r):
        arrays, meta = self.load()[r]
        prefix = f"{scenario}|"
        return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}, meta[scenario]


def launch_worlds(root: pathlib.Path, names):
    """world -> PortWorld running the named scenarios: every spawned world
    launched at once, then the world of one run here."""
    worlds = {}
    for w in WORLDS:
        if w == "local":
            continue
        out = root / f"p{w}"
        out.mkdir()
        with pytest.MonkeyPatch.context() as mp:  # the ranks import this module
            mp.setenv("PYTHONPATH", os.pathsep.join([str(HERE), os.environ.get("PYTHONPATH", "")]))
            ranks = TD.launch(f"{__name__}:port_rank", w, [str(out), list(names)], device="cpu",
                              timeout=RANK_TIMEOUT)
        worlds[w] = PortWorld(out, w, ranks)
    local = root / "local"
    local.mkdir()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside the spawned ranks, as they run
    try:
        port_rank(str(local), names, spawned=False)
    finally:
        torch.set_num_threads(threads)
    worlds["local"] = PortWorld(local, 1)
    return worlds


def join_worlds(worlds) -> None:
    """Wait for (or kill) every spawned world; a failure is reported by the
    tests that read its results."""
    for w in worlds.values():
        try:
            w.load()
        except att.ArrowTorchError:
            pass


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    worlds = launch_worlds(tmp_path_factory.mktemp("port_ranks"), OWN_SCENARIOS)
    yield worlds
    join_worlds(worlds)


def shard_count(world):
    return 1 if world == "local" else world


# ---------------------------------------------------------------------------
# the JAX package's side, in this process
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_mesh(p):
    from arrow_tpu import parallel as JPP

    return JPP.MeshRuntime.create(num_devices=p)


def _jax_batch(table):
    from torch_helpers import make_pair
    from arrow_tpu.table import RecordBatch

    return RecordBatch({name: make_pair(typ, vals, valid)[0] for name, (typ, vals, valid) in table.items()})


@functools.lru_cache(maxsize=None)
def jax_result(scenario, p):
    """The JAX package's result of a scenario at P = p, as one (arrays,
    meta) a shard (for "host" and "sums", one for the whole)."""
    from arrow_tpu import parallel as JPP

    sc = SCENARIOS[scenario]
    rt = _jax_mesh(p)
    tables = [t() for t in sc.tables]
    sbs = [JPP.shard_batch(_jax_batch(t), rt, capacity=_cap(_nrows(t), p)) for t in tables]
    res = sc.op(JPP, *sbs)
    if sc.kind in ("batch", "rows", "gathered"):
        counts, shards = sharded_to_numpy(res)
        return [(s, {"counts": counts, "columns": res.column_names}) for s in shards]
    if sc.kind == "host":
        arrays = {}
        for name, col in res.columns().items():
            arrays[name] = np.asarray(col.raw_values())
            if col.validity is not None:
                arrays[f"{name}/valid"] = col.null_mask()
        return [(arrays, {"columns": res.column_names})]
    if sc.kind == "sums":
        return [({}, {"sums": {c: float(v) if np.issubdtype(np.asarray(v).dtype, np.floating) else _int_bits(v)
                               for c, v in res.items()}})]
    counts, pidx, bidx, pb, pp_ = res
    counts = np.asarray(counts)
    lv, rv = np.asarray(pp_.columns["lv"].data), np.asarray(pb.columns["rv"].data)
    pi, bi = np.asarray(pidx.data), np.asarray(bidx.data)
    return [({"pairs": np.stack([lv[s][pi[s, :k]], rv[s][bi[s, :k]]], 1)}, {"counts": counts.tolist()})
            for s, k in enumerate(counts)]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_column(name, got, want, rtol=None):
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if rtol is not None:
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=name)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


def _assert_shard(got, want, rtol):
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_column(name, got[name], want[name], rtol.get(name))


def row_multiset(shard, columns):
    """A shard's rows as a sorted list of tuples of each column's bits."""
    cols = []
    for name in columns:
        for key in (name, f"{name}/valid"):
            if key in shard:
                a = np.ascontiguousarray(shard[key])
                cols.append(a.view(f"u{a.itemsize}").tolist() if a.dtype != bool else a.tolist())
    return sorted(zip(*cols))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("scenario", BATCH_SCENARIOS)
def test_shards_match_jax(port, scenario, world):
    """shard_batch, hash_partition, distributed_filter and distributed_sort:
    every shard's values, validity and count equal the JAX package's shard,
    the columns come in its order, the tails are zero."""
    assert_shards_match(port, scenario, world)


def assert_shards_match(port, scenario, world):
    want = jax_result(scenario, shard_count(world))
    for r, (want_arrays, want_meta) in enumerate(want):
        got_arrays, got_meta = port[world].rank(scenario, r)
        assert "error" not in got_meta, got_meta.get("error")
        assert got_meta["counts"] == want_meta["counts"]
        assert got_meta["columns"] == want_meta["columns"]
        assert got_meta["tails_zero"], f"rank {r}: a buffer is not zero past the count"
        _assert_shard(got_arrays, want_arrays, SCENARIOS[scenario].rtol)


@pytest.mark.parametrize("world", WORLDS)
def test_gather_batch_matches_jax_and_the_input(port, world):
    (want_arrays, want_meta), = jax_result("gather", shard_count(world))
    table = _mixed()
    for r in range(shard_count(world)):
        got_arrays, got_meta = port[world].rank("gather", r)
        assert got_meta["columns"] == want_meta["columns"] == list(table)
        _assert_shard(got_arrays, want_arrays, {})
        for name, (typ, vals, valid) in table.items():
            expect = vals if valid is None else np.where(valid, vals, 0).astype(vals.dtype)  # nulls hold 0
            np.testing.assert_array_equal(_bits(got_arrays[name]), _bits(expect.astype(got_arrays[name].dtype)))
            if valid is not None:
                np.testing.assert_array_equal(got_arrays[f"{name}/valid"], valid)


@pytest.mark.parametrize("world", WORLDS)
def test_float_keyed_shuffle_rows(port, world):
    want = jax_result("hash_float", shard_count(world))
    columns = want[0][1]["columns"]
    got_rows, want_rows = [], []
    for r, (want_arrays, _) in enumerate(want):
        got_arrays, got_meta = port[world].rank("hash_float", r)
        assert got_meta["columns"] == columns and got_meta["tails_zero"]
        got_rows += row_multiset(got_arrays, columns)
        want_rows += row_multiset(want_arrays, columns)
    assert len(got_rows) == _nrows(_float_keys())
    assert sorted(got_rows) == sorted(want_rows)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_sum_matches_jax(port, world):
    """jnp.sum + psum's dtype: integers in 64 bits (wrapping), floats in
    their own type; the same on every rank."""
    (_, want_meta), = jax_result("sum", shard_count(world))
    table = _sums()
    for r in range(shard_count(world)):
        got = port[world].rank("sum", r)[1]["sums"]
        assert sorted(got) == sorted(want_meta["sums"])
        for c, v in want_meta["sums"].items():
            typ = table[c][0]
            if typ in RTOL:
                assert got[c] == pytest.approx(v, rel=RTOL[typ]), c
            else:
                assert got[c] == v, c


@pytest.mark.parametrize("world", WORLDS)
def test_overflow_raises_on_every_rank(port, world):
    """A hot key past bucket_rows=1024 and out_capacity=1024 raises
    ArrowTorchError on every rank, and no rank hangs (the world joined
    within its timeout)."""
    for r in range(shard_count(world)):
        meta = port[world].rank("overflow", r)[1]
        assert "bucket/capacity overflow" in meta.get("error", ""), meta


def test_dryrun_prints_the_jax_counts(capsys):
    """P = 8 gives the JAX dryrun's counts (MULTICHIP_r05.json)."""
    counts = TPP.dryrun_multichip(8, device="cpu")
    assert counts == {"filtered": 8229, "groups": 64, "matches": 8229}
    assert "8229 rows filtered, 64 groups, 8229 join matches" in capsys.readouterr().out


def test_spawn_timeout_kills_every_rank():
    """A world that outlives its deadline is killed and raises."""
    ranks = TD.launch("time:sleep", 2, [600], device="cpu", timeout=2.0)
    with pytest.raises(att.ArrowTorchError, match="still running"):
        ranks.join()
    assert all(p.poll() is not None for p in ranks._procs)


# ---------------------------------------------------------------------------
# in this process: the hash functions and the word planes, bit for bit
# ---------------------------------------------------------------------------

INT_TYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "date32"]
EDGES = [0, 1, -1, 2**31, 2**31 - 1, 2**32 - 1, 2**32, 2**63, 2**63 - 1, 2**64 - 1, -(2**31), -(2**63)]


def _edge_values(typ, n=200):
    """The edge values (wrapped into the type) and random ones."""
    npdt = np.dtype("int32" if typ == "date32" else typ)
    info = np.iinfo(npdt)
    edges = np.array([v % 2**64 for v in EDGES + [info.min, info.max]], np.uint64).astype(npdt)
    rand = np.random.default_rng(7).integers(info.min, info.max, n, dtype=npdt, endpoint=True)
    return np.concatenate([edges, rand])


def _port_tensor(typ, vals):
    arr = att.PrimitiveArray.from_slice(vals, dtype=att.ArrowType(typ), device="cpu")
    return arr.data[: len(vals)], att.ArrowType(typ)


@pytest.mark.parametrize("typ", INT_TYPES)
def test_hashes_bit_exact(typ):
    """fmix32, fmix64 and hash_key equal the JAX package's for every
    integer type, over 0, +-1, 2^31, 2^32 - 1, 2^63, the type's bounds."""
    import jax.numpy as jnp
    from arrow_tpu.parallel import shuffle as JS

    vals = _edge_values(typ)
    x, arrow = _port_tensor(typ, vals)
    j = jnp.asarray(vals)
    np.testing.assert_array_equal(TS.fmix32(x, arrow).numpy().view(np.uint32), np.asarray(JS.fmix32(j)))
    np.testing.assert_array_equal(TS.fmix64(x, arrow).numpy().view(np.uint64), np.asarray(JS.fmix64(j)))
    np.testing.assert_array_equal(TS.hash_key(x, arrow).numpy().view(np.uint32), np.asarray(JS.hash_key(j)))


@pytest.mark.parametrize("typ", ["float32", "float64"])
def test_float_hash_where_defined(typ):
    """hash_key of floats converts the value (not the bits): equal to the
    JAX package's wherever the conversion is defined (-1 < x < 2^32, or
    2^64 for an 8-byte float); elsewhere it is XLA's CPU result (saturate,
    NaN 0), which the float-keyed shuffle compares as row multisets."""
    import jax.numpy as jnp
    from arrow_tpu.parallel import shuffle as JS

    top = 2.0**32 if typ == "float32" else 2.0**64
    rng = np.random.default_rng(8)
    vals = np.concatenate([[0.0, -0.0, -0.5, 0.5, 1.0, 3.7, 2.0**31, top / 2, top * 0.99],
                           rng.uniform(-0.99, top * 0.99, 300), rng.integers(0, 1000, 100)]).astype(typ)
    x, arrow = _port_tensor(typ, vals)
    np.testing.assert_array_equal(TS.hash_key(x, arrow).numpy().view(np.uint32),
                                  np.asarray(JS.hash_key(jnp.asarray(vals))))


@pytest.mark.parametrize("typ", INT_TYPES + ["float32", "float64"])
def test_u32_planes_bit_exact(typ):
    """u32_planes gives the JAX package's words (64-bit as lo, hi; narrower
    types widened), and u32_decode inverts it."""
    import jax.numpy as jnp
    from arrow_tpu.parallel import shuffle as JS

    if typ.startswith("float"):
        vals = np.random.default_rng(9).standard_normal(300).astype(typ)
    else:
        vals = _edge_values(typ)
    x, arrow = _port_tensor(typ, vals)
    got = TS.u32_planes(x, arrow)
    want = JS.u32_planes(jnp.asarray(vals if typ != "date32" else vals.astype(np.int32)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    np.testing.assert_array_equal(_bits(TS.u32_decode(got, arrow).numpy()), _bits(x.numpy()))


def test_world_of_one_without_a_process_group():
    """initialize_distributed is a no-op for one process, as the JAX
    function is; the mesh is then a world of one with local exchanges."""
    TPP.initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    rt = TPP.MeshRuntime.create(devices="cpu")
    assert (rt.num_shards, rt.rank, rt.distributed, rt.device) == (1, 0, False, torch.device("cpu"))
    with pytest.raises(att.ArrowTorchError, match="not 2"):
        TPP.MeshRuntime.create(num_devices=2, devices="cpu")
