"""Shared helpers of the differential tests that hold arrow_tpu_torch against
arrow_tpu.  Inputs are made with numpy and handed to both packages; state
crosses from the JAX package to the port only through ``io`` buffers, and
results are compared on their logical prefixes plus the zero tails the
operators promise."""

from __future__ import annotations

import numpy as np
import torch

import arrow_tpu_torch as att
from arrow_tpu_torch import io as tio
from arrow_tpu_torch.array.array import make_array
from arrow_tpu_torch.utils import bits as TB


# selections that stress a tiled compaction's edges (see edge_pattern)
EDGE_PATTERNS = ["first", "last", "alternate", "block", "all", "none"]


def edge_pattern(name, n):
    """A selection of n rows: only the first row, only the last, every other
    row, the last 8192-row block alone, all rows or no rows."""
    rows = np.arange(n)
    return {"first": rows == 0, "last": rows == n - 1, "alternate": rows % 2 == 0,
            "block": rows >= n - 8192, "all": rows >= 0, "none": rows < 0}[name]


# run pairs that stress a merge's tile edges (see merge_edge_planes)
MERGE_PATTERNS = ["a_below", "b_below", "all_equal", "alternate", "straddle", "expand", "rank_fill"]
SENT = 0x7FFFFFFF  # the merge sentinel, the largest sortable key


def merge_edge_planes(name, n, run_len, unique, seed=0):
    """int32 planes of n rows holding sorted runs of run_len rows, every pair
    (A, B) of one shape: A entirely below B or above it; all keys equal;
    strictly alternating keys; a run of equal keys that straddles the pair's
    middle (A's last and B's first quarter); the join's expand call (A
    strictly increasing run ends, then sentinels; B an arange); its rank-fill
    call (A an arange; B sorted ranks with duplicates, then sentinels).
    Plane 1 holds row ids (increasing in every run, so unique-payload mode
    takes it as the tiebreak); without `unique`, plane 2 random values."""
    rng = np.random.default_rng(seed)
    keys = np.empty(n, np.int64)
    for lo in range(0, n, 2 * run_len):
        la = min(run_len, n - lo)
        lb = min(run_len, n - lo - la)
        a, b = np.arange(la), np.arange(lb)
        if name == "a_below":
            ka, kb = 2 * a - 5, 2 * la + 2 * b
        elif name == "b_below":
            ka, kb = lb + a, b - 1000
        elif name == "all_equal":
            ka, kb = np.full(la, 7), np.full(lb, 7)
        elif name == "alternate":
            ka, kb = 2 * a, 2 * b + 1
        elif name == "straddle":
            ka = np.where(a >= la - la // 4, 100, np.sort(rng.integers(-50, 100, la)))
            kb = np.where(b < lb // 4, 100, np.sort(rng.integers(101, 250, lb)))
        elif name == "expand":
            live = la // 2
            ends = np.sort(rng.choice(max(lb, live) + 1, live, replace=False))
            ka, kb = np.concatenate([ends, np.full(la - live, SENT)]), b
        elif name == "rank_fill":
            live = lb - lb // 3
            ka = a
            kb = np.concatenate([np.sort(rng.integers(0, max(la, 1), live)), np.full(lb - live, SENT)])
        else:
            raise ValueError(f"no merge pattern {name!r}")
        keys[lo:lo + la], keys[lo + la:lo + la + lb] = ka, kb
    rows = np.arange(n, dtype=np.int32)
    planes = [keys.astype(np.int32), rows]
    if not unique:
        planes.append(rng.integers(-(2**31), 2**31, n).astype(np.int32))
    return planes


# the join's take (compute.kernels.take_columns): every element width and
# BOOL, and (capacity, length) pairs of its index planes: empty, nothing
# live, all live, lengths of no multiple of 4 or 32
TAKE_KINDS = ["int8", "uint8", "int16", "uint16", "int32", "uint32", "float32", "int64", "uint64", "float64", "bool"]
TAKE_SHAPES = [(0, 0), (64, 0), (64, 64), (130, 37), (257, 255), (1024, 1000)]
TAKE_SRC_ROWS = 45  # a source buffer of exactly this many rows (no padding), so that a clamp reads a real row


def exact_column(rng, kind, n, nulls):
    """A CPU column of exactly `n` buffer rows (BOOL: whole words), with a
    validity bitmap of a 30% null share when `nulls`."""
    A = att.ArrowType
    valid = rng.random(n) >= 0.3
    validity = torch.from_numpy(TB.pack_bits_np(valid).view(np.int32).copy()) if nulls else None
    if kind == "bool":
        words = torch.from_numpy(TB.pack_bits_np(rng.random(n) < 0.5).view(np.int32).copy())
        return make_array(words, validity, n, A.BOOL)
    t = A(kind)
    info = np.iinfo(kind) if kind[0] in "iu" else None
    host = (rng.integers(info.min, info.max, n, endpoint=True, dtype=kind) if info is not None
            else rng.standard_normal(n).astype(kind))
    return make_array(torch.from_numpy(att.dtypes.to_storage_np(host, t).copy()), validity, n, t)


def index_plane(rng, cap, length, src_rows):
    """A CPU UInt32Array of `cap` buffer rows and `length` rows: row ids in
    [0, src_rows + 8) with some at 2^32 - 1 (past every source), zeros past
    the length."""
    ids = rng.integers(0, src_rows + 8, cap).astype(np.uint32)
    ids[rng.random(cap) < 0.05] = np.uint32(2**32 - 1)
    ids[length:] = 0
    return make_array(torch.from_numpy(ids.view(np.int32).copy()), None, length, att.ArrowType.UINT32)


# the elementwise tier's differential tests share one input length, so that
# the JAX package compiles each op once per dtype
ELEMENTWISE_N = 300
NUMERIC = ["float32", "float64", "uint8", "uint16", "uint32", "uint64",
           "int8", "int16", "int32", "int64", "date32"]


def storage_numpy(name):
    return np.dtype("int32" if name == "date32" else name)


def edge_values(name, n, rng):
    """n values of Arrow type `name` (numpy; bool for "bool") drawn from a
    seeded rng, with the type's edge values planted: for floats NaN, +-inf,
    +-0, 1, -1 and huge magnitudes; for integers the type's min and max,
    0, 1, -1 (max for unsigned) and, for unsigned types, values above the
    signed maximum."""
    if name == "bool":
        return rng.random(n) < 0.5
    if name.startswith("float"):
        v = (rng.standard_normal(n) * 10).astype(name)
        edges = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 1e30, -1e30], name)
    else:
        npdt = storage_numpy(name)
        info = np.iinfo(npdt)
        v = rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)
        edges = np.array([info.min, info.max, 0, 1, info.max - 1, info.max // 2 + 1, info.min + 1], npdt)
        if info.min < 0:
            edges = np.concatenate([edges, np.array([-1], npdt)])
    v[: min(n, edges.shape[0])] = edges[: min(n, edges.shape[0])]
    return v


def make_pair(name, vals, valid=None):
    """One column in both packages: the JAX package's array and the port's
    (on the CPU); `valid` a bool mask of the non-null rows, or None."""
    import arrow_tpu as at

    if name == "bool":
        if valid is None:
            ja = at.BooleanArray.from_slice(vals)
        else:
            ja = at.BooleanArray.from_optional_slice(
                [bool(v) if ok else None for v, ok in zip(vals, valid)])
    elif valid is None:
        ja = at.PrimitiveArray.from_slice(vals, dtype=at.ArrowType(name))
    else:
        ja = at.PrimitiveArray.from_optional_slice(
            [v if ok else None for v, ok in zip(vals.tolist(), valid)], dtype=at.ArrowType(name))
    return ja, jax_to_torch(ja)


def jax_to_torch(arr, device="cpu"):
    """A JAX-package array -> the port's array, through Arrow buffers."""
    from arrow_tpu import io as jio

    b = jio.to_arrow_buffers(arr)
    return tio.from_arrow_buffers(
        b["data"], b["length"], b["validity"], att.ArrowType(arr.dtype.value), device
    )


def batch_to_torch(batch, device="cpu"):
    from arrow_tpu import io as jio

    bufs = {}
    for name, col in batch.columns().items():
        bufs[name] = {**jio.to_arrow_buffers(col), "dtype": col.dtype.value}
    return att.RecordBatch.from_arrow_buffers(bufs, device=device)


def assert_zero_tail(arr):
    """Rows at and past the logical length are zero in every buffer."""
    n = arr.length
    data = arr.data.cpu().numpy()
    if arr.dtype is att.ArrowType.BOOL:
        bits = np.unpackbits(data.view(np.uint8), bitorder="little")
        assert not bits[n:].any(), "bool data bits past the length"
    else:
        assert not data[n:].any(), "values past the length"
    if arr.validity is not None:
        bits = np.unpackbits(arr.validity.cpu().numpy().view(np.uint8), bitorder="little")
        assert not bits[n:].any(), "validity bits past the length"


def assert_same(jarr, tarr, rtol=None, nan_bits=True):
    """Equal Arrow buffers: length, null count, validity bytes, and the value
    bytes (floats within `rtol` when given, NaN matching NaN).  With
    `nan_bits` False, floats compare as values: a NaN matches a NaN whatever
    its sign and payload (which IEEE leaves to the implementation), and
    every other value must match bit for bit."""
    from arrow_tpu import io as jio

    je, te = jio.to_arrow_buffers(jarr), tio.to_arrow_buffers(tarr)
    assert jarr.dtype.value == tarr.dtype.value
    assert je["length"] == te["length"]
    assert je["null_count"] == te["null_count"]
    assert (je["validity"] is None) == (te["validity"] is None)
    if je["validity"] is not None:
        np.testing.assert_array_equal(je["validity"], te["validity"])
    jd, td = je["data"], te["data"]
    assert jd.dtype == td.dtype, (jd.dtype, td.dtype)
    if rtol is not None and jd.dtype.kind == "f":
        np.testing.assert_allclose(td, jd, rtol=rtol, equal_nan=True)
    elif not nan_bits and jd.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(td), np.isnan(jd))
        keep = ~np.isnan(jd)
        np.testing.assert_array_equal(td[keep].view(np.uint8), jd[keep].view(np.uint8))
    else:
        np.testing.assert_array_equal(td.view(np.uint8), jd.view(np.uint8))
    assert_zero_tail(tarr)


def sharded_to_numpy(sb):
    """A JAX-package ShardedBatch as (counts, shards): each shard a dict of
    its logical prefix, each column's values in its Arrow type (bools
    unpacked) and, for a nullable column, "<name>/valid" (the layout of
    ``arrow_tpu_torch.parallel.dryrun.shard_prefix``, which the port's ranks
    write)."""
    from arrow_tpu_torch.utils import bits as B

    counts = [int(c) for c in np.asarray(sb.counts)]
    shards = [{} for _ in counts]
    for name, col in sb.columns.items():
        data = np.asarray(col.data)
        valid = None if col.validity is None else np.asarray(col.validity)
        for s, c in enumerate(counts):
            if col.dtype.value == "bool":
                shards[s][name] = B.unpack_bits_np(data[s], c)
            else:
                shards[s][name] = data[s, :c]
            if valid is not None:
                shards[s][f"{name}/valid"] = B.unpack_bits_np(valid[s], c)
    return counts, shards


__all__ = ["ELEMENTWISE_N", "NUMERIC", "assert_same", "assert_zero_tail", "batch_to_torch", "edge_values",
           "jax_to_torch", "make_pair", "merge_edge_planes", "sharded_to_numpy", "storage_numpy"]
