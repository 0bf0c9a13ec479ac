"""The BASELINE's 1B-row sort (``BASELINE.json`` configs[3], u32 key and
payload) through ``parallel.distributed_sort``, checked; the counterpart of
``tools/dist_sort_1b.py``.

    # a world of one on the port's default device (on a card, a one-rank
    # NCCL group): 2^30 rows of key and payload
    python -m arrow_tpu_torch.tools.dist_sort_1b --payload
    # on the CPU, small
    python -m arrow_tpu_torch.tools.dist_sort_1b --device cpu --rows-per-shard 4096 --payload
    # 8 ranks, 2^27 rows a rank (the JAX script's P and shard): NCCL, one GPU
    # a rank, on a machine with 8 GPUs; gloo ranks sharing the card otherwise
    python -m arrow_tpu_torch.tools.dist_sort_1b --procs 8 --payload
    # gloo ranks sharing cuda:0 whatever the GPUs
    python -m arrow_tpu_torch.tools.dist_sort_1b --procs 4 --backend gloo --payload

Rank r draws ``rows_per_shard`` u32 keys in [0, 2^31) from its own
``torch.Generator`` on its device (seeded with r) and, with
``--payload``, a u32 payload: the row's global index.  Each shard is sorted
as the JAX script sorts it, ``distributed_sort(sb, "k", out_capacity=
rows_per_shard * 3 // 2)``, three times (the first call cold), each call
timed on the host clock from a common start to a device synchronise (the
slowest rank's).  The checks of the last call run on each rank's device, a
chunk at a time:

- row conservation: the shards' counts add up to the rows drawn;
- global order: each shard non-decreasing in unsigned order, and each
  non-empty shard's first key at least the last key of the shard before;
- the key checksum: the int64 sum of the unsigned keys, before and after;
- with ``--payload``, that each payload still follows its key:
  ``keys_in[payload] == key_out`` on every row (each source rank's keys are
  drawn again to check it);
- with ``--payload``, the stable order: (key, payload) strictly increases
  over the shards in rank order.  The payload is the row's global index,
  so a stable sort has exactly one correct output, the rows ordered by
  (key, payload); with the checks above (as many rows as drawn, each
  payload an index of them, each with its own key) this holds only for
  that output, which is the plain sort's bit for bit.

The report (``--out``, ``TORCH_DIST_SORT_1B.json`` at the root of the
checkout) keeps the JAX script's keys and adds the sort's times, each
rank's peak device memory, the kernels launched in the last call and the
device fields of ``tools.common.report_fields``.  A failed check exits
non-zero.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import dtypes as dt
from ..parallel.distributed_ops import distributed_sort
from ..parallel.dryrun import device_name
from ..parallel.mesh import MeshRuntime
from ..parallel.sharding import ShardedBatch
from ..runtime.device import Device
from . import common

ROWS_TOTAL = 1 << 30
KEY_BOUND = 1 << 31  # keys in [0, 2^31), as the JAX script draws them
SORT_CALLS = 3
CHUNK = 1 << 26  # rows a step of the checks
CHECKS = ("row_conservation_ok", "globally_sorted_ok", "key_checksum_ok", "payload_follows_key_ok",
          "stable_order_ok")  # the report's checks, each true, or None where not run (without the payload)
_U32 = dt.ArrowType.UINT32
_SIGN = -(1 << 31)  # x ^ _SIGN: the signed order of u32 bits in int32 storage is their unsigned order

NOTE = ("u32 keys in [0, 2^31) drawn on each rank's device (torch.Generator seeded with the rank), "
        "the payload the row's global index; sort_seconds: the host clock from a common start to a device "
        "synchronise, the slowest rank's, the median of 3 calls (the first cold), sort_seconds_cpu_mesh "
        "the same on CPU ranks only; the checks run on the device, a chunk of rows at a time")


def draw_keys(rank: int, rows: int, device) -> torch.Tensor:
    """Rank `rank`'s keys: `rows` u32 in [0, 2^31), in int32 storage."""
    gen = torch.Generator(device=device)
    gen.manual_seed(rank)
    return torch.randint(0, KEY_BOUND, (rows,), generator=gen, dtype=torch.int32, device=device)


def shard_batch(rt: MeshRuntime, rows: int, payload: bool) -> ShardedBatch:
    """This rank's shard: its keys ("k") and, with `payload`, the rows'
    global indices ("v")."""
    cols = {"k": (draw_keys(rt.rank, rows, rt.device), _U32)}
    if payload:
        first = rt.rank * rows
        cols["v"] = (torch.arange(first, first + rows, dtype=torch.int32, device=rt.device), _U32)
    return common.local_batch(rt, cols)


def _unsigned(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def key_checksum(rt: MeshRuntime, keys: torch.Tensor, n: int) -> int:
    """The int64 sum of the first `n` unsigned keys of every rank (2^30 keys
    below 2^32 sum below 2^62)."""
    total = torch.zeros((), dtype=torch.int64, device=keys.device)
    for a in range(0, n, CHUNK):
        total += _unsigned(keys[a : a + CHUNK]).sum()
    return int(rt.all_reduce_sum(total))


def _all_ranks(rt: MeshRuntime, ok: bool) -> bool:
    """True when `ok` holds on every rank."""
    bad = torch.tensor([0 if ok else 1], dtype=torch.int32, device=rt.device)
    return int(rt.all_reduce_sum(bad)) == 0


def _in_order(rt: MeshRuntime, planes: List[torch.Tensor], c: int, strict: bool) -> bool:
    """The rows of `planes` (u32 in int32 storage, the first the most
    significant) ordered lexicographically in unsigned order over this
    shard's c rows and across the non-empty shards in rank order:
    non-decreasing, or with `strict` strictly increasing.  A chunk of rows
    at a time, each chunk overlapping the next by one row."""
    bad = torch.zeros((), dtype=torch.int64, device=planes[0].device)
    for a in range(0, max(c - 1, 0), CHUNK):
        xs = [x[a : min(a + CHUNK, c - 1) + 1] ^ _SIGN for x in planes]
        after = torch.zeros(xs[0].shape[0] - 1, dtype=torch.bool, device=xs[0].device)
        tied = torch.ones_like(after)
        for x in xs:
            after |= tied & (x[1:] > x[:-1])
            tied &= x[1:] == x[:-1]
        bad += (~(after if strict else after | tied)).sum()
    zero = torch.zeros((), dtype=torch.int64, device=planes[0].device)
    ends = torch.stack([torch.full((), c, dtype=torch.int64, device=planes[0].device),
                        *[_unsigned(x[0]) if c else zero for x in planes],
                        *[_unsigned(x[c - 1]) if c else zero for x in planes]])
    edges = rt.all_gather(ends).cpu().tolist()
    last = None
    ordered = True
    for count, *row in edges:
        if count:
            first, end = row[: len(planes)], row[len(planes) :]
            ordered &= last is None or (first > last if strict else first >= last)
            last = end
    return _all_ranks(rt, int(bad) == 0) and ordered


def _payload_follows_key(rt: MeshRuntime, keys: torch.Tensor, payload: torch.Tensor, c: int, rows: int) -> bool:
    """keys_in[payload] == key_out on each of this shard's c rows, every
    payload an index of the rows drawn; each source rank's keys drawn
    again, one rank at a time."""
    bad = torch.zeros((), dtype=torch.int64, device=keys.device)
    matched = torch.zeros((), dtype=torch.int64, device=keys.device)
    for s in range(rt.num_shards):
        source = draw_keys(s, rows, keys.device)
        for a in range(0, c, CHUNK):
            idx = payload[a : min(a + CHUNK, c)].to(torch.int64) - s * rows
            mine = (idx >= 0) & (idx < rows)
            same = source[idx.clamp(0, rows - 1)] == keys[a : min(a + CHUNK, c)]
            matched += mine.sum()
            bad += (mine & ~same).sum()
        del source
    return _all_ranks(rt, int(bad) == 0 and int(matched) == c)


def check_sort(rt: MeshRuntime, out: ShardedBatch, rows: int, payload: bool, checksum_in: int) -> Dict[str, Optional[bool]]:
    """The checks of a sorted ShardedBatch (the same on every rank): rows
    conserved, globally sorted, the key checksum unchanged and, with
    `payload`, each payload following its key and the stable order (None
    without)."""
    counts = [int(x) for x in out.counts.tolist()]
    c = counts[rt.rank]
    keys = out.columns["k"].data
    checks = {
        "row_conservation_ok": sum(counts) == rt.num_shards * rows,
        "globally_sorted_ok": _in_order(rt, [keys], c, strict=False),
        "key_checksum_ok": key_checksum(rt, keys, c) == checksum_in,
        "payload_follows_key_ok": None,
        "stable_order_ok": None,
    }
    if payload:
        values = out.columns["v"].data
        checks["payload_follows_key_ok"] = _payload_follows_key(rt, keys, values, c, rows)
        checks["stable_order_ok"] = _in_order(rt, [keys, values], c, strict=True)
    return checks


def run(rt: MeshRuntime, rows: int, payload: bool) -> Tuple[dict, ShardedBatch]:
    """Draw this rank's shard, sort it with the other ranks' SORT_CALLS
    times and check the last call.  Returns (the report, the same on every
    rank but for its per-rank fields; the sorted ShardedBatch)."""
    sb = shard_batch(rt, rows, payload)
    checksum_in = key_checksum(rt, sb.columns["k"].data, rows)
    out_cap = rows * 3 // 2
    times: List[float] = []
    out = None
    device = Device(rt.device)
    for _ in range(SORT_CALLS):
        out = None  # the last call's result is freed before the next one runs
        before = common.launch_counts()
        device.reset_peak_memory_stats()
        common.barrier(rt)
        t0 = time.perf_counter()
        out = distributed_sort(sb, "k", out_capacity=out_cap)
        device.synchronize()
        times.append(time.perf_counter() - t0)
    launched, peak = common.launched_since(before), device.memory_stats().get("allocated_bytes.all.peak")
    del sb
    checks = check_sort(rt, out, rows, payload, checksum_in)
    slowest = rt.all_gather(torch.tensor(times, dtype=torch.float64, device=rt.device)).max(dim=0).values.tolist()
    peaks = None if peak is None else rt.all_gather(
        torch.tensor([peak], dtype=torch.int64, device=rt.device)).reshape(-1).tolist()
    seconds = statistics.median(slowest)
    report = {
        "rows_total": rt.num_shards * rows,
        "rows_per_shard": rows,
        "shards": rt.num_shards,
        "sort_seconds_cpu_mesh": seconds if rt.device.type == "cpu" else None,
        "row_conservation_ok": checks["row_conservation_ok"],
        "globally_sorted_ok": checks["globally_sorted_ok"],
        "key_checksum_ok": checks["key_checksum_ok"],
        "with_payload": payload,
        "note": NOTE,
        "payload_follows_key_ok": checks["payload_follows_key_ok"],
        "stable_order_ok": checks["stable_order_ok"],
        "ok": all(v is not False for v in checks.values()),
        "key_checksum": checksum_in,
        "out_capacity": out_cap,
        "sort_seconds": seconds,
        "sort_seconds_each": slowest,
        "peak_device_bytes": peaks,
        "launches": launched,
        **common.report_fields(rt),
    }
    return report, out


def rank_body(rows: int, payload: bool, device: Optional[str], outdir: str) -> None:
    """One spawned rank (``common.run_ranks``)."""
    with common.rank_runtime(device) as rt:
        report, _ = run(rt, rows, payload)
        common.write_rank(outdir, rt.rank, report)


def sort_1b(rows: int, payload: bool, procs: Optional[int] = None, gloo: bool = False,
            device: Optional[str] = None, timeout: float = 3600.0) -> dict:
    """The report of one run: in this process as a world of one when
    `procs` is None, else on `procs` spawned ranks (rank 0's report; NCCL
    where each rank can have its own GPU, unless `gloo`)."""
    if procs is None:
        with common.rank_runtime(device_name(device)) as rt:
            return run(rt, rows, payload)[0]
    return common.run_ranks(f"{__package__}.dist_sort_1b:rank_body", procs, [rows, payload], device_name(device),
                            timeout, gloo)[0]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows-per-shard", type=int, help="default 2^30 over the ranks")
    ap.add_argument("--payload", action="store_true", help="sort a u32 payload (the row's index) along")
    ap.add_argument("--procs", type=int, help="spawn this many ranks (default: a world of one here)")
    ap.add_argument("--backend", choices=("gloo",),
                    help="gloo: the spawned ranks share --device even where NCCL could give each its own GPU "
                         "(by default NCCL, one GPU a rank, where the machine has a GPU for each rank)")
    ap.add_argument("--device", help="the device of a world of one or of gloo ranks (default cuda:0 if present)")
    ap.add_argument("--timeout", type=float, default=3600.0, help="seconds the spawned ranks may take")
    ap.add_argument("--out", default=str(common.ROOT / "TORCH_DIST_SORT_1B.json"))
    args = ap.parse_args(argv)
    rows = args.rows_per_shard or ROWS_TOTAL // (args.procs or 1)
    report = sort_1b(rows, args.payload, args.procs, args.backend == "gloo", args.device, args.timeout)
    common.write_report(args.out, report)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
