"""The P-process scaling sweep of the distributed operators (BASELINE.md:
">= 75% rows/s scaling efficiency at N >= 2 hosts"); the counterpart of
``tools/scaling_bench.py``.

    python -m arrow_tpu_torch.tools.scaling_bench --device cpu              # P in {1, 2, 4, 8}, one core a rank
    python -m arrow_tpu_torch.tools.scaling_bench --procs 1 2 --rows-per-shard 65536
    python -m arrow_tpu_torch.tools.scaling_bench --procs 1                 # the card: 131072, 4194304, 2^27 rows

Each point spawns P ranks (``parallel.dryrun.launch``).  Rank r draws its
shard with numpy ``default_rng(r)``: u32 keys in [0, 2^20), i32 values in
[0, 100).  It runs ``dist_sort`` (``distributed_sort(check=False)``),
``dist_agg`` (the sum of v by k) and ``dist_join``
(``distributed_join_indices(sb, sb, ..., out_capacity=4 * cap,
check=False)``) once to warm up, then `iters` times, each call ending in a
device synchronise, from a common start; rank 0 reports.  Efficiency(P) =
rows_per_s(P) / (P * rows_per_s(1)).

On the CPU each rank is held to one core (core r mod the cores), as the JAX
script pins them.  On a card, P ranks run on NCCL, one GPU a rank, where the
machine has P GPUs; otherwise P > 1 ranks run as gloo ranks sharing the
card: those points are marked ``"shared_card": true`` and get no
``efficiency_vs_linear``, since ranks sharing one card measure no scaling.
A world of one on a card is a one-rank NCCL group.

The report (``--out``, ``TORCH_SCALING.json``) keeps the JAX script's keys:
``sweep`` (rows a shard -> P -> op -> rows_per_s, seconds_per_iter,
efficiency_vs_linear), ``overhead_decomposition`` (P -> op -> the fit of t
= fixed + rows a shard x per-row cost over the smallest and largest sizes,
:func:`overhead_decomposition`), ``rows_per_shard`` and ``points`` (the
largest size's sweep), and adds the device fields of
``tools.common.report_fields`` for each point and ``failed``, the points
that failed (rows, P, error).  The command exits non-zero when a point
failed.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..parallel.distributed_ops import distributed_aggregate, distributed_join_indices, distributed_sort
from ..parallel.dryrun import device_name
from ..parallel.mesh import MeshRuntime
from ..parallel.sharding import ShardedBatch
from . import common

KEY_DOMAIN = 1 << 20
VALUE_DOMAIN = 100
CPU_ROWS = (131072, 4194304)
CARD_ROWS = (131072, 4194304, 1 << 27)
PROCS = (1, 2, 4, 8)

OPS: Dict[str, Callable[[ShardedBatch], object]] = {
    "dist_sort": lambda sb: distributed_sort(sb, "k", check=False),
    "dist_agg": lambda sb: distributed_aggregate(sb, "k", [("s", "v", "sum")]),
    "dist_join": lambda sb: distributed_join_indices(sb, sb, "k", "k", out_capacity=4 * sb.capacity, check=False),
}


def shard_batch(rt: MeshRuntime, rows: int) -> ShardedBatch:
    """This rank's shard: u32 keys "k" in [0, 2^20) and i32 values "v" in
    [0, 100), drawn with ``default_rng(rank)``."""
    rng = np.random.default_rng(rt.rank)
    keys = rng.integers(0, KEY_DOMAIN, rows).astype(np.uint32)
    vals = rng.integers(0, VALUE_DOMAIN, rows).astype(np.int32)
    return common.local_batch(rt, {"k": (torch.from_numpy(keys.view(np.int32)), dt.ArrowType.UINT32),
                                   "v": (torch.from_numpy(vals), dt.ArrowType.INT32)})


def time_ops(rt: MeshRuntime, rows: int, iters: int) -> Dict[str, dict]:
    """op -> rows (all ranks'), seconds_per_iter, rows_per_s; each op
    warmed up once, then timed over `iters` calls."""
    sb = shard_batch(rt, rows)
    results = {}
    for name, op in OPS.items():
        op(sb)
        s = common.seconds_per_call(rt, lambda: op(sb), iters)
        results[name] = {"rows": rt.num_shards * rows, "seconds_per_iter": s,
                         "rows_per_s": rt.num_shards * rows / s}
    return results


def rank_body(rows: int, iters: int, device: Optional[str], outdir: str) -> None:
    """One rank of a point (``common.run_ranks``)."""
    import torch.distributed as dist

    if device == "cpu" and hasattr(os, "sched_setaffinity"):
        rank = dist.get_rank() if dist.is_initialized() else 0
        os.sched_setaffinity(0, {rank % (os.cpu_count() or 1)})
    with common.rank_runtime(device) as rt:
        common.write_rank(outdir, rt.rank, {"ops": time_ops(rt, rows, iters), **common.report_fields(rt)})


def point(p: int, rows: int, iters: int, device: str, timeout: float) -> dict:
    """Rank 0's result of one point: P = `p` ranks (NCCL, one GPU a rank,
    where the card's machine has p GPUs; gloo on `device` otherwise)."""
    return common.run_ranks(f"{__package__}.scaling_bench:rank_body", p, [rows, iters], device, timeout)[0]


def efficiencies(results: Dict[int, dict]) -> Dict[str, dict]:
    """P -> op -> rows_per_s, seconds_per_iter and, against P = 1's rows/s,
    efficiency_vs_linear (1.0 at P = 1; none where the ranks shared one
    card), with the point's shared_card mark."""
    base = results.get(1)
    points = {}
    for p, res in results.items():
        shared = res["shared_card"]
        points[str(p)] = {}
        for name, v in res["ops"].items():
            entry = {"rows_per_s": v["rows_per_s"], "seconds_per_iter": v["seconds_per_iter"]}
            if not shared:
                entry["efficiency_vs_linear"] = (v["rows_per_s"] / (p * base["ops"][name]["rows_per_s"])
                                                 if base and p > 1 else 1.0)
            entry["shared_card"] = shared
            points[str(p)][name] = entry
    return points


def overhead_decomposition(sweep: Dict[str, Dict[str, Dict[str, dict]]]) -> Dict[str, Dict[str, dict]]:
    """P -> op -> the fit of t = fixed + rows a shard x per-row cost through
    the smallest and the largest size of the sweep (rows a shard -> P -> op
    -> seconds_per_iter): fixed_s (at least 0), per_mrow_s (seconds a
    million rows a shard), and fixed's share of each size's time.  Empty
    with fewer than two sizes."""
    sizes = sorted(int(s) for s in sweep)
    if len(sizes) < 2:
        return {}
    lo, hi = sizes[0], sizes[-1]
    decomp = {}
    for p, ops in sweep[str(lo)].items():
        if p not in sweep[str(hi)]:
            continue
        decomp[p] = {}
        for op, v in ops.items():
            t_lo, t_hi = v["seconds_per_iter"], sweep[str(hi)][p][op]["seconds_per_iter"]
            slope = (t_hi - t_lo) / (hi - lo)
            fixed = max(t_lo - slope * lo, 0.0)
            decomp[p][op] = {
                "fixed_s": fixed,
                "per_mrow_s": slope * 1e6,
                "fixed_fraction_at_small": fixed / t_lo if t_lo else 0.0,
                "fixed_fraction_at_large": fixed / t_hi if t_hi else 0.0,
            }
    return decomp


def sweep(procs, sizes, iters: int, device: str, timeout: float) -> dict:
    """The report of a sweep over `sizes` (rows a shard) x `procs`; a point
    that fails is left out of the sweep, as the JAX script does, and listed
    under ``failed``."""
    report: dict = {"sweep": {}, "failed": []}
    fields = {}
    for rows in sizes:
        results = {}
        for p in procs:
            try:
                results[p] = point(p, rows, iters, device, timeout)
            except Exception as e:  # noqa: BLE001 - a failed point must not end the sweep
                print(f"rows/shard={rows} P={p} FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
                report["failed"].append({"rows": rows, "P": p, "error": f"{type(e).__name__}: {e}"})
                continue
            fields[str(p)] = {k: v for k, v in results[p].items() if k != "ops"}
            print(f"rows/shard={rows} P={p}: " + "  ".join(
                f"{k}={v['rows_per_s'] / 1e6:.2f} Mrows/s" for k, v in results[p]["ops"].items()),
                file=sys.stderr, flush=True)
        if results:
            report["sweep"][str(rows)] = efficiencies(results)
    report["overhead_decomposition"] = overhead_decomposition(report["sweep"])
    largest = max((int(s) for s in report["sweep"]), default=None)
    report["rows_per_shard"] = largest
    report["points"] = report["sweep"].get(str(largest), {})
    report["iters"] = iters
    report["ranks"] = fields  # P -> device, backend, shared_card, gpu
    return report


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, nargs="*", default=list(PROCS))
    ap.add_argument("--rows-per-shard", type=int, nargs="*",
                    help=f"default {list(CPU_ROWS)} on the CPU, {list(CARD_ROWS)} on a card")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", help="the ranks' device (default cuda:0 if present)")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a point may take")
    ap.add_argument("--out", default=str(common.ROOT / "TORCH_SCALING.json"))
    args = ap.parse_args(argv)
    device = device_name(args.device)
    sizes = args.rows_per_shard or (CPU_ROWS if torch.device(device).type == "cpu" else CARD_ROWS)
    report = sweep(args.procs, sizes, args.iters, device, args.timeout)
    common.write_report(args.out, report)
    return report


if __name__ == "__main__":
    result = main()
    sys.exit(0 if result["sweep"] and not result["failed"] else 1)
