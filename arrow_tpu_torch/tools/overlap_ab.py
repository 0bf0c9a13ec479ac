"""The fused against the composed ``distributed_join``, and the fused join's
device ops; the counterpart of ``tools/overlap_ab.py``.

    python -m arrow_tpu_torch.tools.overlap_ab                 # the card, a world of one, 2^20 rows a side
    python -m arrow_tpu_torch.tools.overlap_ab --procs 4       # 4 ranks: NCCL with 4 GPUs, else gloo sharing the card
    python -m arrow_tpu_torch.tools.overlap_ab --cpu           # 8 gloo CPU ranks, 2^16 rows a side

Both sides are the JAX script's (``default_rng(3)``): n u64 keys in [0, n)
with an i32 ``arange`` payload each ("v" on the build side, "w" on the
probe side), placed by ``shard_batch``.  ``distributed_join(sb, sp, "k",
"k", fused=...)`` runs fused (both exchanges started before the local join
waits on either) and composed (one after the other), each warmed up once
and then timed as the mean of 5 calls from a common start, each ending in a
device synchronise (rank 0's clock).  Every rank checks that both forms give
the same rows (as a set of (v, w) pairs, each unique).  The fused join is
then profiled once (``runtime.profiler.device_report``: device ops on a
card, CPU ops by self time on the CPU) for its top 15 ops, and at P > 1 the
u64 route hash of both sides (``parallel.shuffle``'s limb arithmetic) is
profiled alone, for its share of the fused join's profiled time on rank 0.

The report (``--out``: ``TORCH_OVERLAP_AB.json``, with ``--cpu``
``TORCH_OVERLAP_AB_CPU.json``) keeps the JAX script's keys (``mesh_devices``,
``rows_per_side``, ``fused_s``, ``composed_s``, ``fused_speedup``,
``top_kernels``; ``backend`` is the distributed backend here) and adds the
check, the profiled times and the device fields of
``tools.common.report_fields``.  A failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..parallel.distributed_ops import distributed_join
from ..parallel.dryrun import device_name
from ..parallel.mesh import MeshRuntime
from ..parallel.sharding import ShardedBatch, shard_batch
from ..parallel.shuffle import _hash_u32
from ..runtime import profiler
from ..table import RecordBatch
from . import common

REPS = 5
TOP = 15
CARD_ROWS = 1 << 20
CPU_ROWS = 1 << 16
CPU_PROCS = 8


def sides(rt: MeshRuntime, n: int):
    """(build, probe): the JAX script's two sides of n rows, sharded."""
    rng = np.random.default_rng(3)
    bk = rng.integers(0, n, n).astype(np.uint64)
    pk = rng.integers(0, n, n).astype(np.uint64)
    bv = np.arange(n, dtype=np.int32)
    pv = np.arange(n, dtype=np.int32)
    sb = shard_batch(RecordBatch.from_numpy({"k": bk, "v": bv}, device="cpu"), rt)
    sp = shard_batch(RecordBatch.from_numpy({"k": pk, "w": pv}, device="cpu"), rt)
    return sb, sp


def _pairs(out: ShardedBatch, n: int) -> torch.Tensor:
    """This rank's joined rows as sorted v * n + w codes."""
    c = int(out.local_count())
    return torch.sort(out.columns["v"].data[:c].to(torch.int64) * n + out.columns["w"].data[:c]).values


def _profiled_ms(rows) -> float:
    return sum(ms for _, _, ms in rows)


def run(rt: MeshRuntime, n: int) -> dict:
    """The A/B on this rank's shards; the report (rank 0's times)."""
    sb, sp = sides(rt, n)

    def join(fused):
        return distributed_join(sb, sp, "k", "k", fused=fused)

    out = {"mesh_devices": rt.num_shards, "rows_per_side": n}
    for fused in (True, False):
        join(fused)
        out["fused_s" if fused else "composed_s"] = common.seconds_per_call(rt, lambda: join(fused), REPS)
    out["fused_speedup"] = out["composed_s"] / out["fused_s"]
    fused, composed = join(True), join(False)
    same = torch.equal(_pairs(fused, n), _pairs(composed, n))
    bad = rt.all_reduce_sum(torch.tensor([0 if same else 1], dtype=torch.int32, device=rt.device))
    out["fused_equals_composed"] = int(bad) == 0
    out["joined_rows"] = fused.num_rows()
    del fused, composed

    rows = profiler.device_report(lambda: join(True), top=1 << 30)
    out["top_kernels"] = [(nm, c, round(ms, 3)) for nm, c, ms in rows[:TOP]]
    out["profiled_on"] = rt.device.type
    out["fused_profiled_ms"] = _profiled_ms(rows)
    out["route_hash_profiled_ms"] = out["route_hash_share"] = None
    if rt.num_shards > 1:  # at P = 1 nothing is routed
        keys = [b.columns["k"].data[: int(b.local_count())] for b in (sb, sp)]
        hashed = profiler.device_report(lambda: [_hash_u32(k, dt.ArrowType.UINT64) % rt.num_shards for k in keys],
                                         top=1 << 30)
        out["route_hash_profiled_ms"] = _profiled_ms(hashed)
        out["route_hash_share"] = out["route_hash_profiled_ms"] / out["fused_profiled_ms"]
    out.update(common.report_fields(rt))
    return out


def rank_body(n: int, device: Optional[str], outdir: str) -> None:
    """One spawned rank (``common.run_ranks``)."""
    with common.rank_runtime(device) as rt:
        common.write_rank(outdir, rt.rank, run(rt, n))


def overlap_ab(n: int, procs: Optional[int] = None, device: Optional[str] = None, timeout: float = 900.0) -> dict:
    """The report of one A/B: in this process as a world of one when
    `procs` is None, else on `procs` spawned ranks (rank 0's report; NCCL
    where each rank can have its own GPU, ``common.backend_for``)."""
    if procs is None:
        with common.rank_runtime(device_name(device)) as rt:
            return run(rt, n)
    return common.run_ranks(f"{__package__}.overlap_ab:rank_body", procs, [n], device_name(device), timeout)[0]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help=f"{CPU_PROCS} gloo CPU ranks, {CPU_ROWS} rows a side")
    ap.add_argument("--procs", type=int, help="spawn this many ranks (default: a world of one, or 8 with --cpu)")
    ap.add_argument("--rows", type=int, help=f"rows a side (default {CARD_ROWS}, {CPU_ROWS} with --cpu)")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds the spawned ranks may take")
    ap.add_argument("--out", help="default TORCH_OVERLAP_AB.json (TORCH_OVERLAP_AB_CPU.json with --cpu)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    procs = args.procs or (CPU_PROCS if args.cpu else None)
    n = args.rows or (CPU_ROWS if args.cpu else CARD_ROWS)
    report = overlap_ab(n, procs, device, args.timeout)
    out = args.out if args.out is not None else str(
        common.ROOT / ("TORCH_OVERLAP_AB_CPU.json" if args.cpu else "TORCH_OVERLAP_AB.json"))
    common.write_report(out, report)
    print(profiler.device_summary(report["top_kernels"]), file=sys.stderr)
    print(f"fused {report['fused_s'] * 1e3:.1f} ms vs composed {report['composed_s'] * 1e3:.1f} ms "
          f"(x{report['fused_speedup']:.2f})", file=sys.stderr)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["fused_equals_composed"] else 1)
