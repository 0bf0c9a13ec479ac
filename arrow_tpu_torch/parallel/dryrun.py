"""The distributed query step end to end, and the helper that spawns one
process a rank.

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: the same batch (``default_rng(0)``,
``P * 2048`` rows, keys in [0, 64), values in [-50, 50), mask ``v % 2 ==
0``), the same steps (filter, aggregate, sum, the join of the aggregate's
keys against the filtered rows, sort), the same checks against numpy and
the same line.  For P > 1 it runs P ranks of a gloo group, one
process each, through :func:`spawn`, on the port's default device unless
the caller names one::

    python -c "import arrow_tpu_torch.parallel as PP; PP.dryrun_multichip(8, device='cpu')"

:func:`launch` / :func:`spawn` start ``world`` processes, each of which
joins a gloo group through :func:`initialize_distributed` and a file store
in a fresh temporary directory (a world of one joins none), limits itself
to one CPU thread when its device is the CPU, and calls
``module:function`` with the given JSON-able arguments.  :meth:`Ranks.join`
waits with a deadline: a rank that fails or a world that outlives the
deadline has every rank killed and raises, so a hung collective cannot hang
the caller.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..array.array import Int32Array, UInt32Array
from ..array.boolean import BooleanArray
from ..errors import ArrowTorchError
from ..table import RecordBatch
from .distributed_ops import (
    distributed_aggregate, distributed_filter, distributed_join_indices, distributed_sort, distributed_sum,
)
from ..runtime.device import default_device
from .mesh import MeshRuntime, initialize_distributed
from .sharding import ShardedBatch, gather_batch, shard_batch

ROOT = pathlib.Path(__file__).resolve().parents[2]
DRYRUN_ROWS_PER_SHARD = 2048

# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------


class Ranks:
    """The processes of a launched world (see :func:`launch`)."""

    def __init__(self, procs: List[subprocess.Popen], logs: List[pathlib.Path], tmp: str,
                 timeout: float, target: str):
        self._procs, self._logs, self._tmp = procs, logs, tmp
        self._deadline = time.monotonic() + timeout
        self._timeout, self._target = timeout, target

    def kill(self) -> None:
        """Kill every rank still running, wait for all, remove the store."""
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            p.wait()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def _log_tail(self, rank: int, nbytes: int = 4000) -> str:
        text = self._logs[rank].read_text(errors="replace")
        return text[-nbytes:]

    def join(self) -> None:
        """Wait for every rank; raise if a rank exits non-zero or the
        deadline passes.  Every rank is killed on the way out."""
        try:
            while True:
                codes = [p.poll() for p in self._procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    r = failed[0]
                    raise ArrowTorchError(
                        f"rank {r} of {self._target} exited with {codes[r]}:\n{self._log_tail(r)}")
                if all(c == 0 for c in codes):
                    return
                if time.monotonic() > self._deadline:
                    raise ArrowTorchError(
                        f"{self._target}: ranks still running after {self._timeout} s, killed; "
                        f"rank 0's log:\n{self._log_tail(0)}")
                time.sleep(0.02)
        finally:
            self.kill()


def _device_name(device: Optional[str]) -> str:
    """`device`, or the port's default device (``cuda:0`` when CUDA is
    present, else the CPU)."""
    return device or str(default_device().torch_device)


def launch(target: str, world: int, args: Sequence = (), device: Optional[str] = None,
           timeout: float = 300.0) -> Ranks:
    """Start `world` processes running ``module:function(*args)`` as the
    ranks of a gloo group; returns at once.  Each rank's device is `device`,
    the port's default device unless given (gloo moves CUDA tensors too, so
    ranks may share one card).  The ranks import from the checkout and from
    the caller's ``PYTHONPATH``."""
    device = _device_name(device)
    tmp = tempfile.mkdtemp(prefix="arrow_tpu_torch_ranks_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    procs, logs = [], []
    for rank in range(world):
        spec = {"target": target, "rank": rank, "world": world, "args": list(args), "device": device,
                "init_method": f"file://{tmp}/store"}
        log = pathlib.Path(tmp) / f"rank{rank}.log"
        with open(log, "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "from arrow_tpu_torch.parallel.dryrun import rank_main; rank_main()",
                 json.dumps(spec)],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)))
        logs.append(log)
    return Ranks(procs, logs, tmp, timeout, target)


def spawn(target: str, world: int, args: Sequence = (), device: Optional[str] = None,
          timeout: float = 300.0) -> None:
    """:func:`launch`, then :meth:`Ranks.join`."""
    launch(target, world, args, device, timeout).join()


def rank_main() -> None:
    """A spawned rank's entry: join the group, run the target, leave."""
    import torch.distributed as dist

    spec = json.loads(sys.argv[1])
    try:
        if torch.device(spec["device"]).type == "cpu":
            torch.set_num_threads(1)
        # a world of one joins no group: its exchanges are local copies
        initialize_distributed(spec["init_method"], spec["world"], spec["rank"], device=spec["device"],
                               backend="gloo")
        module, function = spec["target"].split(":")
        getattr(importlib.import_module(module), function)(*spec["args"])
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


# ---------------------------------------------------------------------------
# the dryrun query step
# ---------------------------------------------------------------------------


def dryrun_columns(n: int, seed: int = 0):
    """(keys u32 in [0, 64), values i32 in [-50, 50), mask v % 2 == 0)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 64, n).astype(np.uint32)
    vals = rng.integers(-50, 50, n).astype(np.int32)
    return keys, vals, vals % 2 == 0


def dryrun_batch(keys, vals, mask, device) -> RecordBatch:
    return RecordBatch({
        "k": UInt32Array.from_slice(keys, device=device),
        "v": Int32Array.from_slice(vals, device=device),
        "m": BooleanArray.from_slice(mask, device=device),
    })


def dryrun_step(rt: MeshRuntime, batch: RecordBatch) -> Dict[str, object]:
    """filter -> aggregate (shuffle + group-by) -> sum -> join of the
    aggregate's keys against the filtered rows -> sort, as
    ``__graft_entry__.dryrun_multichip`` runs them."""
    sb = shard_batch(batch, rt)
    filtered = distributed_filter(sb, "m")
    agg = distributed_aggregate(filtered, "k", [("s", "v", "sum"), ("c", None, "count")])
    total = distributed_sum(filtered, "v")
    build = ShardedBatch({"k": agg.columns["key"]}, agg.counts, rt)
    counts, pidx, bidx, _, _ = distributed_join_indices(build, filtered, "k", "k", out_capacity=4 * sb.capacity)
    plain = ShardedBatch({"k": filtered.columns["k"], "v": filtered.columns["v"]}, filtered.counts, rt)
    ordered = distributed_sort(plain, "k")
    return {"filtered": filtered, "agg": agg, "total": total, "join_counts": counts,
            "probe_idx": pidx, "build_idx": bidx, "sorted": ordered}


def check_dryrun(result: Dict[str, object], keys, vals, mask) -> Dict[str, int]:
    """The JAX dryrun's checks against numpy (the global sum, the sorted
    rows' count and keys); returns the printed counts."""
    total, expected_total = int(result["total"]), int(vals[mask].sum())
    if total != expected_total:
        raise ArrowTorchError(f"distributed sum {total} != numpy {expected_total}")
    ordered = result["sorted"]
    if ordered.num_rows() != int(mask.sum()):
        raise ArrowTorchError(f"sorted rows {ordered.num_rows()} != {int(mask.sum())}")
    got = gather_batch(ordered)["k"].raw_values()
    want = np.repeat(np.arange(64, dtype=np.uint32), np.bincount(keys[mask], minlength=64))
    if not np.array_equal(got, want):
        raise ArrowTorchError("gathered sorted keys differ from numpy's sort")
    return {"filtered": result["filtered"].num_rows(), "groups": result["agg"].num_rows(),
            "matches": int(result["join_counts"].sum())}


def shard_prefix(sb: ShardedBatch) -> Dict[str, np.ndarray]:
    """This rank's shard as host arrays: each column's logical values in its
    Arrow type (bools unpacked) and, for a nullable column, "<name>/valid"."""
    from .. import dtypes as dt
    from ..utils import bits as B

    c = int(sb.local_count())
    out = {}
    for name, col in sb.columns.items():
        host = col.data.cpu().numpy()
        if col.dtype is dt.ArrowType.BOOL:
            out[name] = B.unpack_bits_np(host, c)
        else:
            out[name] = dt.from_storage_np(host[:c], col.dtype)
        if col.validity is not None:
            out[f"{name}/valid"] = B.unpack_bits_np(col.validity.cpu().numpy(), c)
    return out


def dryrun_rank(rows_per_shard: int, device: str, outdir: Optional[str] = None) -> None:
    """One rank of :func:`dryrun_multichip`: the step on this rank's shard,
    checked; rank 0 writes the counts to ``outdir/result.json``; with
    `outdir`, every rank writes its shards to ``outdir/rank<r>.npz``."""
    rt = MeshRuntime.create(devices=device)
    keys, vals, mask = dryrun_columns(rt.num_shards * rows_per_shard)
    result = dryrun_step(rt, dryrun_batch(keys, vals, mask, device))
    counts = check_dryrun(result, keys, vals, mask)
    if "jax" in sys.modules:
        raise ArrowTorchError("a rank imported jax")
    if outdir is None:
        return
    k = int(result["join_counts"][rt.rank])
    arrays = {"total": np.array([int(result["total"])]),
              "join/probe": result["probe_idx"].data[:k].cpu().numpy(),
              "join/build": result["build_idx"].data[:k].cpu().numpy()}
    for step in ("filtered", "agg", "sorted"):
        arrays.update({f"{step}/{n}": a for n, a in shard_prefix(result[step]).items()})
    np.savez(pathlib.Path(outdir) / f"rank{rt.rank}.npz", **arrays)
    if rt.rank == 0:
        (pathlib.Path(outdir) / "result.json").write_text(json.dumps(counts))


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> Dict[str, int]:
    """Run the distributed query step on `n_devices` ranks (in this process
    for one, else one spawned process a rank, gloo between them) and print
    the JAX dryrun's line.  device: every rank's device, the port's default
    device (``cuda:0`` when CUDA is present) unless given.  Returns the
    printed counts."""
    device = _device_name(device)
    if n_devices == 1:
        rt = MeshRuntime.create(devices=device)
        keys, vals, mask = dryrun_columns(DRYRUN_ROWS_PER_SHARD)
        counts = check_dryrun(dryrun_step(rt, dryrun_batch(keys, vals, mask, device)), keys, vals, mask)
    else:
        outdir = tempfile.mkdtemp(prefix="arrow_tpu_torch_dryrun_")
        try:
            spawn(f"{__name__}:dryrun_rank", n_devices, [DRYRUN_ROWS_PER_SHARD, device, outdir], device=device)
            counts = json.loads((pathlib.Path(outdir) / "result.json").read_text())
        finally:
            shutil.rmtree(outdir, ignore_errors=True)
    print(f"dryrun_multichip({n_devices}): ok — {counts['filtered']} rows filtered, "
          f"{counts['groups']} groups, {counts['matches']} join matches")
    return counts
