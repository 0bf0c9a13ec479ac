"""What the distributed tools share: a rank's mesh (a world of one on a card
is a one-rank NCCL group), spawning a tool's ranks and reading their
reports, timing, launch counts, and the report's device fields."""

from __future__ import annotations

import contextlib
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import dtypes as dt
from ..compute.kernels import _build
from ..errors import ArrowTorchError
from ..parallel import dryrun
from ..parallel.mesh import MeshRuntime
from ..parallel.sharding import ShardedBatch, ShardedColumn, counts_tensor
from ..runtime.device import Device

ROOT = pathlib.Path(__file__).resolve().parents[2]


def gpu_line() -> Optional[str]:
    """``name, power.limit`` of the machine's cards as nvidia-smi gives them
    (one card a line, joined by "; "), or None without nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(line.strip() for line in out.splitlines() if line.strip()) or None


@contextlib.contextmanager
def rank_runtime(device: Optional[str]) -> Iterator[MeshRuntime]:
    """This process's mesh on `device` (``cuda:LOCAL_RANK`` when None): the
    process group's when one is initialised, else a world of one.  A world
    of one on a card joins a one-rank NCCL group (a file store) for the
    duration, so that NCCL's all_gather and all_to_all_single run as they
    do at P > 1; on the CPU it joins none (exchanges are local copies)."""
    rt = MeshRuntime.create(devices=device)
    if rt.distributed or rt.device.type != "cuda":
        yield rt
        return
    with one_rank_group("nccl", rt.device):
        yield MeshRuntime.create(devices=rt.device)


@contextlib.contextmanager
def one_rank_group(backend: str, device) -> Iterator[None]:
    """A process group of one rank on `device` (a file store) for the
    duration."""
    store = tempfile.mkdtemp(prefix="arrow_tpu_torch_group_")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def report_fields(rt: MeshRuntime) -> Dict[str, object]:
    """The fields every tool's report adds: this rank's device, the group's
    backend (None for a world of one without a group), whether P > 1 ranks
    share one card (gloo ranks on a card: no scaling can be read from
    them), and the cards' nvidia-smi line (None on the CPU)."""
    backend = dist.get_backend() if rt.distributed else None
    return {"device": str(rt.device), "backend": backend,
            "shared_card": rt.device.type == "cuda" and rt.num_shards > 1 and backend == "gloo",
            "gpu": gpu_line() if rt.device.type == "cuda" else None}


def barrier(rt: MeshRuntime) -> None:
    """Every rank's device work done and every rank here (a one-element
    all-reduce), so that a timed region starts together on all ranks."""
    device = Device(rt.device)
    device.synchronize()
    rt.all_reduce_sum(torch.zeros(1, dtype=torch.int32, device=rt.device))
    device.synchronize()


def seconds_per_call(rt: MeshRuntime, fn: Callable[[], object], calls: int = 1) -> float:
    """Host seconds a call of `fn`, over `calls` calls that start together
    on every rank, each ending in a device synchronise."""
    device = Device(rt.device)
    barrier(rt)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        device.synchronize()
    return (time.perf_counter() - t0) / calls


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count (they stay 0 on the CPU, where the
    wrappers run the plain versions)."""
    return {name: k.launches for name, k in _build.KERNELS.items()}


def launched_since(before: Dict[str, int]) -> Dict[str, int]:
    """The kernels launched since the counts were `before`, with their
    launches."""
    now = launch_counts()
    return {name: n - before.get(name, 0) for name, n in now.items() if n != before.get(name, 0)}


def local_batch(rt: MeshRuntime, columns: Dict[str, Tuple[torch.Tensor, dt.ArrowType]]) -> ShardedBatch:
    """This rank's shard, every column full (the capacity is its rows), as a
    ShardedBatch; every rank holds as many rows."""
    rows = int(next(iter(columns.values()))[0].shape[0])
    cols = {name: ShardedColumn(t.to(rt.device), None, typ) for name, (t, typ) in columns.items()}
    return ShardedBatch(cols, counts_tensor(np.full(rt.num_shards, rows, np.int32), rt), rt)


def backend_for(device: str, procs: int) -> str:
    """The spawned ranks' group for `procs` ranks on `device`: NCCL, one
    GPU a rank, where `device` is a card and the machine has a GPU for each
    rank; gloo, every rank on `device`, otherwise (the CPU, or ranks sharing
    one card)."""
    return "nccl" if torch.device(device).type == "cuda" and procs <= torch.cuda.device_count() else "gloo"


def run_ranks(target: str, procs: int, args: Sequence, device: str, timeout: float,
              gloo: bool = False) -> List[dict]:
    """Spawn `procs` ranks of ``module:function(*args, rank_device,
    outdir)`` (``parallel.dryrun.launch``) in the group of
    :func:`backend_for` (gloo whatever the GPUs with `gloo`), wait for
    them, and return each rank's report, ``outdir/rank<r>.json`` (see
    :func:`write_rank`).  rank_device is `device` on gloo and None
    (``cuda:LOCAL_RANK``) on NCCL."""
    backend = "gloo" if gloo else backend_for(device, procs)
    dev = device if backend == "gloo" else None
    outdir = tempfile.mkdtemp(prefix="arrow_tpu_torch_tool_")
    try:
        dryrun.spawn(target, procs, [*args, dev, outdir], device=dev, timeout=timeout, backend=backend)
        return [json.loads((pathlib.Path(outdir) / f"rank{r}.json").read_text()) for r in range(procs)]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def write_rank(outdir: str, rank: int, report: dict) -> None:
    """A spawned rank's last step: check that it never imported jax, then
    write its report for :func:`run_ranks`."""
    if "jax" in sys.modules:
        raise ArrowTorchError("a rank of the port imported jax")
    (pathlib.Path(outdir) / f"rank{rank}.json").write_text(json.dumps(report))


def write_report(path, report: dict) -> None:
    """The report as indented JSON at `path` (none when `path` is empty),
    and on one line on stdout."""
    if path:
        pathlib.Path(path).write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps(report), flush=True)
