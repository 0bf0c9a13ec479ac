"""Mesh runtime: the process group a sharded table lives on.

Counterpart of ``arrow_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a ``Mesh`` of devices, and its ``shard_map`` programs see one
row of a ``(P, cap)`` array each.  Here each shard is a process: rank ``r`` of
a ``torch.distributed`` group holds row ``r`` of the JAX layout on its own
device, and the collectives are ``torch.distributed`` calls (NCCL on CUDA,
gloo on the CPU).  With no process group initialised, a :class:`MeshRuntime`
is a world of one whose collectives are local copies, the counterpart of a
one-device mesh.

``smap``, ``MeshRuntime.sharding``, ``shard_leading`` and ``replicated`` are
JAX plumbing (``shard_map`` and ``NamedSharding``) and have no counterpart.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Union

import torch
import torch.distributed as dist

from ..errors import ArrowTorchError

log = logging.getLogger("arrow_tpu_torch")

#: the partition axis' name (the JAX package's ``config.shard_axis``)
DEFAULT_AXIS = "x"

DeviceLike = Union[torch.device, str]


def _local_device() -> torch.device:
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[DeviceLike] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group, one call per process (the JAX function's
    contract: a no-op for one process or when already initialised).

    coordinator_address: ``host:port`` (TCP) or an init-method URL such as
    ``file:///path``; ``env://`` (``MASTER_ADDR``/``MASTER_PORT``) by
    default.  device: this rank's device, ``cuda:LOCAL_RANK`` by default.
    backend: NCCL for a CUDA device and gloo for the CPU by default; gloo
    also moves CUDA tensors, which ranks sharing one card need (NCCL takes
    one rank a card).
    """
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        log.warning("initialize_distributed: a process group is already initialised")
        return
    device = torch.device(device) if device is not None else _local_device()
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(device)
    address = coordinator_address or "env://"
    init_method = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id)
    log.info("arrow_tpu_torch distributed: rank %s of %s on %s (%s)", process_id, num_processes, device, backend)


@dataclasses.dataclass
class MeshRuntime:
    """A 1-D data mesh: the ranks of the default process group (or a world
    of one), this rank's place in it and its device.

    The collectives of the distributed operators are its methods; in a world
    of one without a process group they are local copies.
    """

    axis: str
    num_shards: int
    rank: int
    device: torch.device
    distributed: bool  # a process group runs the collectives

    @classmethod
    def create(
        cls,
        num_devices: Optional[int] = None,
        axis: Optional[str] = None,
        devices: Optional[DeviceLike] = None,
    ) -> "MeshRuntime":
        """The default process group's mesh, or a world of one.

        num_devices: checked against the group's size.  devices: this rank's
        device, ``cuda:LOCAL_RANK`` by default, so pass ``"cpu"`` to run on
        the CPU.
        """
        distributed = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if distributed else 1
        rank = dist.get_rank() if distributed else 0
        if num_devices is not None and num_devices != world:
            raise ArrowTorchError(f"the mesh has {world} ranks, not {num_devices}")
        device = _local_device() if devices is None else torch.device(devices)
        return cls(axis or DEFAULT_AXIS, world, rank, device, distributed)

    # -- collectives ----------------------------------------------------------

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(P, *t.shape): every rank's `t`, in rank order, on every rank.
        Gathered as bytes (gloo has no int16)."""
        if not self.distributed:
            return t.unsqueeze(0)
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        parts: List[torch.Tensor] = [torch.empty_like(raw) for _ in range(self.num_shards)]
        dist.all_gather(parts, raw)
        return torch.stack(parts).view(t.dtype).reshape(self.num_shards, *t.shape)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t`, in place."""
        if self.distributed:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor, out_splits: List[int],
                   in_splits: List[int], async_op: bool = False):
        """Ragged all-to-all along dim 0: `in_splits[d]` rows of `inp` go to
        rank d, `out_splits[s]` rows from rank s land in `out`, in rank order.
        Returns the work handle when `async_op`, else None."""
        if not self.distributed:
            out.copy_(inp)
            return None
        return dist.all_to_all_single(out, inp, out_splits, in_splits, async_op=async_op)

    def __repr__(self) -> str:
        return f"MeshRuntime(axis={self.axis!r}, shards={self.num_shards}, rank={self.rank}, device={self.device})"
