"""Distributed tier: mesh runtime, sharded batches, shuffle, distributed ops.

Counterpart of ``arrow_tpu/parallel`` on ``torch.distributed``: one process
a shard, NCCL between CUDA devices and gloo on the CPU (see ``mesh``).
``dryrun`` holds the counterpart of ``__graft_entry__.dryrun_multichip`` and
the helper that spawns one process a rank.
"""

from .distributed_ops import (
    distributed_aggregate,
    distributed_filter,
    distributed_join,
    distributed_join_indices,
    distributed_sort,
    distributed_sum,
)
from .dryrun import dryrun_multichip
from .mesh import MeshRuntime, initialize_distributed
from .sharding import ShardedBatch, ShardedColumn, gather_batch, shard_batch
from .shuffle import fmix32, fmix64, hash_key, hash_partition

__all__ = [
    "MeshRuntime",
    "ShardedBatch",
    "ShardedColumn",
    "distributed_aggregate",
    "distributed_filter",
    "distributed_join",
    "distributed_join_indices",
    "distributed_sort",
    "distributed_sum",
    "dryrun_multichip",
    "fmix32",
    "fmix64",
    "gather_batch",
    "hash_key",
    "hash_partition",
    "initialize_distributed",
    "shard_batch",
]
