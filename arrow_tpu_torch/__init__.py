"""arrow_tpu_torch: the PyTorch/CUDA port of arrow_tpu.

Same layout and public names as ``arrow_tpu``; buffers are torch tensors on a
:class:`Device`, and the operator kernels are hand-written CUDA for Hopper
(``arrow_tpu_torch/csrc``), each with a plain PyTorch version that runs on
the CPU.  Imports torch and numpy, never jax.

    import arrow_tpu_torch as att
    from arrow_tpu_torch import kernels as K, compute as C
    batch = att.RecordBatch.from_numpy({"k": keys, "v": vals}, device="cuda")
    kept = C.filter(batch, K.gt_scalar(batch["v"], 0.0))
    C.hash_aggregate(kept["k"], [("total", kept["v"], "sum"), ("n", None, "count")])
    with att.ComputePipeline() as pipe:  # ops recorded, then run in one finish()
        r = K.mul_scalar_op(K.add_scalar_op(batch["v"], 1.0, pipe), 2.0, pipe)
"""

from . import dtypes
from .array import (
    ArrowArray,
    ArrowArrayBase,
    BitBufferBuilder,
    BooleanArray,
    Buffer,
    Date32Array,
    Float32Array,
    Float64Array,
    Int8Array,
    Int16Array,
    Int32Array,
    Int64Array,
    NullBitBuffer,
    PrimitiveArray,
    Scalar,
    UInt8Array,
    UInt16Array,
    UInt32Array,
    UInt64Array,
    as_scalar,
    make_array,
)
from .config import config, set_config
from .dtypes import ArrowType, DataType
from .errors import ArrowTorchError, CastingNotSupported, OperationNotSupported
from .runtime import ComputePipeline, Device, LazyArray, default_device, set_default_device
from .table import RecordBatch, Table

from . import compute, io, kernels  # noqa: E402  (after the array types)
from .runtime import fusion  # noqa: E402,F401  (registers the fused_pipeline kernel)

__version__ = "0.1.0"

__all__ = [
    "ArrowArray",
    "ArrowArrayBase",
    "ArrowTorchError",
    "ArrowType",
    "BitBufferBuilder",
    "BooleanArray",
    "Buffer",
    "CastingNotSupported",
    "ComputePipeline",
    "DataType",
    "Date32Array",
    "Device",
    "Float32Array",
    "Float64Array",
    "Int8Array",
    "Int16Array",
    "Int32Array",
    "Int64Array",
    "LazyArray",
    "NullBitBuffer",
    "OperationNotSupported",
    "PrimitiveArray",
    "RecordBatch",
    "Scalar",
    "Table",
    "UInt8Array",
    "UInt16Array",
    "UInt32Array",
    "UInt64Array",
    "as_scalar",
    "compute",
    "config",
    "default_device",
    "dtypes",
    "io",
    "kernels",
    "make_array",
    "set_config",
    "set_default_device",
]
