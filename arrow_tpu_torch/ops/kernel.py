"""Op execution machinery: the AV record, the registry, eager dispatch.

Counterpart of ``arrow_tpu/ops/kernel.py``.  PyTorch runs eagerly, so an op
is a plain function over :class:`AV` records and :func:`execute` calls it
directly; there is no jit cache.  Every op comes in an eager (``foo``) and a
pipelined (``foo_op``) form: the pipelined form records into a
:class:`~arrow_tpu_torch.runtime.pipeline.ComputePipeline`, whose ``finish()``
replays the recorded ops.  Each registered op carries an ``out_meta``
function that gives its outputs' dtypes and lengths without running it (the
pipeline's handles expose them before ``finish()``).

Every op returns buffers that are zero at and past the logical length (the
array layer's invariant): an op whose function is not zero at zero clears its
output's tail with :func:`zero_tail`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..array.scalar import Scalar
from ..errors import OperationNotSupported
from ..runtime import profiler


class AV(NamedTuple):
    """An array value: storage tensors plus the static length and dtype.

    For BOOL, `data` is the packed int32 word buffer.  A scalar operand is an
    AV with 0-d `data` and length -1 (see :func:`scalar_av`).
    """

    data: torch.Tensor
    validity: Optional[torch.Tensor]
    length: int
    dtype: dt.ArrowType

    @property
    def is_scalar(self) -> bool:
        return self.length == -1


def scalar_av(
    value: Union[Scalar, int, float, bool, np.generic], dtype: dt.ArrowType, device=None
) -> AV:
    """A scalar AV: the value converted to `dtype` (as numpy converts it),
    held as a 0-d storage tensor."""
    v = value.value if isinstance(value, Scalar) else value
    if dtype is dt.ArrowType.BOOL:
        t = torch.tensor(bool(v), device=device)
    else:
        host = np.asarray(v, dtype=dt.info(dtype).numpy).reshape(1)
        t = torch.from_numpy(dt.to_storage_np(host, dtype).copy()).to(device)[0]
    return AV(t, None, -1, dtype)


def array_av(arr: ArrowArrayBase) -> AV:
    return AV(arr.data, arr.validity, arr.length, arr.dtype)


@dataclasses.dataclass(frozen=True)
class OpDef:
    """A registered op: `impl` maps input AVs -> output AV(s); `out_meta`
    maps input AVs (only their dtype and length are read) and the params to
    the outputs' (dtype, length) pairs."""

    name: str
    impl: Callable[..., Any]
    out_meta: Callable[..., Sequence[Tuple[dt.ArrowType, int]]]


_REGISTRY: dict[str, OpDef] = {}


def _first_array_meta(avs, params):
    first = next(a for a in avs if not a.is_scalar)
    return [(first.dtype, first.length)]


def register(name: str, out_meta: Optional[Callable] = None):
    """Decorator registering an AV -> AV(s) op under `name`.

    Default out_meta: one output with the dtype and length of the first
    array input."""

    def deco(impl):
        _REGISTRY[name] = OpDef(name, impl, out_meta or _first_array_meta)
        return impl

    return deco


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise OperationNotSupported(f"unknown op {name!r}") from None


def execute(op_name: str, avs: Sequence[AV], params: Optional[dict] = None) -> list:
    """Run a registered op eagerly; returns the list of output AVs.  With
    ``config.profile`` set, its wall time to the end of its device work is
    logged under the op's name.  Under a profiler the call is an
    ``att.op.<name>`` span."""
    from ..config import config

    impl = get_op(op_name).impl
    with profiler.span(f"att.op.{op_name}"):
        if config.profile:
            outs = profiler.timed_call(op_name, lambda: impl(*avs, **(params or {})))
        else:
            outs = impl(*avs, **(params or {}))
    return [outs] if isinstance(outs, AV) else list(outs)


def dispatch(
    op_name: str,
    operands: Sequence[Any],  # ArrowArrayBase | LazyArray | AV (scalar)
    params: Optional[dict] = None,
    pipeline=None,
):
    """Run a registered op on arrays, pipeline handles and scalar AVs.

    Returns array(s) eagerly, or LazyArray handle(s) recorded into
    `pipeline` when one is given."""
    from ..runtime.pipeline import ComputePipeline, LazyArray

    if pipeline is not None:
        if not isinstance(pipeline, ComputePipeline):
            raise TypeError(f"pipeline must be a ComputePipeline, not {type(pipeline).__name__}")
        return pipeline.record(op_name, operands, params or {})
    avs = []
    device = None
    for o in operands:
        if isinstance(o, LazyArray):
            o = o.bound()
        if isinstance(o, AV):
            avs.append(o)
        elif isinstance(o, ArrowArrayBase):
            avs.append(array_av(o))
            device = device or o.device
        else:
            raise TypeError(f"bad operand {type(o)}")
    outs = execute(op_name, avs, params)
    wrapped = [make_array(o.data, o.validity, o.length, o.dtype, device) for o in outs]
    return wrapped[0] if len(wrapped) == 1 else wrapped


def merged_validity(*avs: AV) -> Optional[torch.Tensor]:
    """AND of all present validity buffers (scalar AVs contribute none)."""
    out = None
    for a in avs:
        if a.validity is not None:
            out = a.validity if out is None else (out & a.validity)
    return out


def scalar_data(b: AV) -> torch.Tensor:
    """0-d rhs for a scalar op: a true scalar AV, or element 0 of a 1-row array."""
    return b.data if b.is_scalar else b.data[0]


def zero_tail(out: torch.Tensor, length: int) -> torch.Tensor:
    """Clear the rows at and past `length` of a value buffer the op owns."""
    if out.shape[0] > length:
        out[length:] = 0
    return out
