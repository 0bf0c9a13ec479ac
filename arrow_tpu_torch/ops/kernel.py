"""Op execution machinery: the AV record, the registry, eager dispatch.

Counterpart of ``arrow_tpu/ops/kernel.py``.  PyTorch runs eagerly, so an op
is a plain function over :class:`AV` records and ``dispatch`` calls it
directly; there is no jit cache.  The pipelined ``*_op`` forms and
``ComputePipeline`` are not ported yet: passing a pipeline raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .. import dtypes as dt
from ..array.array import ArrowArrayBase, make_array
from ..array.scalar import Scalar
from ..errors import OperationNotSupported


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
    name: str
    impl: Callable[..., Any]


_REGISTRY: dict[str, OpDef] = {}


def register(name: str):
    """Decorator registering an AV -> AV(s) kernel under `name`."""

    def deco(impl):
        _REGISTRY[name] = OpDef(name, impl)
        return impl

    return deco


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise OperationNotSupported(f"unknown op {name!r}") from None


def dispatch(
    op_name: str,
    operands: Sequence[Any],  # ArrowArrayBase | AV (scalar)
    params: Optional[dict] = None,
    pipeline=None,
):
    """Run a registered op eagerly on arrays and scalar AVs; returns array(s)."""
    if pipeline is not None:
        raise OperationNotSupported("ComputePipeline is not ported yet")
    avs = []
    device = None
    for o in operands:
        if isinstance(o, AV):
            avs.append(o)
        elif isinstance(o, ArrowArrayBase):
            avs.append(array_av(o))
            device = device or o.device
        else:
            raise TypeError(f"bad operand {type(o)}")
    outs = get_op(op_name).impl(*avs, **(params or {}))
    if isinstance(outs, AV):
        outs = (outs,)
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
