"""Broadcast: scalar -> constant array of a given length.

Counterpart of ``arrow_tpu/ops/broadcast.py``: one ``torch.full`` for every
dtype (packed words for BOOL), zero past the length.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import dtypes as dt
from ..array.array import pad_len, pad_words
from ..array.scalar import Scalar
from ..runtime.device import default_device
from ..utils import bits as B
from .kernel import AV, dispatch, register, scalar_av, zero_tail


def _bcast_meta(avs, params):
    return [(avs[0].dtype, params["length"])]


@register("broadcast", out_meta=_bcast_meta)
def _broadcast_impl(s: AV, length: int) -> AV:
    if s.dtype is dt.ArrowType.BOOL:
        words = torch.where(s.data, -1, 0).to(torch.int32).expand(pad_words(length))
        return AV(B.mask_tail(words, length), None, length, s.dtype)
    data = zero_tail(s.data.expand(pad_len(length)).clone(), length)
    return AV(data, None, length, s.dtype)


def broadcast(value, length: int, dtype: Optional[dt.ArrowType] = None, pipeline=None):
    """A constant array of `length` rows (a BOOL, INT32 or FLOAT32 one by the
    Python type of `value` when no dtype is given), on the pipeline's device
    or the default device."""
    device = (pipeline.device if pipeline is not None else default_device()).torch_device
    if isinstance(value, Scalar):
        sav = scalar_av(value, value.dtype, device)
    else:
        if dtype is None:
            if isinstance(value, bool):
                dtype = dt.ArrowType.BOOL
            elif isinstance(value, int):
                dtype = dt.ArrowType.INT32
            else:
                dtype = dt.ArrowType.FLOAT32
        sav = scalar_av(value, dtype, device)
    return dispatch("broadcast", [sav], params={"length": length}, pipeline=pipeline)


def broadcast_op(value, length, pipeline, dtype=None):
    return broadcast(value, length, dtype, pipeline)


broadcast_dyn = broadcast
broadcast_op_dyn = broadcast_op

__all__ = ["broadcast", "broadcast_dyn", "broadcast_op", "broadcast_op_dyn"]
