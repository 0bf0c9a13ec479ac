"""Kernel tier: elementwise, reduction and swizzle ops over Arrow arrays
(counterpart of ``arrow_tpu/ops``)."""

from . import (  # noqa: F401  (registration side effects)
    aggregate,
    arithmetic,
    broadcast,
    cast,
    compare,
    logical,
    math_ops,
    swizzle,
    trigonometry,
)
from .kernel import AV, dispatch, execute, register

__all__ = [
    "AV",
    "aggregate",
    "arithmetic",
    "broadcast",
    "cast",
    "compare",
    "dispatch",
    "execute",
    "logical",
    "math_ops",
    "register",
    "swizzle",
    "trigonometry",
]
