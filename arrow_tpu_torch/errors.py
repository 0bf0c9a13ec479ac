"""Error types (counterpart of ``arrow_tpu/errors.py``)."""

from __future__ import annotations


class ArrowTorchError(Exception):
    """Base error."""


class OperationNotSupported(ArrowTorchError):
    """Op not registered for the given dtype(s), or not ported yet."""


class CastingNotSupported(ArrowTorchError):
    """Cast pair not registered."""
