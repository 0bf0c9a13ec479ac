"""Elementwise kernel tier (ported so far: compare)."""

from . import compare, kernel

__all__ = ["compare", "kernel"]
