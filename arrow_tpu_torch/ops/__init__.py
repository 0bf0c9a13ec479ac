"""Elementwise kernel tier (ported so far: compare, and take from swizzle)."""

from . import compare, kernel, swizzle

__all__ = ["compare", "kernel", "swizzle"]
