"""Flat kernel namespace (counterpart of ``arrow_tpu/kernels.py``).

Ported so far: the compare ops and ``take``; the rest of the elementwise
tier follows in later slices.
"""

from .ops.compare import *  # noqa: F401,F403
from .ops.swizzle import take  # noqa: F401
