"""Flat kernel namespace (counterpart of ``arrow_tpu/kernels.py``).

Only the compare ops are ported so far; the rest of the elementwise tier
follows in later slices.
"""

from .ops.compare import *  # noqa: F401,F403
