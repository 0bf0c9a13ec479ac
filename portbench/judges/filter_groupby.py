"""The comparison of a filter followed by a group-by: a group-by's result,
compared as ``groupby`` compares it."""

from portbench.judges.groupby import compare  # noqa: F401
