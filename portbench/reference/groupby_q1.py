"""groupby q1: sum v1 by id1."""

from portbench.reference.common import column, groupby


def run(config, tables, lower=False):
    col = lambda name: column(config, tables, "x", name)  # noqa: E731
    return groupby(col("id1"), [("v1", col("v1"), "sum")], lower)
