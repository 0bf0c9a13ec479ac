"""groupby q3: sum v1 and mean v3 by id3."""

from portbench.reference.common import column, groupby


def run(config, tables, lower=False):
    col = lambda name: column(config, tables, "x", name)  # noqa: E731
    return groupby(col("id3"), [("v1", col("v1"), "sum"), ("v3", col("v3"), "mean")], lower)
