"""groupby q2: sum v1 by id1:id2, on the composite key id1 * K + id2."""

from portbench.reference.common import column, groupby


def run(config, tables, lower=False):
    col = lambda name: column(config, tables, "x", name)  # noqa: E731
    key = col("id1") * int(config["K"]) + col("id2")
    return groupby(key, [("v1", col("v1"), "sum")], lower)
