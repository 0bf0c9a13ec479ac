"""groupby q4: mean v1:v3 by id4."""

from portbench.reference.common import column, groupby


def run(config, tables, lower=False):
    col = lambda name: column(config, tables, "x", name)  # noqa: E731
    return groupby(col("id4"), [(v, col(v), "mean") for v in ("v1", "v2", "v3")], lower)
