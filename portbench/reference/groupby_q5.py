"""groupby q5: sum v1:v3 by id6."""

from portbench.reference.common import column, groupby


def run(config, tables, lower=False):
    col = lambda name: column(config, tables, "x", name)  # noqa: E731
    return groupby(col("id6"), [(v, col(v), "sum") for v in ("v1", "v2", "v3")], lower)
