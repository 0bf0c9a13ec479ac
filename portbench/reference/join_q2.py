"""join q2: x INNER JOIN medium ON id2."""

from portbench.reference.common import inner_join


def run(config, tables, lower=False):
    return inner_join(config, tables, "x", "medium", "id2", lower)
