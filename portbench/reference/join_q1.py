"""join q1: x INNER JOIN small ON id1."""

from portbench.reference.common import inner_join


def run(config, tables, lower=False):
    return inner_join(config, tables, "x", "small", "id1", lower)
