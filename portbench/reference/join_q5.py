"""join q5: x INNER JOIN big ON id3."""

from portbench.reference.common import inner_join


def run(config, tables, lower=False):
    return inner_join(config, tables, "x", "big", "id3", lower)
