"""join q1, small inner on int: x[small, on="id1", nomatch=NULL]; small is the build side."""

OPERATOR = "join"
TABLES = ("x", "small")
READS = {"x": "*", "small": "*"}


def run(att, tables, config):
    return att.compute.hash_join(tables["x"], tables["small"], "id1", "id1")
