"""join q2, medium inner on int: x[medium, on="id2", nomatch=NULL]; medium is the build side."""

OPERATOR = "join"
TABLES = ("x", "medium")
READS = {"x": "*", "medium": "*"}


def run(att, tables, config):
    return att.compute.hash_join(tables["x"], tables["medium"], "id2", "id2")
