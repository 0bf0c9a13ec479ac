"""join q5, big inner on int: x[big, on="id3", nomatch=NULL]; big is the build side."""

OPERATOR = "join"
TABLES = ("x", "big")
READS = {"x": "*", "big": "*"}


def run(att, tables, config):
    return att.compute.hash_join(tables["x"], tables["big"], "id3", "id3")
