"""groupby q1, sum v1 by id1: DT[, .(v1=sum(v1, na.rm=TRUE)), by=id1]."""

OPERATOR = "groupby"
TABLES = ("x",)
READS = {"x": ("id1", "v1")}


def run(att, tables, config):
    x = tables["x"]
    return att.compute.hash_aggregate(x["id1"], [("v1", x["v1"], "sum")])
