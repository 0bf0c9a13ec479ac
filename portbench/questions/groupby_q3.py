"""groupby q3, sum v1 and mean v3 by id3:
DT[, .(v1=sum(v1, na.rm=TRUE), v3=mean(v3, na.rm=TRUE)), by=id3]."""

OPERATOR = "groupby"
TABLES = ("x",)
READS = {"x": ("id3", "v1", "v3")}


def run(att, tables, config):
    x = tables["x"]
    return att.compute.hash_aggregate(x["id3"], [("v1", x["v1"], "sum"), ("v3", x["v3"], "mean")])
