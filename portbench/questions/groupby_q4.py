"""groupby q4, mean v1:v3 by id4: DT[, lapply(.SD, mean, na.rm=TRUE), by=id4, .SDcols=v1:v3]."""

OPERATOR = "groupby"
TABLES = ("x",)
READS = {"x": ("id4", "v1", "v2", "v3")}


def run(att, tables, config):
    x = tables["x"]
    return att.compute.hash_aggregate(
        x["id4"], [("v1", x["v1"], "mean"), ("v2", x["v2"], "mean"), ("v3", x["v3"], "mean")]
    )
