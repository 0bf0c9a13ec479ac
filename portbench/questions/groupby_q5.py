"""groupby q5, sum v1:v3 by id6: DT[, lapply(.SD, sum, na.rm=TRUE), by=id6, .SDcols=v1:v3]."""

OPERATOR = "groupby"
TABLES = ("x",)
READS = {"x": ("id6", "v1", "v2", "v3")}


def run(att, tables, config):
    x = tables["x"]
    return att.compute.hash_aggregate(
        x["id6"], [("v1", x["v1"], "sum"), ("v2", x["v2"], "sum"), ("v3", x["v3"], "sum")]
    )
