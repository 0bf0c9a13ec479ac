"""groupby q2, sum v1 by id1:id2: DT[, .(v1=sum(v1, na.rm=TRUE)), by=.(id1, id2)].

The two factors are grouped on one composite key, id1 * K + id2, made with
the ops tier; the result's key is that composite."""

OPERATOR = "groupby"
TABLES = ("x",)
READS = {"x": ("id1", "id2", "v1")}


def run(att, tables, config):
    x = tables["x"]
    key = att.kernels.add(att.kernels.mul_scalar(x["id1"], int(config["K"])), x["id2"])
    return att.compute.hash_aggregate(key, [("v1", x["v1"], "sum")])
