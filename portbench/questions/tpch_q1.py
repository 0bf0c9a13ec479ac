"""TPC-H Q1, the pricing summary report, with DELTA = 90:

    select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
           sum(l_extendedprice * (1 - l_discount)),
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
    from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day
    group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus

The decimals are int64 counts of 0.01, so (1 - l_discount) is
(100 - l_discount) at scale 100 and each product exact in int64.  The two
flags are grouped on one key, l_returnflag * 2 + l_linestatus, made with
the ops tier; the result's key is that composite, in the flags' order."""

OPERATOR = "filter_groupby"
TABLES = ("lineitem",)
READS = {"lineitem": ("l_shipdate", "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
                      "l_discount", "l_tax")}


def run(att, tables, config):
    li, k = tables["lineitem"], att.kernels
    keep = k.lteq_scalar(li["l_shipdate"], int(config["ship_cutoff"]))
    x = att.compute.filter(att.RecordBatch({name: li[name] for name in READS["lineitem"][1:]}), keep)
    key = k.add(k.mul_scalar(x["l_returnflag"], 2), x["l_linestatus"])
    qty, price, disc = x["l_quantity"], x["l_extendedprice"], x["l_discount"]
    disc_price = k.mul(price, k.add_scalar(k.neg(disc), 100))
    charge = k.mul(disc_price, k.add_scalar(x["l_tax"], 100))
    return att.compute.hash_aggregate(key, [
        ("sum_qty", qty, "sum"), ("sum_base_price", price, "sum"), ("sum_disc_price", disc_price, "sum"),
        ("sum_charge", charge, "sum"), ("avg_qty", qty, "mean"), ("avg_price", price, "mean"),
        ("avg_disc", disc, "mean"), ("count_order", None, "count"),
    ], method="auto")
