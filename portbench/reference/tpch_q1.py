"""TPC-H Q1 (DELTA = 90): the rows filtered by a boolean index, the key and
the two price expressions in int64, then the group-by of
``common.groupby``; the count by ``torch.unique``.  Under `lower` the sums
and the count are kept in int16 (wrapping), as ``common.groupby`` keeps
its integer sums."""

import torch

from portbench.reference.common import groupby


def run(config, tables, lower=False):
    li = tables["lineitem"]
    keep = li["l_shipdate"] <= int(config["ship_cutoff"])
    col = {name: li[name][keep].to(torch.int64) for name in
           ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    key = col["l_returnflag"] * 2 + col["l_linestatus"]
    qty, price, disc = col["l_quantity"], col["l_extendedprice"], col["l_discount"]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + col["l_tax"])
    out = groupby(key, [
        ("sum_qty", qty, "sum"), ("sum_base_price", price, "sum"), ("sum_disc_price", disc_price, "sum"),
        ("sum_charge", charge, "sum"), ("avg_qty", qty, "mean"), ("avg_price", price, "mean"),
        ("avg_disc", disc, "mean"),
    ], lower)
    count = torch.unique(key, sorted=True, return_counts=True)[1]
    out["count_order"] = count.to(torch.int16).to(torch.int64) if lower else count
    return out
