"""filter_groupby_roofline (%): every filter-then-group-by query's least
bytes (each column it reads once, each group's key and aggregates written
once; the count does not depend on the route) over 3.35 TB/s, divided by
the device-busy time of the work launched inside those question spans: the
compare, the filter, the key and price expressions and the group-by."""

from portbench.metrics.operator_roofline import share


def read(w):
    return share(w, "filter_groupby")
