"""groupby_roofline (%): every group-by query's least bytes (each key and
value column it reads once, each group's key and aggregates written once;
the count does not depend on the route) over 3.35 TB/s, divided by the
device-busy time of the work launched inside the group-by question spans
(q2's composite key included)."""

from portbench.metrics.operator_roofline import share


def read(w):
    return share(w, "groupby")
