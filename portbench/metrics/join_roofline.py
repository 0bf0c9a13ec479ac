"""join_roofline (%): every join query's least bytes (every column of both
tables read once, every output column written once at the match count)
over 3.35 TB/s, divided by the device-busy time of the work launched inside
the join question spans."""

from portbench.metrics.operator_roofline import share


def read(w):
    return share(w, "join")
