"""groupby.prepare_ms: the device-busy ms per traced query of the work
launched inside the sort route's preparation (``att.groupby.prepare``): the
validity planes of the key and of each value column."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.groupby.prepare")
