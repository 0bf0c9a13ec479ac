"""groupby.gather_ms: the device-busy ms per traced query of the work
launched inside the gathers of the key and of every value and validity plane
by the sort's permutation (``att.groupby.gather``)."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.groupby.gather")
