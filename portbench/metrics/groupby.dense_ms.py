"""groupby.dense_ms: the device-busy ms per traced query of the work
launched inside the dense routes' kernel calls (``att.groupby.dense_kernel``:
B5 on the mxu route, B6 on the partition route, and their planes)."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.groupby.dense_kernel")
