"""join.take_ms: the device-busy ms per traced query of the work launched
inside the join's output gathers, every column by its row ids
(``att.join.take``)."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.join.take")
