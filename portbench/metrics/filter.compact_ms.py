"""filter.compact_ms: the device-busy ms per traced query of the work
launched inside the port's filter (``att.filter``): B1's compaction of
every column and the count's read."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.filter")
