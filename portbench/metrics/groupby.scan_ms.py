"""groupby.scan_ms: the device-busy ms per traced query of the work launched
inside the group starts and segmented scans (``att.groupby.scan``) and the
group-end compaction with the group count's read (``att.groupby.compact``)."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.groupby.scan", "att.groupby.compact")
