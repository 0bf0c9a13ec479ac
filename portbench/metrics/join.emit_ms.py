"""join.emit_ms: the device-busy ms per traced query of the work launched
inside the join's merge-expand emit (``att.join.expand`` and
``att.join.rank_fill``)."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.join.expand", "att.join.rank_fill")
