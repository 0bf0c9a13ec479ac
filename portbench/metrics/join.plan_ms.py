"""join.plan_ms: the device-busy ms per traced query of the work launched
inside the join's plan (``att.join.plan``): the co-sort, the run bounds and
the build and run lists, with their host reads."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.join.plan")
