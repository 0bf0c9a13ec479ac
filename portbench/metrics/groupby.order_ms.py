"""groupby.order_ms: the device-busy ms per traced query of the work launched
inside the group-by's sort (``att.groupby.order``: ``torch.sort``, B7 under
``ARROW_TPU_FORCE_MERGE=1``, or the radix route's B3)."""

from portbench.metrics.program_phase import device_ms


def read(w):
    return device_ms(w, "att.groupby.order")
