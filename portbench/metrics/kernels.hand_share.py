"""kernels.hand_share (%): the hand-written kernels' device time over all
device-busy time in the traced window; the rest is library ops, copies and
glue."""

from portbench.metrics.shares import hand_share as read  # noqa: F401
