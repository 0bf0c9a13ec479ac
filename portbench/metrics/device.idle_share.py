"""device.idle_share (%): the share of the traced window in which no
kernel, copy or fill ran on the card.  The profiler's own buffer requests
inside the idle time are printed apart on an earlier line."""

from portbench.metrics.shares import idle_share as read  # noqa: F401
