"""Device health checking and guarded execution (counterpart of
``arrow_tpu/runtime/health.py``).

:func:`probe_device` runs a trivial op on the device under a deadline and
:func:`with_deadline` runs any call under one, so that a caller can bound
the cost of a device that stopped answering.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time
from typing import Any, Callable

import torch

from .device import as_device

log = logging.getLogger("arrow_tpu_torch")


class DeviceWedgedError(RuntimeError):
    """The device did not answer a trivial op within the deadline."""


def probe_device(timeout_s: float = 30.0, device=None) -> float:
    """Run a trivial op on `device` (the port's default device when None),
    wait for it to finish and return the latency in seconds.

    Raises DeviceWedgedError on timeout.  A CUDA call cannot be cancelled:
    the worker thread is left behind, so a failed probe should be treated as
    fatal for this process."""
    dev = as_device(device).torch_device

    def _ping() -> float:
        t0 = time.perf_counter()
        x = torch.zeros(8, dtype=torch.float32, device=dev) + 1.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        float(x[0])
        return time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(_ping)
    try:
        return fut.result(timeout=timeout_s)
    except concurrent.futures.TimeoutError:
        raise DeviceWedgedError(f"device {dev} did not answer within {timeout_s}s") from None
    finally:
        pool.shutdown(wait=False)


def with_deadline(fn: Callable[[], Any], timeout_s: float, default: Any = None):
    """Run fn in a worker thread with a deadline; returns (ok, result).

    On timeout the call keeps running detached (it cannot be cancelled);
    the caller decides whether to continue or abort."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(fn)
    try:
        return True, fut.result(timeout=timeout_s)
    except concurrent.futures.TimeoutError:
        log.error("arrow_tpu_torch: call exceeded %.0fs deadline", timeout_s)
        return False, default
    finally:
        pool.shutdown(wait=False)
