"""Device time of one application of an op (counterpart of
``arrow_tpu/utils/timing.py``).

:func:`device_seconds_per_iter` runs `fn` k times in a chain, each call's
output the next call's input (so no call can reuse another's result), for
two values of k, and takes the slope of the time over k: the fixed costs of
a run (the first launch, the wait for the device) cancel.  On the card a run
is timed between two CUDA events; on the CPU by the host clock.

:func:`queued_seconds_per_call` times calls whose host side takes longer
than their device work (a small kernel behind a Python wrapper): a spin
kernel holds the stream while the host enqueues the calls, so that the
events around them time the device alone.
"""

from __future__ import annotations

import functools
import statistics
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..runtime.profiler import held_tensors


def _chain(fn: Callable, args: tuple, k: int) -> tuple:
    for _ in range(k):
        out = fn(*args)
        args = out if isinstance(out, tuple) else (out,)
    return args


def _run_seconds(fn: Callable, args: tuple, k: int, cuda: bool) -> float:
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _chain(fn, args, k)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    _chain(fn, args, k)
    return time.perf_counter() - t0


def device_seconds_per_iter(
    fn: Callable,
    args,
    k_lo: int = 3,
    k_hi: int = 13,
    repeats: int = 2,
) -> float:
    """Median seconds per application of `fn` (shape-preserving: its output
    has the form of its arguments).

    Samples slopes until at least max(repeats, 3) are positive and the two
    closest agree within 30%, up to 6 samples, and returns the median of the
    positive ones."""
    args = args if isinstance(args, tuple) else (args,)
    k_lo, k_hi = int(k_lo), int(k_hi)
    cuda = any(t.is_cuda for t in held_tensors(args))
    for k in (k_lo, k_hi):  # warm-up: allocations, kernel builds
        _run_seconds(fn, args, k, cuda)
    want = max(int(repeats), 3)
    slopes: list = []
    for _ in range(6):
        t_lo = _run_seconds(fn, args, k_lo, cuda)
        t_hi = _run_seconds(fn, args, k_hi, cuda)
        slopes.append((t_hi - t_lo) / (k_hi - k_lo))
        pos = sorted(s for s in slopes if s > 0)
        if len(pos) >= want:
            gaps = [b / a for a, b in zip(pos, pos[1:])]
            if gaps and min(gaps) < 1.3:
                break
    pos = [s for s in slopes if s > 0]
    return max(float(np.median(pos or slopes)), 1e-9)


SPIN_CYCLES = 50_000_000  # the spin that measures the spin kernel's rate


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms(device: int) -> float:
    """``torch.cuda._sleep``'s cycles a millisecond on the current card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    return SPIN_CYCLES / start.elapsed_time(end)


def queued_seconds_per_call(fn: Callable, calls: int = 32, repeats: int = 5) -> Optional[float]:
    """Device seconds a call of `fn` (CUDA work on the current stream), the
    median of `repeats` samples of `calls` calls enqueued behind a spin
    kernel that lasts twice the host's time to enqueue them: the events
    around the calls time the device's work, launch gaps included, and not
    the host's.

    Where the host cannot get ahead (the calls' launches fill CUDA's queue
    of pending launches and the host waits on the device), the samples are
    taken again with a quarter of the calls.  None where it cannot on one
    call either: `fn` waits on the device itself (it reads a device value
    on the host), so only its host-bound time exists."""
    fn()
    rate = _spin_cycles_per_ms(torch.cuda.current_device())
    spin_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        spin = int((2 * (time.perf_counter() - t0) * 1e3 + 1.0) * rate)
        samples = []
        for _ in range(repeats):
            spin_start.record()
            torch.cuda._sleep(spin)
            start.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            end.synchronize()
            if host_ms >= spin_start.elapsed_time(start):
                break  # the spin ended before the host had enqueued the calls
            samples.append(start.elapsed_time(end) / 1e3 / calls)
        if len(samples) == repeats:
            return statistics.median(samples)
        if calls == 1:
            return None
        calls = max(1, calls // 4)
