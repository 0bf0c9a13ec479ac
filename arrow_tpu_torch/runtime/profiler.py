"""Per-op profiling (counterpart of ``arrow_tpu/runtime/profiler.py``).

A process-wide log of wall times: :func:`record` appends one, and
:func:`timed_call` times a call to the end of its device work (a
``torch.cuda.synchronize`` when an output lies on the card, where the JAX
package blocks until its arrays are ready).  With ``config.profile`` set
(``ARROW_TPU_PROFILE=1``) every eager op is logged under its name and every
``ComputePipeline.finish()`` under ``pipeline[<n> ops]``.

:func:`device_report` runs a call once under ``torch.profiler`` and gives
each device kernel's time; :func:`start_trace`, :func:`stop_trace` and
:func:`trace` write a Chrome trace (``trace.json``) into a directory.

:func:`span` names a phase of the port's operators (``att.groupby.order``,
``att.join.plan``, ...) and :func:`host_read` a statement that waits for
the device (``att.sync.<cause>``).  Both are
``record_function`` spans while a ``torch.profiler`` records, so they sit in
the same trace as the device work they launch and on its clock; otherwise
they are one shared no-op context and cost a flag read.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

log = logging.getLogger("arrow_tpu_torch")

_TIMINGS: Dict[str, List[float]] = defaultdict(list)
_NO_SPAN = contextlib.nullcontext()
#: the runtime calls that launch a kernel (the trace's host side)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def span(name: str):
    """A ``record_function`` span called `name` while a profiler records;
    otherwise one shared no-op context, so that nothing is built."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


def host_read(cause: str):
    """The span ``att.sync.<cause>`` around a statement that waits for the
    device: a device value read on the host, or a Python scalar that torch
    copies from the host into a device tensor."""
    return span(f"att.sync.{cause}")


def record(name: str, seconds: float) -> None:
    _TIMINGS[name].append(seconds)
    log.debug("arrow_tpu_torch profile: %s took %.3f ms", name, seconds * 1e3)


@contextlib.contextmanager
def profile_region(name: str):
    """Time a region on the host clock (the caller synchronizes inside it
    when the device's work is to count)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def held_tensors(out):
    """The tensors held by a call's result: tensors, arrays and bound
    pipeline handles, record batches, and lists, tuples and dicts of them."""
    from ..array.array import ArrowArrayBase
    from .pipeline import LazyArray

    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, LazyArray):
        if out.is_bound:
            yield from held_tensors(out.bound())
    elif isinstance(out, ArrowArrayBase):
        yield out.data
        if out.validity is not None:
            yield out.validity
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from held_tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from held_tensors(o)
    elif callable(getattr(out, "columns", None)):  # a RecordBatch
        yield from held_tensors(out.columns())


def _wait(out) -> None:
    """Wait for the device work that produced `out`."""
    devices = {t.device for t in held_tensors(out) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def timed_call(name: str, fn, *args):
    """Run fn(*args), wait until its device work is done, and record the
    wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    _wait(out)
    record(name, time.perf_counter() - t0)
    return out


def timings() -> Dict[str, List[float]]:
    return dict(_TIMINGS)


def reset() -> None:
    _TIMINGS.clear()


def summary() -> str:
    lines = []
    for name, ts in sorted(_TIMINGS.items()):
        total = sum(ts)
        lines.append(
            f"{name:32s} calls={len(ts):5d} total={total*1e3:9.2f}ms "
            f"mean={total/len(ts)*1e3:8.3f}ms"
        )
    return "\n".join(lines)


# -- per-kernel device time ---------------------------------------------------


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def lost_kernels(events) -> int:
    """The runtime launch calls of a trace's events less its device kernel
    events (copies and fills apart): above 0 when the trace lost device
    records, as CUPTI does late in a long process."""
    from torch.autograd import DeviceType

    launches = kernels = 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif e.name in LAUNCH_CALLS:
            launches += 1
    return launches - kernels


def device_report(fn, *args, top: int = 25, logdir: Optional[str] = None):
    """Run ``fn(*args)`` once under ``torch.profiler`` and return
    ``[(kernel, calls, total_ms)]`` sorted by total time.

    On the card the rows are the device's kernels, copies and fills by name.
    Where the profiler saw no device activity (a call on the CPU) they are
    the CPU ops by their self time.  Each row is also folded into the
    process-wide log under ``device:<kernel>``; with `logdir`, the Chrome
    trace is written there as ``trace.json``.  A trace that holds fewer
    kernel events than launch calls is logged as a warning with the
    shortfall: its rows then undercount."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=_activities()) as prof:
        out = fn(*args)
        _wait(out)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    events = prof.events()
    lost = lost_kernels(events)
    if lost > 0:
        log.warning("device_report: the trace lost %d of its %d launched kernels' device records; "
                    "its rows undercount", lost, sum(e.name in LAUNCH_CALLS for e in events))
    agg: Dict[str, List[float]] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            a = agg.setdefault(e.name, [0.0, 0])
            a[0] += e.time_range.elapsed_us()
            a[1] += 1
    if not agg:
        for e in prof.key_averages():
            if e.self_cpu_time_total > 0 and not e.key.startswith("att."):
                agg[e.key] = [float(e.self_cpu_time_total), e.count]
    rows = sorted(((n, int(c), us / 1e3) for n, (us, c) in agg.items()), key=lambda r: -r[2])[:top]
    for n, _c, ms in rows:
        record(f"device:{n}", ms / 1e3)
    return rows


def device_summary(rows) -> str:
    lines = [f"{'kernel':48s} {'calls':>6s} {'total_ms':>10s}"]
    for n, c, ms in rows:
        lines.append(f"{n[:48]:48s} {c:6d} {ms:10.3f}")
    return "\n".join(lines)


# -- torch.profiler traces ------------------------------------------------------

_TRACE: Optional[tuple] = None  # (profiler, logdir) of the running trace


def start_trace(logdir: str) -> None:
    """Start a torch.profiler trace whose Chrome trace :func:`stop_trace`
    writes into `logdir`."""
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("a trace is already running")
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    _TRACE = (prof, logdir)


def stop_trace() -> None:
    global _TRACE
    if _TRACE is None:
        raise RuntimeError("no trace is running")
    (prof, logdir), _TRACE = _TRACE, None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def trace(logdir: str):
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()
