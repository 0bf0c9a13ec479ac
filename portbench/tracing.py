"""The traced run: one ``torch.profiler`` trace over the traced window, read
in memory (no Chrome trace is written), and the spans it reads.

Spans come from the benchmark's own files (``record_function``):
``portbench.window`` around the traced window, ``portbench.query.<q>``
around each question's call into the port, and ``portbench.kernel.<k>``
around each call of a hand-written kernel's entry in
``arrow_tpu_torch.compute.kernels`` (:class:`KernelTap`, traced runs
only).  A device op belongs to the innermost span that its launch (the
CUDA runtime call with its correlation id) lies in.
"""

import bisect
import dataclasses
import json
import pathlib
import re
from typing import Dict, List, Optional, Tuple

import torch

from . import counting

HERE = pathlib.Path(__file__).resolve().parent
#: runtime calls by which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
BUFFER_REQUEST = "Activity Buffer Request"


def device_functions() -> dict:
    return json.loads((HERE / "kernels.json").read_text())["device_functions"]


def _function_pattern(names) -> re.Pattern:
    return re.compile(r"(?:^|[\s:])(" + "|".join(map(re.escape, names)) + r")[<(]")


class KernelTap:
    """Wraps the entry functions of ``compute.kernels`` that the operators
    call, so that each call made while `on` is a ``portbench.kernel.<name>``
    span and its least bytes are kept (``counting.KERNEL_CALLS``)."""

    def __init__(self, kernels_module):
        self.module = kernels_module
        self.saved = {}
        self.calls: List[Tuple[str, int, Optional[torch.Tensor], int]] = []
        self.on = False

    def install(self):
        for name, formula in counting.KERNEL_CALLS.items():
            orig = getattr(self.module, name)
            self.saved[name] = orig
            setattr(self.module, name, self._wrap(name, orig, formula))

    def uninstall(self):
        for name, orig in self.saved.items():
            setattr(self.module, name, orig)
        self.saved.clear()

    def _wrap(self, name, orig, formula):
        label = f"portbench.kernel.{name}"

        def call(*args, **kwargs):
            if not self.on:
                return orig(*args, **kwargs)
            with torch.profiler.record_function(label):
                out = orig(*args, **kwargs)
            self.calls.append((name, *formula(out, *args, **kwargs)))
            return out

        return call

    def total_bytes(self) -> int:
        """Every tapped call's least bytes; reads the compactions' counts."""
        total = 0
        for _name, fixed, count, per_row in self.calls:
            total += fixed + (0 if count is None else int(count) * per_row)
        return total


@dataclasses.dataclass
class Op:
    name: str
    start: int  # ns, the trace's clock
    end: int
    corr: int


def _union(intervals) -> int:
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (0 if cur_e is None else cur_e - cur_s)


class Spans:
    """Non-overlapping spans of one kind, sorted, with a lookup by time."""

    def __init__(self, ops: List[Op]):
        self.ops = sorted(ops, key=lambda o: o.start)
        self.starts = [o.start for o in self.ops]

    def find(self, t: int) -> Optional[Op]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.ops[i].start <= t <= self.ops[i].end:
            return self.ops[i]
        return None


class Trace:
    """The events of one trace, kept as plain records."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.host: List[Op] = []
        self.device: List[Op] = []
        for e in prof.profiler.kineto_results.events():
            op = Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id())
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    self.device.append(op)
            else:
                self.host.append(op)
        windows = [o for o in self.host if o.name == "portbench.window"]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} window spans, not 1")
        self.t0, self.t1 = windows[0].start, windows[0].end
        self.device = [o for o in self.device if o.end > self.t0 and o.start < self.t1]
        self.host = [o for o in self.host if o.end > self.t0 and o.start < self.t1]
        self.queries = Spans([o for o in self.host if o.name.startswith("portbench.query.")])
        self.kernel_spans = Spans([o for o in self.host if o.name.startswith("portbench.kernel.")])
        self.launch_at = {o.corr: o.start for o in self.host if o.name in LAUNCH_CALLS or
                          o.name.startswith(("cudaMemcpy", "cudaMemset"))}
        self.own = _function_pattern(device_functions())

    @property
    def window_ns(self) -> int:
        return self.t1 - self.t0

    def busy_ns(self, ops=None) -> int:
        ops = self.device if ops is None else ops
        return _union((max(o.start, self.t0), min(o.end, self.t1)) for o in ops)

    def own_function(self, op: Op) -> Optional[str]:
        m = self.own.search(op.name)
        return m.group(1) if m else None

    def launched_in(self, spans: Spans, prefix: str = "") -> List[Op]:
        """Device ops launched inside a span of `spans` whose name starts
        with `prefix`."""
        out = []
        for op in self.device:
            at = self.launch_at.get(op.corr)
            span = None if at is None else spans.find(at)
            if span is not None and span.name.startswith(prefix):
                out.append(op)
        return out

    def host_in(self, spans: Spans, names) -> int:
        return sum(1 for o in self.host if o.name in names and spans.find(o.start) is not None)

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, cur = [], self.t0
        for o in sorted(self.device, key=lambda o: o.start):
            if o.start > cur:
                gaps.append((cur, o.start))
            cur = max(cur, o.end)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        return gaps

    def buffer_request_ns(self) -> int:
        """Idle time in which the host was inside the profiler's own buffer
        requests."""
        reqs = [(o.start, o.end) for o in self.host if o.name == BUFFER_REQUEST]
        total = 0
        for gs, ge in self.idle_gaps():
            total += min(ge - gs, sum(max(0, min(ge, he) - max(gs, hs)) for hs, he in reqs))
        return total

    def launch_calls(self) -> int:
        return sum(1 for o in self.host if o.name in LAUNCH_CALLS)

    def kernel_ops(self) -> int:
        return sum(1 for o in self.device if not o.name.startswith(("Memcpy", "Memset")))

    def own_counts(self) -> Dict[str, int]:
        counts = {name: 0 for name in device_functions()}
        for op in self.device:
            f = self.own_function(op)
            if f is not None:
                counts[f] += 1
        return counts

    def breakdown(self, top: int = 10, gaps_read: int = 500) -> dict:
        """The device ops that took most time, and the idle time of the
        `gaps_read` longest idle gaps by the host op the host was in: the
        shortest op (not a span of the benchmark's) that covers at least half
        of a gap."""
        import numpy as np

        by_name: Dict[str, int] = {}
        for op in self.device:
            by_name[op.name] = by_name.get(op.name, 0) + op.end - op.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        host = [o for o in self.host if not o.name.startswith("portbench.")]
        starts = np.array([o.start for o in host], dtype=np.int64)
        ends = np.array([o.end for o in host], dtype=np.int64)
        idle: Dict[str, int] = {}
        for gs, ge in sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:gaps_read]:
            cover = np.minimum(ends, ge) - np.maximum(starts, gs)
            ok = np.nonzero(2 * cover >= ge - gs)[0]
            name = host[ok[np.argmin((ends - starts)[ok])]].name if ok.size else "host outside any op"
            idle[name] = idle.get(name, 0) + ge - gs
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops], "idle_gaps": [[n, ns / 1e9] for n, ns in gaps]}


def launch_deltas(before: Dict[str, Tuple[int, int]], after: Dict[str, Tuple[int, int]]) -> Dict[str, int]:
    """The launches each hand-written device function should show in the
    trace, from the launch counters' deltas (``kernels.json``)."""
    want = {}
    for func, counters in device_functions().items():
        if not counters:
            continue
        total = 0
        for kind, names in counters.items():
            idx = 0 if kind == "launches" else 1
            total += sum(after.get(n, (0, 0))[idx] - before.get(n, (0, 0))[idx] for n in names)
        want[func] = total
    return want
