"""Lazy compute pipeline: record ops, then run them in one ``finish()``.

Counterpart of ``arrow_tpu/runtime/pipeline.py``.  ``record`` appends a node
to an op graph and returns :class:`LazyArray` handles, whose dtype and
length are known at once (each op's ``out_meta``); ``finish()`` runs the
graph once on the pipeline's device and binds the handles.

As the JAX package compiles one program for each graph signature and caches
it, ``finish()`` takes the graph's plan from ``runtime.fusion.plan`` (cached
by signature: op names, params, dtypes, which operands are scalars, the
live handles): runs of fusible ops become fused groups, each one launch of a
CUDA kernel generated from the graph, whose dropped intermediates stay in
registers; the other ops run eagerly.  On the CPU, and on the card inside
``compute.kernels.plain_versions()``, a group replays its ops eagerly (its
plain version).  An intermediate is freed after its last reader when no
live handle holds it, and ``finish()`` makes no host synchronisation of its
own.

Usage:

    with ComputePipeline() as pipe:
        r1 = add_scalar_op(lhs, 3.0, pipe)
        r2 = mul_scalar_op(r1, 2.0, pipe)
    r2.values()
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Sequence

from .. import dtypes as dt
from .device import as_device


class LazyArray:
    """Handle for a not-yet-computed pipeline result.

    Before ``finish()`` it exposes its dtype and length; using it otherwise
    raises RuntimeError.  After, it delegates every attribute to
    the bound array."""

    def __init__(self, pipeline: "ComputePipeline", node_id: int, dtype: dt.ArrowType, length: int):
        self._pipeline = pipeline
        self._node_id = node_id
        self.dtype = dtype
        self._length = length
        self._bound = None

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    @property
    def is_bound(self) -> bool:
        return self._bound is not None

    def bound(self):
        if self._bound is None:
            raise RuntimeError(
                "LazyArray used before ComputePipeline.finish(); results are only "
                "available after the pipeline is submitted"
            )
        return self._bound

    def _bind(self, arr) -> None:
        self._bound = arr

    def __getattr__(self, name):
        # only called when normal lookup fails -> delegate to the bound array
        return getattr(self.bound(), name)

    def __repr__(self) -> str:
        if self._bound is not None:
            return repr(self._bound)
        return f"LazyArray(dtype={self.dtype.value}, len={self._length}, pending)"


@dataclasses.dataclass
class _Node:
    op: str
    # each input is ("node", slot id) or ("input", input index)
    inputs: tuple
    params: dict
    out_ids: tuple  # output slot ids
    out_meta: tuple  # ((dtype, length), ...) of the outputs


class ComputePipeline:
    """Records ops over arrays and handles; ``finish()`` runs the graph."""

    def __init__(self, device=None):
        self.device = as_device(device)
        self._nodes: list[_Node] = []
        self._inputs: list = []  # AVs of the graph's arrays and scalars
        self._input_ids: dict[int, tuple] = {}  # id(array) -> (input index, array)
        self._handles: list[tuple[int, weakref.ref]] = []  # (slot id, weak handle)
        self._next_slot = 0
        self._finished = False

    # -- recording -----------------------------------------------------------

    def _input_ref(self, arr) -> tuple:
        from ..array.array import ArrowArrayBase
        from ..ops.kernel import AV, array_av

        if isinstance(arr, LazyArray):
            if arr._pipeline is self and not arr.is_bound:
                return ("node", arr._node_id)
            arr = arr.bound()
        if isinstance(arr, ArrowArrayBase) and id(arr) in self._input_ids:
            return ("input", self._input_ids[id(arr)][0])
        if isinstance(arr, AV):  # scalar operand, on the host or the device
            av = arr
        elif isinstance(arr, ArrowArrayBase):
            got, want = arr.data.device, self.device.torch_device
            if got.type != want.type or want.index not in (None, got.index):
                raise ValueError(f"operand on {got}, pipeline on {want}")
            av = array_av(arr)
            # the array is held, so that its id is not reused while recorded
            self._input_ids[id(arr)] = (len(self._inputs), arr)
        else:
            raise TypeError(f"bad operand {type(arr)}")
        self._inputs.append(av)
        return ("input", len(self._inputs) - 1)

    def record(self, op_name: str, operands: Sequence[Any], params: dict):
        """Append an op; returns its LazyArray handle(s)."""
        from ..ops.kernel import AV, get_op

        if self._finished:
            raise RuntimeError("pipeline already finished")
        opdef = get_op(op_name)
        in_refs = tuple(self._input_ref(o) for o in operands)
        metas = [AV(None, None, o.length, o.dtype) for o in operands]
        out_meta = tuple(opdef.out_meta(metas, params))
        out_ids = tuple(range(self._next_slot, self._next_slot + len(out_meta)))
        self._next_slot += len(out_meta)
        self._nodes.append(_Node(op_name, in_refs, dict(params), out_ids, out_meta))
        handles = [
            LazyArray(self, oid, dtype, length) for oid, (dtype, length) in zip(out_ids, out_meta)
        ]
        self._handles.extend((h._node_id, weakref.ref(h)) for h in handles)
        return handles[0] if len(handles) == 1 else handles

    # -- submission ----------------------------------------------------------

    def _live(self) -> list:
        live = [(oid, ref()) for oid, ref in self._handles]
        return [(oid, h) for oid, h in live if h is not None]

    def signature(self) -> tuple:
        """The graph's signature: its nodes, each input's dtype, kind and
        length class (equal lengths share a class), and the slot ids that
        live handles hold."""
        from .fusion import SigNode

        classes: dict = {}
        inputs = []
        for av in self._inputs:
            if av.is_scalar:
                inputs.append((av.dtype, "host" if av.data.device.type == "cpu" else "device", -1))
            else:
                inputs.append((av.dtype, "array", classes.setdefault(av.length, len(classes))))
        nodes = tuple(
            SigNode(n.op, n.inputs, tuple(sorted(n.params.items())), n.out_ids,
                    tuple((d, classes.setdefault(length, len(classes))) for d, length in n.out_meta))
            for n in self._nodes)
        return nodes, tuple(inputs), tuple(sorted({oid for oid, _ in self._live()}))

    def plan(self):
        """The recorded graph's plan (``runtime.fusion.plan``)."""
        from .fusion import plan

        return plan(self.signature())

    def finish(self) -> None:
        """Run the recorded graph once and bind every live handle; a second
        call does nothing.  With ``config.profile`` set, the run's wall time
        to the end of its device work is logged as ``pipeline[<n> ops]``."""
        from ..array.array import make_array
        from ..config import config

        if self._finished:
            return
        self._finished = True
        live = self._live()
        env = {}
        if self._nodes:
            p = self.plan()
            keep = {oid for oid, _ in live}
            if config.profile:
                from . import profiler

                env = profiler.timed_call(f"pipeline[{len(self._nodes)} ops]", self._run, p, keep)
            else:
                env = self._run(p, keep)
        self._inputs.clear()
        self._input_ids.clear()
        for oid, handle in live:
            o = env[oid]
            handle._bind(make_array(o.data, o.validity, o.length, o.dtype, self.device))

    def _run(self, p, keep: set) -> dict:
        """Run the plan's steps; returns the values live handles hold."""
        from ..compute.kernels import using_plain
        from ..ops.kernel import execute
        from .fusion import Boundary, run_group_cuda, run_group_plain

        last_read = {}
        for k, step in enumerate(p.steps):
            for oid in step.reads:
                last_read[oid] = k
        env = {}

        def value(ref):
            return env[ref[1]] if ref[0] == "node" else self._inputs[ref[1]]

        fused = self.device.torch_device.type == "cuda" and not using_plain()
        for k, step in enumerate(p.steps):
            if isinstance(step, Boundary):
                node = self._nodes[step.node]
                produced = dict(zip(node.out_ids, execute(node.op, [value(r) for r in node.inputs], node.params)))
            elif fused:
                produced = run_group_cuda(p, step, value)
            else:
                produced = run_group_plain(self._nodes, step, value)
            for oid, out in produced.items():
                if oid in keep or last_read.get(oid, -1) > k:
                    env[oid] = out
            for oid in step.reads:
                if last_read[oid] == k and oid not in keep:
                    env.pop(oid, None)
        return env

    def __enter__(self) -> "ComputePipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.finish()
