"""Design probes on the card: the counterpart of ``tools/probe_r4.py``.

    python -m arrow_tpu_torch.tools.probe_r4                     # the card, 2^27 rows
    python -m arrow_tpu_torch.tools.probe_r4 --device cpu --rows 65536 --out ''  # minutes: R up to 4096

The JAX tool measured the numbers that chose the merge sort's designs; this
one measures the port's counterpart of each, step by step, and writes the
JAX tool's keys (``PROBE_R4.json``) with the device fields (``device``,
``gpu``: the card's nvidia-smi line) to ``--out`` (default
``TORCH_PROBE_R4.json`` at the root of the checkout; '' writes no file),
after every step, as the JAX tool does.  A step that raises records
``{"error": ...}`` and the run goes on.

1. ``sort_flat_134m_s``: ``torch.sort(stable=True)`` of n u32 keys in
   [0, 2^31) with a u32 payload gathered by its indices (the counterpart of
   ``lax.sort``, which was XLA's and not a Pallas kernel);
2. ``sort_batched_{8192..65536}_s``: the same along dimension 1 of runs of
   that length;
3. ``sum_xla_128m_s``: ``torch.sum`` (as y + (sum(y) & 1));
   ``sum_pallas_128m_s`` records an error: the JAX tool's Pallas sum lives in
   a module that the JAX package no longer has;
4. ``merge_pass_r3_134m_s``: one pass of kernel B7 (``merge_pass``) over
   sorted runs of 8192 key and payload rows;
5. ``mb_step_rollpair`` and ``mb_step_taa``: the merge step's compute
   (``csrc/probe_r4.cu``) in its two forms, timed as the JAX tool times it:
   the slope of a call's time between R = 256 and R = 4096 steps (``STEPS``),
   each call's time the mean of 3 after a warm-up, as ``us_per_step`` and
   ``grows_per_s_per_pass`` (Grows/s of one block, the JAX kernel's one
   core); on a card also with one block an SM (``card``);
6. ``i1_to_bf16_astype``: the mask matmul, ``{"ok": all 128}``;
7. ``ragged_all_to_all_tpu_1dev``: ``all_to_all_single`` on a one-rank group
   (NCCL on a card, gloo on the CPU) putting op[0:4] at output offset 2.

Times on a card are CUDA-event times (``utils.timing`` for steps 1-4); on
the CPU, the host clock over the plain versions.

The three kernels (the merge step in two forms and the mask matmul) are
registered in ``_build.KERNELS`` under the JAX tool's step names, with their
plain PyTorch versions beside them, in ``mosaic_probe``'s ``Probe`` table
form: ``mosaic_probe.run`` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (the merge steps with a block count).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..compute.kernels import _build
from ..compute.kernels import merge as M
from ..parallel.dryrun import device_name
from ..utils.timing import device_seconds_per_iter
from . import common
from . import mosaic_probe as MP
from .mosaic_probe import Probe

SOURCE = "arrow_tpu_torch/csrc/probe_r4.cu"
JAX_TOOL = "tools/probe_r4.py"
N = 1 << 27
LANES = 128
T, TR = 4096, 32  # rows a merge-step window, and its rows of 128
BUF = 2 * T  # rows of each merge-step input
RUN = 8192  # the merge pass's run length
BATCHED = (8192, 16384, 32768, 65536)
STEPS = (256, 4096)  # the merge step's R pair
STEP_CALLS = 3
SUM_PALLAS_ERROR = ("ModuleNotFoundError: No module named 'arrow_tpu.compute.kernels.reduction' "
                    "(tools/probe_r4.py:88 imports it; the JAX package no longer has it)")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as their int32 bits (two's-complement wrap)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def merge_step_rows(r: torch.Tensor, a: torch.Tensor, b: torch.Tensor, xor: bool):
    """The plain merge step's rows (k, t, v) after each of its r[0] steps'
    clean, over the flat 4096 rows (``csrc/probe_r4.cu`` says what a step
    computes)."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    i = torch.arange(T, device=a.device)
    h = 0
    for _ in range(int(r[0])):
        wa = fa[(i + h) % BUF]
        rb = fb[(T - 1 - i + h + 7) % BUF]
        less = wa <= rb
        k = torch.where(less, wa, rb)
        t = torch.where(less, i, 2 * T - 1 - i)
        v = torch.where(less, wa ^ 3, rb ^ 5)
        d = T // 2
        while d:
            p, upper = i ^ d, (i & d) != 0
            pk, pt, pv = k[p], t[p], v[p]
            if xor and d < LANES:  # take the partner where (k, t) < its, negated on the upper row
                take = ((k < pk) | ((k == pk) & (t < pt))) != upper
            else:  # keep where the pair's lower row is (k, t) <= its upper
                lk, lt = torch.where(upper, pk, k), torch.where(upper, pt, t)
                hk, ht = torch.where(upper, k, pk), torch.where(upper, t, pt)
                take = ~((lk < hk) | ((lk == hk) & (lt <= ht)))
            k, t, v = torch.where(take, pk, k), torch.where(take, pt, t), torch.where(take, pv, v)
            d //= 2
        yield k, t, v
        h = (h + 1789) % BUF


def merge_step_plain(r: torch.Tensor, a: torch.Tensor, b: torch.Tensor, xor: bool) -> torch.Tensor:
    """Plain PyTorch merge step, r[0] steps: k + v summed over the steps,
    wrapping in int32."""
    acc = torch.zeros(T, dtype=torch.int64, device=a.device)
    for k, _, v in merge_step_rows(r, a, b, xor):
        acc += k.long() + v.long()
    return _wrap32(acc).reshape(TR, LANES)


def mask_matmul_plain(x: torch.Tensor) -> torch.Tensor:
    """(x > 0) as bf16 @ ones(128, 128) bf16, summed in float32 (exact: at
    most 128 ones) as a broadcast product, rounded to bf16."""
    mask = (x > 0).float()
    ones = torch.ones(x.shape[1], LANES, dtype=torch.float32, device=x.device)
    return (mask[:, :, None] * ones[None]).sum(1).to(torch.bfloat16)


def _step_inputs():
    a0 = np.arange(BUF, dtype=np.int32).reshape(-1, LANES)
    return np.full((1,), 3, np.int32), a0, a0.copy()


# The integer operations of one merge step, counted from the plain version's
# window and stages with (k, t) as two 32-bit words and v rebuilt from them:
# the window 3 a row (compare, select k, select t), each of the 12 stages 6
# a pair of rows (a two-word compare, min and max as 4 selects), the sum 3 a
# row (select 3 or 5, xor, a three-input add): 4096 x (3 + 12 x 3 + 3) =
# 172 032.
STEP_OPS = T * (3 + 12 * 3 + 3)
# One SM's 32-bit integer rate: 64 lanes a clock at 1.98 GHz, the clock at
# which the data sheet's 67 TFLOP/s float32 (132 SMs x 128 lanes x 2) holds.
SM_INT32_OPS_PER_S = 64 * 1.98e9
STEP_R = int(_step_inputs()[0][0])  # the probe's R


def sm_floor_line() -> str:
    """One SM's floor for a merge step: its operations over one SM's rate."""
    return (f"one SM's floor {STEP_OPS / SM_INT32_OPS_PER_S * 1e6:.3f} us a step ({STEP_OPS} integer "
            f"operations at 64 lanes x 1.98 GHz)")


KERNELS = [
    Probe("mb_step_rollpair", 177, _step_inputs, lambda r, a, b: merge_step_plain(r, a, b, False), None,
          (TR, LANES), torch.int32, ops=STEP_R * STEP_OPS, blocked=True),
    Probe("mb_step_taa", 177, _step_inputs, lambda r, a, b: merge_step_plain(r, a, b, True), None,
          (TR, LANES), torch.int32, ops=STEP_R * STEP_OPS, blocked=True),
    Probe("i1_to_bf16_astype", 209, lambda: (np.ones((LANES, LANES), np.int32),), mask_matmul_plain,
          lambda x: np.full((LANES, LANES), 128.0, np.float32), (LANES, LANES), torch.bfloat16,
          ops=2 * LANES ** 3),
]
BY_NAME = {p.label: p for p in KERNELS}
MERGE_STEPS = ("mb_step_rollpair", "mb_step_taa")

for _p in KERNELS:
    _build.register_kernel(_build.Kernel(name=_p.label, source=SOURCE,
                                         replaces=f"{JAX_TOOL}:{_p.site} ({_p.label})"))


# ---------------------------------------------------------------------------
# the steps


def _draw(seed: int, n: int, high: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, high, (n,), generator=gen, dtype=torch.int32, device=device)


def _sorted_with_payload(k: torch.Tensor, v: torch.Tensor, run_len: Optional[int] = None):
    if run_len is None:
        s = torch.sort(k, stable=True)
        return s.values, v[s.indices]
    s = torch.sort(k.view(-1, run_len), dim=1, stable=True)
    return s.values.reshape(-1), torch.gather(v.view(-1, run_len), 1, s.indices).reshape(-1)


def _seconds(fn: Callable[[], object], device: torch.device, calls: int) -> float:
    """Seconds a call of fn after a warm-up, the mean of `calls` back to
    back (CUDA events on a card, the host clock on the CPU)."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) / calls
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def us_per_step(call: Callable[[torch.Tensor], object], device: torch.device, steps: Sequence[int]) -> float:
    """us a step of call(r) from the slope of its time between R = steps[0]
    and R = steps[1] (r the device scalar R)."""

    def call_seconds(r_steps):
        r = torch.full((1,), r_steps, dtype=torch.int32, device=device)
        return _seconds(lambda: call(r), device, STEP_CALLS)

    lo, hi = steps
    return (call_seconds(hi) - call_seconds(lo)) / (hi - lo) * 1e6


def step_rate(probe: Probe, device: torch.device, steps: Sequence[int], blocks: int = 1) -> Dict[str, float]:
    """us_per_step and grows_per_s_per_pass of the merge step (all `blocks`
    blocks together) from the slope between steps[0] and steps[1]."""
    a0 = torch.from_numpy(_step_inputs()[1]).to(device)
    if device.type == "cuda":
        us = us_per_step(lambda r: MP.launch(probe, r, a0, a0, blocks=blocks), device, steps)
    else:
        us = us_per_step(lambda r: MP.plain(probe, r, a0, a0), device, steps)
    return {"us_per_step": us, "grows_per_s_per_pass": blocks * T / us / 1e3}


def merge_step_report(probe: Probe, device: torch.device, steps: Sequence[int]) -> dict:
    """One block's rate (the JAX kernel's one core) and, on a card, the
    card's with one block an SM."""
    out = dict(step_rate(probe, device, steps), blocks=1)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        out["card"] = dict(step_rate(probe, device, steps, sms), blocks=sms)
    return out


def ragged_probe(device: torch.device) -> dict:
    """op[0:4] to output offset 2 by all_to_all_single on a one-rank group."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    with common.one_rank_group(backend, device):
        op = torch.arange(16, dtype=torch.int32, device=device)
        outb = torch.zeros(16, dtype=torch.int32, device=device)
        i_off, s_sz, o_off, r_sz = 0, 4, 2, 4
        dist.all_to_all_single(outb[o_off:o_off + r_sz], op[i_off:i_off + s_sz], [r_sz], [s_sz])
        return {"ok": True, "out_head": outb[:8].tolist(), "backend": backend}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=N, help="rows of steps 1-4 (a multiple of 65536)")
    ap.add_argument("--device", default=None, help="the device (default: cuda:0 when there is one)")
    ap.add_argument("--out", default=str(common.ROOT / "TORCH_PROBE_R4.json"), help="the report ('' for none)")
    args = ap.parse_args(argv)
    n = args.rows
    if n < BATCHED[-1] or n % BATCHED[-1]:
        ap.error(f"--rows {n} is not a positive multiple of {BATCHED[-1]}")
    device = torch.device(device_name(args.device))
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    out: dict = {}
    fields = {"device": str(device), "gpu": common.gpu_line() if device.type == "cuda" else None}

    def save():
        if args.out:
            with open(args.out, "w") as f:
                json.dump({**out, **fields}, f, indent=2)

    def step(name, fn):
        t0 = time.time()
        try:
            out[name] = fn()
            print(f"[OK] {name}: {out[name]} ({time.time() - t0:.0f}s)", flush=True)
        except Exception as e:  # noqa: BLE001  (a failed step is recorded, as in the JAX tool)
            out[name] = {"error": f"{type(e).__name__}: {e}"[:500]}
            print(f"[FAIL] {name}: {e}", flush=True)
        save()

    keys = _draw(0, n, 1 << 31, device)
    vals = _draw(1, n, 1 << 31, device)

    step("sort_flat_134m_s", lambda: device_seconds_per_iter(_sorted_with_payload, (keys, vals), k_lo=2, k_hi=5))
    for L in BATCHED:
        step(f"sort_batched_{L}_s", lambda L=L: device_seconds_per_iter(
            lambda k, v: _sorted_with_payload(k, v, L), (keys, vals), k_lo=2, k_hi=6))

    su = _draw(2, n, 1000, device)
    step("sum_xla_128m_s", lambda: device_seconds_per_iter(
        lambda y: y + (y.sum(dtype=torch.int32) & 1), (su,), k_lo=3, k_hi=13))
    del su
    out["sum_pallas_128m_s"] = {"error": SUM_PALLAS_ERROR}
    print(f"[FAIL] sum_pallas_128m_s: {SUM_PALLAS_ERROR}", flush=True)

    ks = _sorted_with_payload(keys, keys, RUN)[0]
    step("merge_pass_r3_134m_s", lambda: device_seconds_per_iter(
        lambda a, b: M.merge_pass((a, b), RUN), (ks, vals), k_lo=2, k_hi=5))
    del keys, vals, ks

    for name in MERGE_STEPS:
        step(name, lambda name=name: merge_step_report(BY_NAME[name], device, STEPS))

    def conv_probe():
        o = MP.run(BY_NAME["i1_to_bf16_astype"], torch.ones((LANES, LANES), dtype=torch.int32, device=device))
        return {"ok": bool((o.float() == 128).all())}

    step("i1_to_bf16_astype", conv_probe)
    step("ragged_all_to_all_tpu_1dev", lambda: ragged_probe(device))
    save()
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
