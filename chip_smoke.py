#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (arrow_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing lines that start with its name:

1. device: the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build: compiles every kernel from arrow_tpu_torch/csrc with nvcc into
   build/arrow_tpu_torch/ and loads it; nvcc's per-kernel register report
   goes to build/arrow_tpu_torch/nvcc.log;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, over lengths, masks/flags, ops and dtypes (exact, except float adds:
   f32 at rtol 1e-6, f64 at rtol 1e-12, and an f32-accumulating stand-in
   for the f64 add must fail that check);
4. flagship: the flagship query (compare -> filter -> sort group-by) through
   the public API at 2^20 and 2^27 rows, checked against the same query on
   the plain versions and against a numpy oracle; the kernels' launch counts
   during the query; each kernel call the 2^27 query made, replayed on its
   own arguments against its plain version and timed beside it; per-step
   times for the kernel and plain paths;
5. profile: one query at each size under torch.profiler: device busy time,
   the device's idle share of the query's wall time, and the device ops that
   take the most time.

It then prints the nvidia-smi line, a JSON line with every kernel's launch
count in the full-size query, its largest error against its plain version,
and its kernel and plain times summed over that query's calls, and last the
line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero without that line; so does a machine
without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
FLAGSHIP_SIZES = (1 << 20, 1 << 27)
B1_SIZES = (0, 1, 31, 8193, (1 << 20) + 17, 1 << 27)
B1_PATTERNS = ("0", "0.01", "0.5", "0.99", "1", "every32")
B2_SIZES = (1, 8193, (1 << 20) + 17, 1 << 27)
B2_FLAGS = {"none": 0.0, "sparse": 0.001, "dense": 0.3}
# float adds differ from the plain ladder in summation order only
ADD_RTOL = {"float32": 1e-6, "float64": 1e-12}
REPS = 5
PROFILE_TOP = 8
# the device functions of the hand-written kernels (arrow_tpu_torch/csrc)
OWN_DEVICE_FUNCTIONS = ("tile_counts", "scan_tile_counts", "scatter_tiles",
                        "seg_tile_reduce", "seg_scan_tiles", "seg_tile_scan")


class PhaseFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    return out[0]


def _event_ms(fn) -> float:
    """CUDA-event time of one fn() call, synchronised."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn):
    """Median of REPS timed calls after one warm-up."""
    fn()
    return statistics.median(_event_ms(fn) for _ in range(REPS))


def interleaved_ms(kernel_fn, plain_fn):
    """Median times of two versions after a warm-up, timed in turns on one card."""
    kernel_fn(), plain_fn()
    pairs = [(_event_ms(kernel_fn), _event_ms(plain_fn)) for _ in range(REPS)]
    return statistics.median(k for k, _ in pairs), statistics.median(p for _, p in pairs)


@contextlib.contextmanager
def plain_path():
    from arrow_tpu_torch.compute.kernels import plain_versions

    with plain_versions():
        yield


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise PhaseFailed("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    line = smi_line()
    print(line)
    print(f"device: {torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}; CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    return line


def phase_build():
    from arrow_tpu_torch.compute.kernels import _build

    t0 = time.perf_counter()
    lib = _build.load()
    wall = time.perf_counter() - t0
    log_path = lib.path.parent / "nvcc.log"
    log_path.write_text(lib.log)
    # ptxas -v: "Used 24 registers, ..." and "0 bytes spill stores, 0 bytes spill loads"
    regs = [int(w.split()[0]) for w in lib.log.split("Used ")[1:] if w.split()[0].isdigit()]
    spilled = [
        ln for ln in lib.log.splitlines()
        if "spill stores" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln
    ]
    print(f"build: nvcc {lib.build_seconds:.1f} s (load {wall:.1f} s) -> {lib.path.name}; "
          f"{len(regs)} kernels, max {max(regs) if regs else 0} registers/thread; "
          f"{len(spilled)} with spills; log {log_path}")


def _rand_mask(n, pattern, gen, device):
    import torch

    if pattern == "every32":
        return torch.arange(n, device=device) % 32 == 0
    return torch.rand(n, generator=gen, device=device) < float(pattern)


def check_b1(device, gen):
    import torch

    from arrow_tpu_torch.compute.kernels import compaction3 as C3
    from arrow_tpu_torch.utils import bits as B

    worst = 0.0
    failures = []
    for n in B1_SIZES:
        planes = [
            torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, generator=gen, device=device),
            torch.randn(n, dtype=torch.float64, generator=gen, device=device),
        ]
        words = [B.pack_bits(torch.rand(n, generator=gen, device=device) < 0.5)]
        for pattern in B1_PATTERNS:
            mask = B.pack_bits(_rand_mask(n, pattern, gen, device))
            kv, kw, kc = C3.compact_multi(planes, words, mask, n)
            pv, pw, pc = C3.compact_multi_plain(planes, words, mask, n)
            torch.cuda.synchronize()
            ok = int(kc) == int(pc)
            for k, p in zip(kv + kw, pv + pw):
                ok &= bool(torch.equal(k, p))
                if n:
                    worst = max(worst, float((k.double() - p.double()).abs().max()))
            if not ok:
                failures.append(f"n={n} mask={pattern} count {int(kc)} vs {int(pc)}")
        del planes, words
    print(f"kernels: compact_multi vs plain: {len(B1_SIZES) * len(B1_PATTERNS)} cases "
          f"(n in {list(B1_SIZES)}, masks {list(B1_PATTERNS)}, 4- and 8-byte value planes + a "
          f"bitmap plane), exact incl. zero tail; max abs err {worst}; failures {failures}")
    require(not failures, "compact_multi disagrees with its plain version")
    return worst


def _b2_values(name, n, gen, device):
    import torch

    if name in ("float32", "float64"):  # positive: a well-conditioned sum
        return torch.rand(n, generator=gen, device=device, dtype=getattr(torch, name)) + 0.5, False
    dtype = torch.int32 if name.endswith("32") else torch.int64
    bits = 32 if dtype == torch.int32 else 64
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return torch.randint(lo, hi, (n,), dtype=dtype, generator=gen, device=device), name.startswith("u")


def check_b2(device, gen):
    import torch

    from arrow_tpu_torch.compute.kernels import segscan as S

    worst_abs, cases = 0.0, 0
    worst_rel = {"float32": 0.0, "float64": 0.0}
    standin_rel = float("inf")  # smallest error of the f32-accumulating stand-in
    failures = []
    for n in B2_SIZES:
        for name in ("int32", "uint32", "float32", "int64", "uint64", "float64"):
            vals, unsigned = _b2_values(name, n, gen, device)
            for fname, density in B2_FLAGS.items():
                flags = torch.rand(n, generator=gen, device=device) < density if density else None
                for op in S.OPS:
                    got = S.segmented_scan(vals, flags, op, unsigned)
                    want = S.segmented_scan_plain(vals, flags, op, unsigned)
                    torch.cuda.synchronize()
                    cases += 1
                    if vals.is_floating_point():
                        worst_abs = max(worst_abs, float((got.double() - want.double()).abs().max()))
                        rel = _max_rel(got, want)
                        worst_rel[name] = max(worst_rel[name], rel)
                        ok = (rel <= ADD_RTOL[name]) if op == "add" else bool(torch.equal(got, want))
                        if name == "float64" and op == "add":
                            # what a B2 that kept the group-by's f64 sum in f32 would give
                            standin = S.segmented_scan(vals.float(), flags, "add").double()
                            standin_rel = min(standin_rel, _max_rel(standin, want))
                    else:
                        ok = bool(torch.equal(got, want))
                    if not ok:
                        failures.append(f"n={n} {name} flags={fname} op={op}")
                    del got, want
            del vals
    print(f"kernels: segmented_scan vs plain: {cases} cases (n in {list(B2_SIZES)}, "
          f"ops {list(S.OPS)}, i32/u32/f32/i64/u64/f64, flags {list(B2_FLAGS)}); integers and "
          f"max/min/first exact, float add rtol {ADD_RTOL}; max abs err {worst_abs}; "
          f"failures {failures}")
    print(f"kernels: segmented_scan f32 add: max rel err {worst_rel['float32']} "
          f"(rtol {ADD_RTOL['float32']})")
    print(f"kernels: segmented_scan f64 add: max rel err {worst_rel['float64']} "
          f"(rtol {ADD_RTOL['float64']}); an f32-accumulating stand-in reads at least "
          f"{standin_rel} on the same cases, so the check rejects it")
    require(not failures, "segmented_scan disagrees with its plain version")
    require(standin_rel > ADD_RTOL["float64"], "the f64 add check would pass an f32 accumulator")
    return worst_abs


def _max_rel(got, want) -> float:
    diff = (got.double() - want.double()).abs()
    return float((diff / want.double().abs().clamp_min(1e-300)).max()) if diff.numel() else 0.0


def phase_kernels():
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    errs = {"compact_multi": check_b1(device, gen)}
    torch.cuda.empty_cache()
    errs["segmented_scan"] = check_b2(device, gen)
    torch.cuda.empty_cache()
    return errs


@contextlib.contextmanager
def recorded_calls():
    """Record the arguments of every kernel launch made inside the block."""
    from arrow_tpu_torch.compute.kernels import compaction3 as C3
    from arrow_tpu_torch.compute.kernels import segscan as S

    calls = {"compact_multi": [], "segmented_scan": []}
    saved = C3.compact_multi_cuda, S.segmented_scan_cuda

    def recording(name, fn):
        def call(*args):
            calls[name].append(args)
            return fn(*args)
        return call

    C3.compact_multi_cuda = recording("compact_multi", saved[0])
    S.segmented_scan_cuda = recording("segmented_scan", saved[1])
    try:
        yield calls
    finally:
        C3.compact_multi_cuda, S.segmented_scan_cuda = saved


def replay_calls(calls, smi):
    """Each kernel call of the query, on its own arguments, against its plain
    version (same tolerances as phase 3) and timed beside it.  Returns, per
    kernel, (max abs err, kernel ms, plain ms) summed over its calls."""
    import torch

    from arrow_tpu_torch.compute.kernels import compaction3 as C3
    from arrow_tpu_torch.compute.kernels import segscan as S

    out = {}
    for name, args_list in calls.items():
        kernel = C3.compact_multi_cuda if name == "compact_multi" else S.segmented_scan_cuda
        plain = C3.compact_multi_plain if name == "compact_multi" else S.segmented_scan_plain
        err, total_k, total_p = 0.0, 0.0, 0.0
        for i, args in enumerate(args_list):
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            if name == "compact_multi":
                vplanes, wplanes, mask, n = args
                got_t, want_t = got[0] + got[1], want[0] + want[1]
                ok = int(got[2]) == int(want[2]) and all(
                    bool(torch.equal(g, w)) for g, w in zip(got_t, want_t))
                what = (f"{len(vplanes)} value planes {[str(p.dtype)[6:] for p in vplanes]} + "
                        f"{len(wplanes)} bitmap planes, n={n}, kept {int(got[2])}")
            else:
                vals, flags, op, unsigned = args
                got_t, want_t = [got], [want]
                rtol = ADD_RTOL.get(str(vals.dtype)[6:]) if op == "add" else None
                ok = _max_rel(got, want) <= rtol if rtol else bool(torch.equal(got, want))
                segs = int(flags.sum()) if flags is not None else 0
                what = f"{op} of {str(vals.dtype)[6:]}, n={vals.shape[0]}, {segs} segment starts"
            for g, w in zip(got_t, want_t):
                if g.numel():
                    err = max(err, float((g.double() - w.double()).abs().max()))
            require(ok, f"{name} call {i + 1} of the query disagrees with its plain version")
            del got, want, got_t, want_t
            ms, plain_ms = interleaved_ms(lambda: kernel(*args), lambda: plain(*args))
            total_k, total_p = total_k + ms, total_p + plain_ms
            print(f"kernels: {name} call {i + 1} of the query ({what}): matches plain; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({smi})")
        out[name] = (err, total_k, total_p)
    return out


def _run_flagship(n, smi, replay):
    import numpy as np
    import torch

    from arrow_tpu_torch import flagship
    from arrow_tpu_torch.compute.kernels import _build

    host = flagship.make_host_columns(n, seed=0)
    batch = flagship.make_batch(n, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    with recorded_calls() as calls:
        _build.reset_launch_counts()
        rows, groups = flagship.flagship_query(batch)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in _build.KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"flagship n={n}: {rows} rows kept, {groups.num_rows} groups; launches during the "
          f"query {launches}; peak device memory {peak_gib:.2f} GiB")
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    for name in groups.column_names:
        require(groups[name].data.is_cuda, f"output column {name} is not on CUDA")

    with plain_path():
        plain_rows, plain = flagship.flagship_query(batch)
    require(rows == plain_rows, f"rows {rows} vs plain {plain_rows}")
    require(np.array_equal(groups["key"].raw_values(), plain["key"].raw_values()), "keys vs plain")
    require(np.array_equal(groups["n"].raw_values(), plain["n"].raw_values()), "counts vs plain")
    tk, tp = groups["total"].raw_values(), plain["total"].raw_values()
    rel_plain = float(np.max(np.abs(tk.astype(np.float64) - tp) / np.abs(tp))) if len(tp) else 0.0
    require(np.allclose(tk, tp, rtol=1e-6, atol=0), f"sums vs plain: max rel err {rel_plain}")

    count, keys, counts, sums = flagship.numpy_reference(host["k"], host["v"])
    require(rows == count, f"rows {rows} vs numpy {count}")
    require(np.array_equal(groups["key"].raw_values(), keys), "group keys vs numpy")
    require(np.array_equal(groups["n"].raw_values(), counts), "group counts vs numpy")
    rel_np = float(np.max(np.abs(tk.astype(np.float64) - sums) / np.abs(sums))) if len(sums) else 0.0
    require(np.allclose(tk, sums, rtol=1e-5, atol=0), f"sums vs numpy: max rel err {rel_np}")
    require(bool(np.isfinite(tk).all()), "non-finite sums")
    print(f"flagship n={n}: matches the plain path (keys, counts exact; sums max rel err "
          f"{rel_plain:.3g} <= 1e-6) and numpy (rows, keys, counts exact; sums max rel err "
          f"{rel_np:.3g} <= 1e-5)")

    measured = replay_calls(calls, smi) if replay else None
    del calls

    def plain_step(fn, *args):
        with plain_path():
            return fn(*args)

    steps = {}
    mask = flagship.compare_step(batch)
    steps["compare"] = (cuda_ms(lambda: flagship.compare_step(batch)),) * 2
    kept_k = flagship.filter_step(batch, mask)
    kept_p = plain_step(flagship.filter_step, batch, mask)
    steps["filter"] = interleaved_ms(
        lambda: flagship.filter_step(batch, mask),
        lambda: plain_step(flagship.filter_step, batch, mask),
    )
    steps["group-by"] = interleaved_ms(
        lambda: flagship.groupby_step(kept_k), lambda: plain_step(flagship.groupby_step, kept_p)
    )
    total_k = sum(v[0] for v in steps.values())
    total_p = sum(v[1] for v in steps.values())
    detail = "; ".join(f"{s} kernel {k:.3f} ms, plain {p:.3f} ms" for s, (k, p) in steps.items())
    print(f"flagship n={n} step times (CUDA events, median of {REPS} after a warm-up; {smi}): "
          f"{detail}; total kernel {total_k:.3f} ms, plain {total_p:.3f} ms")
    return launches, measured


def phase_flagship(smi):
    """The query at every size; the kernel calls of the full-size query are
    replayed and timed.  Returns that query's launches and replay numbers."""
    import torch

    for n in FLAGSHIP_SIZES:
        launches, measured = _run_flagship(n, smi, replay=n == FLAGSHIP_SIZES[-1])
        torch.cuda.empty_cache()
    return launches, measured


def phase_profile(smi):
    """One query per size under torch.profiler.  Device busy time is the union
    of the device's kernel, copy and set intervals inside the query's host
    interval (the query and a synchronize); the idle share is the rest of that
    interval.  The profiler's own host overhead lengthens the interval, so the
    idle share of a profiled query is an upper bound."""
    import torch
    from torch.autograd import DeviceType

    from arrow_tpu_torch import flagship

    for n in FLAGSHIP_SIZES:
        batch = flagship.make_batch(n, seed=0, device="cuda")
        flagship.flagship_query(batch)  # warm the allocator
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("flagship_query"):
                flagship.flagship_query(batch)
                torch.cuda.synchronize()
        events = prof.events()
        window = [e.time_range for e in events
                  if e.name == "flagship_query" and e.device_type == DeviceType.CPU]
        require(len(window) == 1, f"profile: {len(window)} query ranges in the trace")
        t0, t1 = window[0].start, window[0].end
        device = sorted(
            (max(e.time_range.start, t0), min(e.time_range.end, t1), e.name) for e in events
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.name != "flagship_query" and e.time_range.end > t0 and e.time_range.start < t1
        )
        if not device:
            print(f"profile n={n}: the profiler saw no device activity; device busy time and "
                  f"idle share not measured")
            continue
        busy, cur_s, cur_e = 0.0, None, None
        for s, e, _ in device:  # union of the intervals
            if cur_e is None or s > cur_e:
                busy += 0.0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        by_name = {}
        for s, e, name in device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
        own = sum(us for name, us in by_name.items()
                  if any(f"::{f}(" in name or f"::{f}<" in name for f in OWN_DEVICE_FUNCTIONS))
        wall = t1 - t0
        print(f"profile n={n} ({smi}): query interval {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall:.3f}; {len(device)} device ops; "
              f"the hand-written kernels {own / 1e3:.3f} ms of the busy time")
        for name, us in top:
            print(f"profile n={n}:   {us / 1e3:8.3f} ms  {name[:110]}")
        del batch
        torch.cuda.empty_cache()


def main() -> int:
    if not (HERE / "arrow_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: arrow_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    launches, measured = phase_flagship(smi)
    phase_profile(smi)

    from arrow_tpu_torch.compute.kernels import _build

    kernels = []
    for name, k in _build.KERNELS.items():
        replay_err, ms, plain_ms = measured[name]  # ms: summed over the query's calls
        kernels.append({
            "name": name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": launches[name], "max_abs_err": max(errs[name], replay_err),
            "ms": ms, "plain_ms": plain_ms,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
