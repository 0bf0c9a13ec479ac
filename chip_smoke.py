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
   card, over lengths, masks/flags, ops, dtypes, digit widths, key domains
   and run lengths (exact, except float adds: f32 at rtol 1e-6, f64 at rtol
   1e-12, and an f32-accumulating stand-in for the f64 add must fail that
   check);
4. flagship: the flagship query (compare -> filter -> sort group-by) through
   the public API at 2^20 and 2^27 rows, checked against the same query on
   the plain versions and against a numpy oracle; the kernels' launch counts
   during the query; per-step times for the kernel and plain paths;
5. sort_join: the sort-join query (the flagship's filter and group-by, the
   groups joined back onto the kept rows, the kept rows sorted by key) at
   2^27 rows, checked against the plain path and a numpy oracle; the launch
   counts and peak device memory during the query (every kernel but the
   2-bit radix must launch); each kernel call of a second run of the query,
   replayed on its own arguments against its plain version and timed beside
   it; the sort rerun with
   ARROW_TPU_RADIX_R=4 (the 2-bit radix, whose launches and calls are read
   there) and with ARROW_TPU_SORT=xla; per-step times for both paths and the
   sort's crossover, radix against torch.sort, at 2^24, 2^26 and 2^27;
6. profile: each query at each size under torch.profiler: device busy time,
   the device's idle share of the query's wall time, and the device ops that
   take the most time.

It then prints the nvidia-smi line, a JSON line with every kernel's launch
count in the sort-join query (the 2-bit radix: in its rerun), its largest
error against its plain version, and its kernel and plain times summed over
that run's calls, and last the line
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
B3_SIZES = (0, 1, 31, 8193, (1 << 20) + 17, 1 << 27)
B3_WIDTHS = (1, 2, 8)
B3_KEYS = ("int32", "uint32", "float32", "uint64", "int64")
B3_DOMAINS = (2, 10_000, 1 << 32)
B7_SIZES = (1, 31, 8193, (1 << 20) + 17, 1 << 27)
B7_RUNS = (1, 7, 8192, "half")
SORT_JOIN_N = 1 << 27
CROSSOVER_SIZES = (1 << 24, 1 << 26, 1 << 27)
# float adds differ from the plain ladder in summation order only
ADD_RTOL = {"float32": 1e-6, "float64": 1e-12}
REPS = 5
PROFILE_TOP = 8
# the device functions of the hand-written kernels (arrow_tpu_torch/csrc)
OWN_DEVICE_FUNCTIONS = ("tile_counts", "scan_tile_counts", "scatter_tiles",
                        "seg_tile_reduce", "seg_scan_tiles", "seg_tile_scan",
                        "radix_histogram", "radix_scan_rows", "radix_scatter", "radix_or_and",
                        "merge_runs")


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


def _b3_keys(name, n, domain, gen, device):
    """Keys of Arrow type `name` drawn below `domain` (signed types around 0;
    64-bit keys with the draw in both halves; floats with +-0, +-NaN and
    +-inf mixed in) and their sort code, the plane B3 sorts by."""
    import torch

    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.compute.sort import key_code
    from arrow_tpu_torch.utils import bits as B

    def draw():
        v = torch.randint(0, domain, (n,), generator=gen, device=device, dtype=torch.int64)
        return v - domain // 2 if name.startswith(("int", "float")) else v

    if name in ("uint64", "int64"):
        data = (draw() << 32) + draw()
    elif name == "float32":
        data = draw().float()
        specials = torch.tensor([0, -(2**31), 0x7FC00000, -4194304, 0x7F800000, -8388608],
                                dtype=torch.int32, device=device).view(torch.float32)
        pick = torch.randint(0, 6, (n,), generator=gen, device=device)
        data = torch.where(torch.rand(n, generator=gen, device=device) < 0.05, specials[pick], data)
    else:
        data = B.to_int32(draw() & 0xFFFFFFFF)
    return key_code(data, dt.ArrowType(name))


def _b3_payloads(count, n, gen, device):
    import torch

    makers = (
        lambda: torch.arange(n, dtype=torch.int32, device=device),  # the stability witness
        lambda: torch.randn(n, dtype=torch.float64, generator=gen, device=device),
        lambda: torch.randint(-(2**62), 2**62, (n,), generator=gen, device=device),
        lambda: torch.randn(n, generator=gen, device=device),
    )
    return [make() for make in makers[:count]]


def check_b3(device, gen):
    """B3 at digit widths 1, 2 and 8 (2 is B4) against its plain version."""
    import torch

    from arrow_tpu_torch.compute.kernels import radix as R

    worst, cases, failures = 0.0, 0, []
    for n in B3_SIZES:
        full = n == B3_SIZES[-1]
        for wi, width in enumerate(B3_WIDTHS):
            for ki, key in enumerate(B3_KEYS):
                # at full size one domain per (width, key), in turn
                domains = [B3_DOMAINS[(wi + ki) % 3]] if full else B3_DOMAINS
                for domain in domains:
                    cases += 1
                    code = _b3_keys(key, n, domain, gen, device)
                    planes = [code, *_b3_payloads(1 + cases % (2 if full else 4), n, gen, device)]
                    got = R.radix_sort(planes, 8 * code.element_size(), n, width)
                    want = R.radix_sort_plain(planes, 8 * code.element_size(), n, width)
                    torch.cuda.synchronize()
                    ok = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
                    if n:
                        worst = max(worst, max(float((g.double() - w.double()).abs().max())
                                               for g, w in zip(got, want)))
                    if not ok:
                        failures.append(f"n={n} width={width} {key} domain={domain}")
                    del planes, got, want
        torch.cuda.empty_cache()
    print(f"kernels: radix_sort vs plain: {cases} cases (n in {list(B3_SIZES)}, digit widths "
          f"{list(B3_WIDTHS)} (2 is radix_sort_2bit), keys {list(B3_KEYS)} as sort codes, "
          f"key domains {list(B3_DOMAINS)}, 1-4 payload planes of 4 and 8 bytes), exact incl. "
          f"zero tail; max abs err {worst}; failures {failures}")
    require(not failures, "radix_sort disagrees with its plain version")
    return worst


def _b7_runs(n, run_len, unique, payloads, gen, device):
    """int32 planes holding sorted runs of `run_len` rows: heavy duplicates,
    the int32 extremes and the merge sentinel as keys, row ids as the first
    payload (the unique one in unique mode), random payloads after it."""
    import torch

    pool = torch.tensor([-(2**31), -1, 0, 3, 2**31 - 2, 2**31 - 1], dtype=torch.int32, device=device)
    keys = pool[torch.randint(0, 6, (n,), generator=gen, device=device)]
    rows = torch.arange(n, dtype=torch.int32, device=device)
    full = n - n % run_len
    parts_k, parts_r = [], []
    for lo, hi, width in ((0, full, run_len), (full, n, n - full)):
        if hi > lo:
            k = keys[lo:hi].view(-1, width)
            order = torch.sort(k, dim=1, stable=True).indices
            parts_k.append(torch.gather(k, 1, order).reshape(-1))
            parts_r.append(torch.gather(rows[lo:hi].view(-1, width), 1, order).reshape(-1))
    extra = [torch.randint(-(2**31), 2**31, (n,), generator=gen, device=device, dtype=torch.int64)
             .to(torch.int32) for _ in range(0 if unique else payloads - 1)]
    return [torch.cat(parts_k), torch.cat(parts_r), *extra]


def check_b7(device, gen):
    """B7 over run lengths, ragged last runs and byes, both modes."""
    import torch

    from arrow_tpu_torch.compute.kernels import merge as M

    worst, cases, failures = 0.0, 0, []
    for n in B7_SIZES:
        for run in B7_RUNS:
            run_len = max(1, n // 2) if run == "half" else run
            if n == B7_SIZES[-1] and run_len < 8192:
                continue  # runs of 1 and 7 rows are checked up to 2^20 rows
            for unique in (False, True):
                cases += 1
                planes = _b7_runs(n, run_len, unique, 1 + cases % 3, gen, device)
                got = M.merge_pass(planes, run_len, unique)
                want = M.merge_pass_plain(planes, run_len, unique)
                torch.cuda.synchronize()
                ok = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
                worst = max(worst, max(float((g.double() - w.double()).abs().max())
                                       for g, w in zip(got, want)))
                if not ok:
                    failures.append(f"n={n} run_len={run_len} unique={unique}")
                del planes, got, want
        torch.cuda.empty_cache()
    print(f"kernels: merge_pass vs plain: {cases} cases (n in {list(B7_SIZES)}, run_len in "
          f"{list(B7_RUNS)} (1 and 7 up to 2^20+17 rows), ragged last runs and byes, keys of "
          f"INT32_MIN/-1/0/3/INT32_MAX-1/INT32_MAX (the sentinel), 1-3 payload planes, "
          f"unique-payload mode), exact; max abs err {worst}; failures {failures}")
    require(not failures, "merge_pass disagrees with its plain version")
    return worst


def phase_kernels():
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    errs = {"compact_multi": check_b1(device, gen)}
    torch.cuda.empty_cache()
    errs["segmented_scan"] = check_b2(device, gen)
    torch.cuda.empty_cache()
    errs["radix_sort"] = errs["radix_sort_2bit"] = check_b3(device, gen)
    errs["merge_pass"] = check_b7(device, gen)
    torch.cuda.empty_cache()
    return errs


# kernel name -> (module, name of the CUDA launcher, name of the plain version)
KERNEL_FUNCTIONS = {
    "compact_multi": ("compaction3", "compact_multi_cuda", "compact_multi_plain"),
    "segmented_scan": ("segscan", "segmented_scan_cuda", "segmented_scan_plain"),
    "radix_sort": ("radix", "radix_sort_cuda", "radix_sort_plain"),
    "merge_pass": ("merge", "merge_pass_cuda", "merge_pass_plain"),
}


def _kernel_module(name):
    import importlib

    return importlib.import_module(f"arrow_tpu_torch.compute.kernels.{KERNEL_FUNCTIONS[name][0]}")


@contextlib.contextmanager
def recorded_calls():
    """Record the arguments of every kernel launch made inside the block,
    by kernel (a 2-bit radix sort under radix_sort_2bit)."""
    calls = {name: [] for name in ("compact_multi", "segmented_scan", "radix_sort",
                                   "radix_sort_2bit", "merge_pass")}
    saved = {}

    def recording(name, fn):
        def call(*args):
            key = "radix_sort_2bit" if name == "radix_sort" and args[3] == 2 else name
            calls[key].append(args)
            return fn(*args)
        return call

    for name, (_, launcher, _) in KERNEL_FUNCTIONS.items():
        mod = _kernel_module(name)
        saved[name] = getattr(mod, launcher)
        setattr(mod, launcher, recording(name, saved[name]))
    try:
        yield calls
    finally:
        for name, (_, launcher, _) in KERNEL_FUNCTIONS.items():
            setattr(_kernel_module(name), launcher, saved[name])


def _describe(name, args, got, want):
    """(matches, outputs to measure the error on, a description of the call)."""
    import torch

    def dtypes(ts):
        return [str(t.dtype)[6:] for t in ts]

    if name == "compact_multi":
        vplanes, wplanes, mask, n = args
        got_t, want_t = got[0] + got[1], want[0] + want[1]
        ok = int(got[2]) == int(want[2]) and all(bool(torch.equal(g, w)) for g, w in zip(got_t, want_t))
        return ok, got_t, want_t, (f"{len(vplanes)} value planes {dtypes(vplanes)} + {len(wplanes)} "
                                   f"bitmap planes, n={n}, kept {int(got[2])}")
    if name == "segmented_scan":
        vals, flags, op, unsigned = args
        rtol = ADD_RTOL.get(str(vals.dtype)[6:]) if op == "add" else None
        ok = _max_rel(got, want) <= rtol if rtol else bool(torch.equal(got, want))
        segs = int(flags.sum()) if flags is not None else 0
        return ok, [got], [want], f"{op} of {str(vals.dtype)[6:]}, n={vals.shape[0]}, {segs} segment starts"
    ok = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    if name.startswith("radix_sort"):
        planes, bits, n, width = args
        n = planes[0].shape[0] if n is None else n
        return ok, got, want, f"{len(planes)} planes {dtypes(planes)}, n={n}, {width}-bit digits"
    planes, run_len, unique = args
    return ok, got, want, (f"{len(planes)} int32 planes, n={planes[0].shape[0]}, run_len={run_len}"
                           f"{', unique payload' if unique else ''}")


def replay_calls(calls, smi):
    """Each recorded kernel call, on its own arguments, against its plain
    version (same tolerances as phase 3) and timed beside it.  Returns, per
    kernel, (max abs err, kernel ms, plain ms) summed over its calls."""
    import torch

    out = {}
    for name, args_list in calls.items():
        mod = _kernel_module("radix_sort" if name == "radix_sort_2bit" else name)
        _, launcher, plain_name = KERNEL_FUNCTIONS["radix_sort" if name == "radix_sort_2bit" else name]
        kernel, plain = getattr(mod, launcher), getattr(mod, plain_name)
        err, total_k, total_p = 0.0, 0.0, 0.0
        for i, args in enumerate(args_list):
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            ok, got_t, want_t, what = _describe(name, args, got, want)
            for g, w in zip(got_t, want_t):
                if g.numel():
                    err = max(err, float((g.double() - w.double()).abs().max()))
            require(ok, f"{name} call {i + 1} ({what}) disagrees with its plain version")
            del got, want, got_t, want_t
            ms, plain_ms = interleaved_ms(lambda: kernel(*args), lambda: plain(*args))
            total_k, total_p = total_k + ms, total_p + plain_ms
            print(f"sort_join: {name} call {i + 1} ({what}): matches plain; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({smi})")
        out[name] = (err, total_k, total_p)
    return out


def plain_step(fn, *args):
    with plain_path():
        return fn(*args)


def _run_flagship(n, smi):
    import numpy as np
    import torch

    from arrow_tpu_torch import flagship
    from arrow_tpu_torch.compute.kernels import _build

    host = flagship.make_host_columns(n, seed=0)
    batch = flagship.make_batch(n, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launch_counts()
    rows, groups = flagship.flagship_query(batch)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"flagship n={n}: {rows} rows kept, {groups.num_rows} groups; launches during the "
          f"query {launches}; peak device memory {peak_gib:.2f} GiB")
    require(launches["compact_multi"] > 0 and launches["segmented_scan"] > 0,
            f"a kernel of the query was not launched: {launches}")
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


def phase_flagship(smi):
    """The query at every size."""
    import torch

    for n in FLAGSHIP_SIZES:
        _run_flagship(n, smi)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block (the JAX package's switches)."""
    import os

    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sort_join_oracle(host):
    """numpy: the kept rows, their stable order by key, and the groups."""
    import numpy as np

    from arrow_tpu_torch import flagship

    keep = host["v"] > 0
    k, v = host["k"][keep], host["v"][keep]
    require(int(k.max()) < 1 << 16, "keys must fit 16 bits for numpy's stable radix argsort")
    order = np.argsort(k.astype(np.uint16), kind="stable")
    _, keys, counts, sums = flagship.numpy_reference(host["k"], host["v"])
    return k, v, order, keys, counts, sums


def _packed_rows(k, v):
    """(key << 32 | value bits) of each row, sorted: the rows as a multiset."""
    import torch

    return torch.sort((k.to(torch.int64) << 32) | (v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)).values


def check_sorted(label, sk, sv, oracle):
    import numpy as np

    k, v, order = oracle[:3]
    require(sk.length == sv.length == len(k), f"{label}: sorted length {sk.length} vs {len(k)}")
    require(np.array_equal(sk.raw_values(), k[order]), f"{label}: sorted keys vs numpy's stable sort")
    require(np.array_equal(sv.raw_values().view(np.uint32), v[order].view(np.uint32)),
            f"{label}: the payload does not follow numpy's stable argsort")


def check_sort_join(label, out, oracle, want_rows):
    """The query's result against the numpy oracle: the kept rows, the
    groups, every joined pair (probe key = build key, each kept row once, the
    group's total and count) and the sort."""
    import numpy as np
    import torch

    kept, groups, joined, (sk, sv) = out
    k, v, order, keys, counts, sums = oracle
    t = len(k)
    require(kept.num_rows == t, f"{label}: {kept.num_rows} kept rows vs numpy {t}")
    require(np.array_equal(groups["key"].raw_values(), keys), f"{label}: group keys vs numpy")
    require(np.array_equal(groups["n"].raw_values(), counts), f"{label}: group counts vs numpy")
    require(np.allclose(groups["total"].raw_values(), sums, rtol=1e-5, atol=0), f"{label}: sums vs numpy")
    require(joined.num_rows == t, f"{label}: {joined.num_rows} joined rows vs {t} kept rows")
    jk, jkey = joined["k"].data[:t], joined["key"].data[:t]
    require(bool(torch.equal(jk, jkey)), f"{label}: a pair's probe key differs from its build key")
    require(bool(torch.equal(_packed_rows(jk, joined["v"].data[:t]), want_rows)),
            f"{label}: the joined rows are not each kept row exactly once")
    device = jk.device
    lut_n = torch.zeros(1 << 16, dtype=torch.int64, device=device)
    lut_n[torch.from_numpy(keys.astype(np.int64)).to(device)] = torch.from_numpy(counts).to(device)
    lut_total = torch.zeros(1 << 16, dtype=torch.float32, device=device)
    ng = groups.num_rows
    lut_total[groups["key"].data[:ng].to(torch.int64)] = groups["total"].data[:ng]
    bkey = jkey.to(torch.int64)
    require(bool(torch.equal(joined["n"].data[:t], lut_n[bkey])), f"{label}: joined n vs the group count")
    require(bool(torch.equal(joined["total"].data[:t], lut_total[bkey])),
            f"{label}: joined total vs its group's total")
    check_sorted(label, sk, sv, oracle)


def phase_sort_join(smi):
    """The sort-join query at full size.  Returns (launches by kernel, replay
    numbers by kernel); the 2-bit radix's come from its rerun of the sort."""
    import numpy as np
    import torch

    from arrow_tpu_torch import compute as C
    from arrow_tpu_torch import flagship
    from arrow_tpu_torch.compute.kernels import _build

    n = SORT_JOIN_N
    host = flagship.make_host_columns(n, seed=0)
    oracle = _sort_join_oracle(host)
    device = torch.device("cuda")
    want_rows = _packed_rows(torch.from_numpy(oracle[0].view(np.int32)).to(device),
                             torch.from_numpy(oracle[1]).to(device))
    batch = flagship.make_batch(n, seed=0, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = flagship.sort_join_query(batch)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kept, groups, joined, (sk, sv) = out
    print(f"sort_join n={n}: {kept.num_rows} rows kept, {groups.num_rows} groups, "
          f"{joined.num_rows} joined rows; launches during the query {launches}; peak device "
          f"memory {peak_gib:.2f} GiB")
    for name in ("compact_multi", "segmented_scan", "radix_sort", "merge_pass"):
        require(launches[name] > 0, f"{name} was not launched by the sort-join query: {launches}")
    check_sort_join("sort_join", out, oracle, want_rows)
    with plain_path():
        plain = flagship.sort_join_query(batch)
    check_sort_join("sort_join plain path", plain, oracle, want_rows)
    require(bool(torch.equal(sk.data, plain[3][0].data) and torch.equal(sv.data, plain[3][1].data)),
            "sorted keys or values differ from the plain path")
    rel_plain = float(np.max(np.abs(groups["total"].raw_values().astype(np.float64)
                                    - plain[1]["total"].raw_values()) / np.abs(plain[1]["total"].raw_values())))
    require(rel_plain <= 1e-6, f"group sums vs the plain path: max rel err {rel_plain}")
    del plain
    print(f"sort_join n={n}: matches the plain path (kept rows, groups, joined rows as a set, "
          f"sorted keys and values exact; group sums max rel err {rel_plain:.3g} <= 1e-6) and numpy "
          f"(kept rows; group keys and counts exact, sums rtol 1e-5; {joined.num_rows} joined rows, "
          f"each kept row once, probe key = build key, the group's total and count; keys and "
          f"values in numpy's stable order)")

    with environ(ARROW_TPU_RADIX_R="4"), recorded_calls() as calls4:
        _build.reset_launch_counts()
        sk4, sv4 = C.sort_by_key(kept["k"], kept["v"])
        torch.cuda.synchronize()
        launches4 = {name: k.launches for name, k in _build.KERNELS.items()}
    require(launches4["radix_sort_2bit"] > 0, f"ARROW_TPU_RADIX_R=4 launched no 2-bit sort: {launches4}")
    check_sorted("sort with ARROW_TPU_RADIX_R=4", sk4, sv4, oracle)
    del sk4, sv4
    with environ(ARROW_TPU_SORT="xla"):
        _build.reset_launch_counts()
        skx, svx = C.sort_by_key(kept["k"], kept["v"])
        torch.cuda.synchronize()
        require(_build.KERNELS["radix_sort"].launches == 0, "ARROW_TPU_SORT=xla launched the radix sort")
    check_sorted("sort with ARROW_TPU_SORT=xla", skx, svx, oracle)
    del skx, svx
    print(f"sort_join n={n}: the sort rerun with ARROW_TPU_RADIX_R=4 (launches {launches4}) and "
          f"with ARROW_TPU_SORT=xla (torch.sort, no radix launch) matches numpy")
    launches["radix_sort_2bit"] = launches4["radix_sort_2bit"]
    del out, sk, sv
    with recorded_calls() as calls:  # the query once more, its kernel calls kept for replay
        flagship.sort_join_query(batch)
        torch.cuda.synchronize()
    calls["radix_sort_2bit"] = calls4["radix_sort_2bit"]
    measured = replay_calls(calls, smi)
    del calls, calls4
    torch.cuda.empty_cache()

    steps = {
        "filter": interleaved_ms(lambda: C.filter(batch, flagship.compare_step(batch)),
                                 lambda: plain_step(C.filter, batch, flagship.compare_step(batch))),
        "group-by": interleaved_ms(lambda: flagship.groupby_step(kept),
                                   lambda: plain_step(flagship.groupby_step, kept)),
        "join": interleaved_ms(lambda: C.hash_join(kept, groups, "k", "key"),
                               lambda: plain_step(C.hash_join, kept, groups, "k", "key")),
        "sort": interleaved_ms(lambda: C.sort_by_key(kept["k"], kept["v"]),
                               lambda: plain_step(C.sort_by_key, kept["k"], kept["v"])),
    }
    total_k = sum(v[0] for v in steps.values())
    total_p = sum(v[1] for v in steps.values())
    detail = "; ".join(f"{s} kernel {k:.3f} ms, plain {p:.3f} ms" for s, (k, p) in steps.items())
    print(f"sort_join n={n} step times (CUDA events, median of {REPS} after a warm-up; the filter "
          f"step includes its compare; {smi}): {detail}; total kernel {total_k:.3f} ms, plain "
          f"{total_p:.3f} ms")
    del batch, kept, groups, joined
    torch.cuda.empty_cache()

    for m in CROSSOVER_SIZES:
        b = flagship.make_batch(m, seed=1, device=device)
        radix_ms, torch_ms = interleaved_ms(
            lambda: C.sort_by_key(b["k"], b["v"], method="radix"),
            lambda: C.sort_by_key(b["k"], b["v"], method="xla"),
        )
        print(f"sort_join: sort_by_key crossover at n={m} (u32 keys in [0, 10000) + f32 values; "
              f"CUDA events, median of {REPS}; {smi}): radix {radix_ms:.3f} ms, torch.sort "
              f"{torch_ms:.3f} ms")
        del b
        torch.cuda.empty_cache()
    return launches, measured


def phase_profile(smi):
    """Each query at each size under torch.profiler.  Device busy time is the union
    of the device's kernel, copy and set intervals inside the query's host
    interval (the query and a synchronize); the idle share is the rest of that
    interval.  The profiler's own host overhead lengthens the interval, so the
    idle share of a profiled query is an upper bound."""
    import torch
    from torch.autograd import DeviceType

    from arrow_tpu_torch import flagship

    queries = [("flagship", n, flagship.flagship_query) for n in FLAGSHIP_SIZES]
    queries.append(("sort_join", SORT_JOIN_N, flagship.sort_join_query))
    for label, n, query in queries:
        batch = flagship.make_batch(n, seed=0, device="cuda")
        query(batch)  # warm the allocator
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("the_query"):
                query(batch)
                torch.cuda.synchronize()
        events = prof.events()
        window = [e.time_range for e in events
                  if e.name == "the_query" and e.device_type == DeviceType.CPU]
        require(len(window) == 1, f"profile: {len(window)} query ranges in the trace")
        t0, t1 = window[0].start, window[0].end
        device = sorted(
            (max(e.time_range.start, t0), min(e.time_range.end, t1), e.name) for e in events
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.name != "the_query" and e.time_range.end > t0 and e.time_range.start < t1
        )
        if not device:
            print(f"profile {label} n={n}: the profiler saw no device activity; device busy time and "
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
        print(f"profile {label} n={n} ({smi}): query interval {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall:.3f}; {len(device)} device ops; "
              f"the hand-written kernels {own / 1e3:.3f} ms of the busy time")
        for name, us in top:
            print(f"profile {label} n={n}:   {us / 1e3:8.3f} ms  {name[:110]}")
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
    phase_flagship(smi)
    launches, measured = phase_sort_join(smi)
    phase_profile(smi)

    from arrow_tpu_torch.compute.kernels import _build

    kernels = []
    for name, k in _build.KERNELS.items():
        replay_err, ms, plain_ms = measured[name]  # ms: summed over the run's calls
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
