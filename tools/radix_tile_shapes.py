#!/usr/bin/env python3
"""Time kernel B3 (arrow_tpu_torch/csrc/radix.cu) at several tile shapes on
one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/radix_tile_shapes.py

Each variant is radix.cu with its threads a block (``kThreads``), rows a
thread (``kItems``) and least blocks an SM (``kMinBlocks``, which caps the
registers) replaced.  Of the modifications, "match" finds a lane's 8-bit
peers with ``__match_any_sync`` instead of 8 ballots, "ordered" stores the
descriptors with release and reads them with acquire order, "look1" and
"look8" read 1 or 8 descriptors a step of the walk back instead of 4, and
"x-nolookback" skips the look-back (wrong output: it shows what the
look-back costs).  The variants are built in parallel with the port's nvcc
flags into build/radix_variants/, checked against the port's own build on
each call, and timed in turns on one card (CUDA events, the median of 7
samples of 4 back-to-back calls; buffers and scratch allocated once, outside
the time).  Each line gives the call, its bound (every plane read and written
once, over 3.35 TB/s) and each variant's time with the share of the bound it
reaches; beside them torch.sort of the key, and before them the device time
of the port's own build by kernel (torch.profiler).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

from arrow_tpu_torch.compute.kernels import _build  # noqa: E402
from arrow_tpu_torch.compute.kernels import radix as R  # noqa: E402

# name -> (threads a block, rows a thread, least blocks an SM, modification)
VARIANTS = {
    "t1024i8": (1024, 8, 1, ""),
    "t256i16": (256, 16, 2, ""),
    "t256i24": (256, 24, 2, ""),
    "t512i8": (512, 8, 2, ""),
    "t512i12": (512, 12, 1, ""),
    "t512i16": (512, 16, 1, ""),
    "t768i8": (768, 8, 1, ""),
    "t1024i8match": (1024, 8, 1, "match"),
    "t1024i8ordered": (1024, 8, 1, "ordered"),
    "t1024i8look1": (1024, 8, 1, "look1"),
    "t1024i8look8": (1024, 8, 1, "look8"),
    "x-nolookback": (1024, 8, 1, "x-nolookback"),
}
# a modification whose name starts with "x-" gives wrong output: it is timed
# to see what a step costs, and not checked
MODS = {"match": ("constexpr bool kMatchAny = false;", "constexpr bool kMatchAny = true;"),
        "ordered": ("constexpr bool kOrdered = false;", "constexpr bool kOrdered = true;"),
        "look1": ("constexpr int kLookBack = 4;", "constexpr int kLookBack = 1;"),
        "look8": ("constexpr int kLookBack = 4;", "constexpr int kLookBack = 8;"),
        "x-nolookback": ("if (totals[threadIdx.x]) before =", "if (false) before =")}
HBM_BYTES_PER_S = 3.35e12
REPS, CALLS = 7, 4
OUT = HERE / "build" / "radix_variants"


def variant_source(threads: int, items: int, blocks: int, mod: str) -> str:
    src = (HERE / "arrow_tpu_torch" / "csrc" / "radix.cu").read_text()
    for name, value in (("kThreads", threads), ("kItems", items), ("kMinBlocks", blocks)):
        src, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if count != 1:
            raise RuntimeError(f"radix.cu no longer holds one definition of {name}")
    if mod:
        old, new = MODS[mod]
        if src.count(old) != 1:
            raise RuntimeError(f"radix.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> str:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "radix.cu").write_text(variant_source(*VARIANTS[name]))
    shutil.copy(HERE / "arrow_tpu_torch" / "csrc" / "common.cu", d / "common.cu")
    return _build.build_library(d / "lib.so", [d / "radix.cu", d / "common.cu"])[1]


def build_all() -> dict:
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        logs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    libs = {}
    for name, log in logs.items():
        # registers and spills of the 8-bit pass for 4- and 8-byte keys
        regs, entry = [], None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)
            elif entry and "radix_onesweepILi8E" in entry:
                if "Used" in ln:
                    regs.append(f"{'u64' if 'ILi8Em' in entry else 'u32'} key "
                                f"{ln.split('Used')[1].split(',')[0].strip()}")
                elif "spill" in ln and "0 bytes spill stores" not in ln:
                    regs.append(ln.strip())
        print(f"{name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.arrow_radix_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.arrow_radix_scratch_bytes.restype = ctypes.c_longlong
        lib.arrow_radix_sort.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_longlong, ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.arrow_radix_sort.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, planes, sig, shifts):
    """A call of one variant's sort on fixed arguments, at 8-bit digits."""
    k, n = len(planes), planes[0].shape[0]
    buf_a = [torch.empty_like(p) for p in planes]
    buf_b = [torch.empty_like(p) for p in planes]
    scratch = torch.empty(lib.arrow_radix_scratch_bytes(n, 8, len(shifts)), dtype=torch.uint8, device="cuda")

    def ptrs(ts):
        return (ctypes.c_void_p * k)(*[t.data_ptr() for t in ts])

    ins, pa, pb = ptrs(planes), ptrs(buf_a), ptrs(buf_b)
    wide = (ctypes.c_int * k)(*[int(p.element_size() == 8) for p in planes])
    cshifts = (ctypes.c_int * len(shifts))(*shifts)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.arrow_radix_sort(ins, pa, pb, wide, k, n, sig, cshifts, len(shifts), 8,
                                   scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"arrow_radix_sort returned {err}")
        return buf_a if len(shifts) % 2 else buf_b

    return call


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def cases(gen):
    """(label, planes, the bits sorted by): the shapes of the queries' calls."""
    n = 1 << 27

    def u32(m, hi):
        return torch.randint(0, hi, (m,), generator=gen, device="cuda").to(torch.int32)

    def rows(m):
        return torch.arange(m, dtype=torch.int32, device="cuda")

    m = 67_105_771
    yield "sort_by_key: 14 bits, 67 105 771 rows, 2 x 4 B", [u32(m, 10_000), rows(m)], (1 << 14) - 1
    yield "class sort: bits 12-19, 2^27 rows, 2 x 4 B", [u32(n, 1 << 20), rows(n)], 0xFF000
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    yield ("skewed class sort: bits 12-19, 2^27 rows, 2 x 4 B",
           [(u.pow(4) * (1 << 20)).to(torch.int32), rows(n)], 0xFF000)
    del u
    yield "31 bits, 2^27 rows, 2 x 4 B", [u32(n, 1 << 31), rows(n)], (1 << 31) - 1
    yield ("64-bit key, 32 bits, 2^26 rows, 8 B + 4 B",
           [torch.randint(0, 1 << 32, (n // 2,), generator=gen, device="cuda") << 16, rows(n // 2)],
           ((1 << 32) - 1) << 16)
    yield ("4 planes (4, 4, 8, 4 B), 16 bits, 2^26 rows",
           [u32(n // 2, 1 << 16), rows(n // 2), torch.randn(n // 2, generator=gen, device="cuda",
                                                              dtype=torch.float64), rows(n // 2)],
           (1 << 16) - 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("radix_tile_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for label, planes, sig in cases(gen):
        key_bits = 8 * planes[0].element_size()
        shifts = R._shifts(sig, key_bits, 8)
        bits = [b for b in range(key_bits) if (sig >> b) & 1]
        want = R.radix_sort(planes, bits, None, 8)  # the port's own build
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            R.radix_sort(planes, bits, None, 8)
            torch.cuda.synchronize()
        by_kernel = "; ".join(f"{e.key.split('::')[-1].split('(')[0][:40]} x{e.count} {e.device_time_total / 1e3:.3f} ms"
                              for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:6])
        print(f"{label}: device time of the port's build by kernel: {by_kernel}")
        fns = {name: launcher(lib, planes, sig, shifts) for name, lib in libs.items()}
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not name.startswith("x-") and not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"{name} differs from the port's build on {label}")
        del want
        key = planes[0]
        fns["torch.sort"] = lambda: torch.sort(key, stable=True)
        for fn in fns.values():  # warm-up
            fn()
        samples = {name: [] for name in fns}
        for _ in range(REPS):
            for name, fn in fns.items():
                samples[name].append(event_ms(fn))
        bound = sum(2 * p.numel() * p.element_size() for p in planes) / HBM_BYTES_PER_S * 1e3
        times = "; ".join(f"{name} {statistics.median(v):.4f} ms ({bound / statistics.median(v):.2f})"
                          for name, v in samples.items())
        print(f"{label}, {len(shifts)} passes: bound {bound:.4f} ms; {times} ({smi})")
        del planes, fns, key
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
