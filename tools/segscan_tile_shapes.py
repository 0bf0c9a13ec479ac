#!/usr/bin/env python3
"""Time kernel B2 (arrow_tpu_torch/csrc/segscan.cuh) at several tile shapes on
one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/segscan_tile_shapes.py

Each variant is segscan.cuh with its threads a block (``kThreads``) and bytes
a thread (``kThreadBytes``) replaced, optionally with a minimum of 8 blocks an
SM for one-plane scans ("lb") or plain cached loads instead of streaming
ones ("ldg").  The variants are built in parallel with the port's nvcc flags
into build/segscan_variants/, checked against the port's own build on each
call, and timed in turns on one card (CUDA events, the median of 7 samples of
4 back-to-back calls).  Each line gives the call, its bound (each plane read
and written once, the flag bytes read once, over 3.35 TB/s) and each
variant's time with the share of the bound it reaches; beside the
unsegmented adds, torch.cumsum.
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
from arrow_tpu_torch.compute.kernels import segscan as S  # noqa: E402

# name -> (threads a block, bytes a thread, modification)
VARIANTS = {
    "t128b128": (128, 128, ""),
    "t256b64": (256, 64, ""),
    "t256b128": (256, 128, ""),
    "t512b64": (512, 64, ""),
    "t64b128": (64, 128, ""),
    "t128b128lb": (128, 128, "lb"),
    "t128b128ldg": (128, 128, "ldg"),
}
HBM_BYTES_PER_S = 3.35e12
REPS, CALLS = 7, 4
OUT = HERE / "build" / "segscan_variants"


def variant_source(threads: int, thread_bytes: int, mod: str) -> str:
    src = (HERE / "arrow_tpu_torch" / "csrc" / "segscan.cuh").read_text()
    for old, new in (("constexpr int kThreads = 128;", f"constexpr int kThreads = {threads};"),
                     ("constexpr int kThreadBytes = 128;", f"constexpr int kThreadBytes = {thread_bytes};")):
        if src.count(old) != 1:
            raise RuntimeError(f"segscan.cuh no longer holds {old!r}")
        src = src.replace(old, new)
    if mod == "lb":
        src = src.replace("__launch_bounds__(kThreads) seg_lookback",
                          "__launch_bounds__(kThreads, NP == 1 ? 8 : 1) seg_lookback")
    if mod == "ldg":
        src = src.replace("s4[swizzle(c)] = __ldcs(g + c);", "s4[swizzle(c)] = g[c];")
    return src


def build_variant(name: str) -> str:
    threads, thread_bytes, mod = VARIANTS[name]
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "segscan.cuh").write_text(variant_source(threads, thread_bytes, mod))
    for src in ("segscan.cu", "segscan_wide.cu", "common.cu"):
        shutil.copy(HERE / "arrow_tpu_torch" / "csrc" / src, d / src)
    return _build.build_library(d / "lib.so", [d / "segscan.cu", d / "segscan_wide.cu", d / "common.cu"])[1]


def build_all() -> dict:
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        logs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    libs = {}
    for name, log in logs.items():
        # registers of the one-plane i32 and i64 adds and the three-plane i32 max
        regs, entry = [], None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)
            elif entry and "Used" in ln:
                for tag, what in (("IiiLi0ELi1E", "i32 add"), ("IxxLi0ELi1E", "i64 add"), ("IiiLi1ELi3E", "3 x i32 max")):
                    if tag in entry:
                        regs.append(f"{what} {ln.split('Used')[1].split(',')[0].strip()}")
        print(f"{name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.arrow_segscan_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.arrow_segscan_scratch_bytes.restype = ctypes.c_longlong
        lib.arrow_segscan.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.arrow_segscan.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, planes, flags, op, dtype_code):
    """A call of one variant's kernel on fixed arguments (inputs aligned)."""
    k, n = len(planes), planes[0].shape[0]
    outs = [torch.empty_like(p) for p in planes]
    opc = S._OP_CODE[op]
    scratch = torch.empty(lib.arrow_segscan_scratch_bytes(n, dtype_code, opc, k), dtype=torch.uint8, device="cuda")
    ins = (ctypes.c_void_p * k)(*[p.data_ptr() for p in planes])
    outp = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    fptr = flags.data_ptr() if flags is not None else None
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.arrow_segscan(ins, outp, k, fptr, dtype_code, opc, n, 1, scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"arrow_segscan returned {err}")
        return outs

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
    n = 1 << 27

    def i32(m):
        return torch.randint(-(2**31), 2**31 - 1, (m,), dtype=torch.int32, generator=gen, device="cuda")

    def flags(m, density):
        return torch.rand(m, generator=gen, device="cuda") < density

    yield "i32 add, no flags, 2^27", [i32(n)], None, "add", 0
    yield "i32 max, dense flags, 2^27", [i32(n)], flags(n, 0.3), "max", 0
    yield ("i64 add, no flags, 2^26",
           [torch.randint(-(2**62), 2**62, (n // 2,), generator=gen, device="cuda")], None, "add", 3)
    yield ("f64 add, sparse flags, 2^27",
           [torch.rand(n, dtype=torch.float64, generator=gen, device="cuda") + 0.5], flags(n, 0.001), "add", 5)
    yield "3 i32 planes, max, dense flags, 2^27", [i32(n) for _ in range(3)], flags(n, 0.3), "max", 0
    yield "i32 add, sparse flags, 2^26", [i32(n // 2)], flags(n // 2, 0.001), "add", 0


def main() -> int:
    if not torch.cuda.is_available():
        print("segscan_tile_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for label, planes, flags, op, code in cases(gen):
        want = S.segmented_scan_multi(planes, flags, op)  # the port's own build
        fns = {name: launcher(lib, planes, flags, op, code) for name, lib in libs.items()}
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                same = bool(((g - w).abs() / w.abs()).max() <= 1e-12) if w.is_floating_point() else torch.equal(g, w)
                if not same:
                    raise RuntimeError(f"{name} differs from the port's build on {label}")
        if flags is None and op == "add":
            fns["torch.cumsum"] = lambda: [torch.cumsum(p, 0) for p in planes]
        for fn in fns.values():  # warm-up
            fn()
        samples = {name: [] for name in fns}
        for _ in range(REPS):
            for name, fn in fns.items():
                samples[name].append(event_ms(fn))
        nbytes = sum(2 * p.numel() * p.element_size() for p in planes) + (flags.numel() if flags is not None else 0)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        times = "; ".join(f"{name} {statistics.median(v):.4f} ms ({bound / statistics.median(v):.2f})"
                          for name, v in samples.items())
        print(f"{label}: bound {bound:.4f} ms; {times} ({smi})")
        del planes, flags, want, fns
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
