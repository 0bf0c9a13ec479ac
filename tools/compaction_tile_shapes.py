#!/usr/bin/env python3
"""Time kernels B1 and B8 (arrow_tpu_torch/csrc/compaction3.cu) at several
tile shapes on one CUDA card, on the main paths' own calls and on a few
shaped ones.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/compaction_tile_shapes.py [--baseline OTHER/compaction3.cu] [--quick | --profile]

Each variant is compaction3.cu with its threads a block (``kThreads``), its
part of a tile (``kPartBytes``: bytes of a plane's part at the launch's
widest plane), its parts a tile (``kParts``), its ring of shared buffers
(``kBuffers``), its least blocks an SM (``kMinBlocks``, which caps the
registers) replaced, and some with a source substitution: "reg" loads into
registers and stores to shared memory where the kernel issues cp.async
copies, "x-nolookback" skips the look-back (wrong output: it shows what the
look-back costs).
``--baseline`` adds a variant built from another compaction3.cu with the same
C entries (an earlier design, unpacked from git).  The variants are built in
parallel with the port's nvcc flags into build/compaction_variants/, checked
bit for bit against the port's own build on each call, and timed in turns on
one card (CUDA events, the median of 7 samples of 4 back-to-back calls of the
C entry alone; outputs and scratch allocated once, outside the time).

The calls: every B1 call of the flagship query, the sort-join query and the
100m group-by query at 2^27 rows (recorded as chip_smoke.py records them),
then a 1% and a 99% mask on the filter's two planes, 16 mixed planes, and
the split (B8) of three 4-byte planes by a 0.5 mask and by a bit.  Each line
gives the call, its bound (chip_smoke.py's call_bytes over 3.35 TB/s), each
variant's time with the share of the bound it reaches, and x[mask] per plane
(a compaction without bitmap planes).  ``--quick`` times the flagship's
calls and the split by a mask only.

``--profile`` (with ``--baseline``) instead profiles the flagship query at
2^27 rows as chip_smoke.py's profile phase does (profile_query), through the
port's wrapper with the port's build and with the baseline build in turns
(port, baseline, baseline, port): first on a fresh process, then again after
the flagship's kernel calls were replayed and timed as chip_smoke.py's
flagship phase replays them.  It tells a host interval that comes from the
kernel build from one that comes from what ran before it in the process.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import pathlib
import re
import shutil
import statistics
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from arrow_tpu_torch import flagship  # noqa: E402
from arrow_tpu_torch.compute.kernels import _build  # noqa: E402
from arrow_tpu_torch.compute.kernels import compaction3 as C3  # noqa: E402
from arrow_tpu_torch.utils import bits as B  # noqa: E402

# name -> (threads a block, part bytes, parts a tile, shared buffers in the ring, least blocks an SM,
# source substitution)
VARIANTS = {
    "t512b32p4k2": (512, 32768, 4, 2, 2, ""),
    "t256b32p4k2": (256, 32768, 4, 2, 2, ""),
    "t512b32p1k2": (512, 32768, 1, 2, 2, ""),
    "t512b32p8k2": (512, 32768, 8, 2, 2, ""),
    "t512b16p8k2": (512, 16384, 8, 2, 3, ""),
    "t256b32p4k1": (256, 32768, 4, 1, 3, ""),
    "t512b16p8k3": (512, 16384, 8, 3, 2, ""),
    "t512b32p4k2reg": (512, 32768, 4, 2, 2, "reg"),
    "x-nolookback": (512, 32768, 4, 2, 2, "x-nolookback"),
}
# substitution -> (old, new) pairs of source text, each found once; one whose
# name starts with "x-" gives wrong output: it is timed to see what a step
# costs, and not checked
MODS = {
    "reg": (
        ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" : : "r"(s), "l"(gmem) : "memory");',
         "*static_cast<uint4*>(smem) = __ldg(static_cast<const uint4*>(gmem));"),
        ('asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" : : "r"(s), "l"(gmem), "n"(N) : "memory");',
         "if (N == 8) *static_cast<uint64_t*>(smem) = __ldg(static_cast<const unsigned long long*>(gmem));\n"
         "    else *static_cast<uint32_t*>(smem) = __ldg(static_cast<const unsigned*>(gmem));"),
        ('asm volatile("cp.async.commit_group;" : : : "memory");', "(void)0;"),
        ('asm volatile("cp.async.wait_group %0;" : : "n"(kBuffers - 1) : "memory");', "(void)0;"),
    ),
    "x-nolookback": (("const int before = walk_back(status, tile, count);", "const int before = 0;"),),
}
QUERY_N = 1 << 27
HBM_BYTES_PER_S = 3.35e12
REPS, CALLS = 7, 4
OUT = HERE / "build" / "compaction_variants"


def variant_source(threads: int, part_bytes: int, parts: int, buffers: int, blocks: int, mod: str) -> str:
    src = (HERE / "arrow_tpu_torch" / "csrc" / "compaction3.cu").read_text()
    for name, value in (("kThreads", threads), ("kPartBytes", part_bytes), ("kParts", parts),
                        ("kBuffers", buffers), ("kMinBlocks", blocks)):
        src, count = re.subn(rf"constexpr int {name} = \w+;", f"constexpr int {name} = {value};", src)
        if count != 1:
            raise RuntimeError(f"compaction3.cu no longer holds one definition of {name}")
    for old, new in MODS.get(mod, ()):
        if src.count(old) != 1:
            raise RuntimeError(f"compaction3.cu no longer holds {old!r} once")
        src = src.replace(old, new)
    return src


def build_variant(name: str, baseline) -> str:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    src = pathlib.Path(baseline).read_text() if name == "baseline" else variant_source(*VARIANTS[name])
    (d / "compaction3.cu").write_text(src)
    shutil.copy(HERE / "arrow_tpu_torch" / "csrc" / "common.cu", d / "common.cu")
    return _build.build_library(d / "lib.so", [d / "compaction3.cu", d / "common.cu"])[1]


def build_all(baseline, only_baseline=False) -> dict:
    names = [*([] if only_baseline else VARIANTS), *(["baseline"] if baseline else [])]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(lambda name: build_variant(name, baseline), names)))
    libs = {}
    for name, log in logs.items():
        # registers and spills of each kernel of the variant
        regs, entry = [], None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)[-40:]
            elif entry and "Used" in ln:
                regs.append(f"{entry} {ln.split('Used')[1].split(',')[0].strip()}")
            elif entry and "spill" in ln and "0 bytes spill stores" not in ln:
                regs.append(f"{entry} {ln.strip()}")
        print(f"{name}: {'; '.join(regs)}")
        libs[name] = C3.declare(ctypes.CDLL(str(OUT / name / "lib.so")))
    return libs


def launcher(lib, call):
    """One variant's C entry on fixed arguments: a B1 call (vplanes, wplanes,
    mask, n) or a B8 call ("split", planes, mask, bit)."""
    stream = torch.cuda.current_stream().cuda_stream
    if call[0] == "split":
        _, planes, mask, bit = call
        n, k = planes[0].shape[0], len(planes)
        sel, unsel = [torch.empty_like(p) for p in planes], [torch.empty_like(p) for p in planes]
        outs = (*sel, *unsel)

        def ptrs(ts):
            return (ctypes.c_void_p * k)(*[t.data_ptr() for t in ts])

        args = (ptrs(planes), ptrs(sel), ptrs(unsel), k, None if mask is None else mask.data_ptr(),
                0 if bit is None else bit, n)
        entry = lib.arrow_split_multi
    else:
        vplanes, wplanes, mask, n = call
        outs = (*[torch.empty(n, dtype=p.dtype, device="cuda") for p in vplanes],
                *[torch.empty(n, dtype=torch.int32, device="cuda") for _ in wplanes])
        k = len(outs)
        kinds = [0 if p.element_size() == 4 else 1 for p in vplanes] + [2] * len(wplanes)
        args = ((ctypes.c_void_p * k)(*[p.data_ptr() for p in (*vplanes, *wplanes)]),
                (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs]), (ctypes.c_int * k)(*kinds), k,
                mask.data_ptr(), n)
        entry = lib.arrow_compact_multi
    scratch = torch.empty(lib.arrow_compact_scratch_bytes(n), dtype=torch.uint8, device="cuda")
    count = torch.empty((), dtype=torch.int32, device="cuda")

    def run():
        err = entry(*args, scratch.data_ptr(), count.data_ptr(), stream)
        if err:
            raise RuntimeError(f"the C entry returned {err}")
        return (*outs, count.reshape(1))

    return run


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def describe(call) -> str:
    if call[0] == "split":
        _, planes, mask, bit = call
        return (f"split of {len(planes)} 4-byte planes, n={planes[0].shape[0]}, by "
                f"{'a mask' if mask is not None else f'bit {bit}'}")
    vplanes, wplanes, mask, n = call
    kept = int(B.unpack_bits(mask[: B.num_words(n)], n).sum())
    widths = "+".join(str(p.element_size()) for p in vplanes)
    return (f"{len(vplanes)} value planes ({widths} B) + {len(wplanes)} bitmap planes, n={n}, kept {kept} "
            f"({kept / max(n, 1):.4f})")


def time_call(label, call, libs, smi) -> None:
    want = C3.split_multi_cuda(*call[1:]) if call[0] == "split" else C3.compact_multi_cuda(*call)
    want = CS._flat(want)
    fns = {name: launcher(lib, call) for name, lib in libs.items()}
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        if not name.startswith("x-") and not CS._exact(got, want)[0]:
            raise RuntimeError(f"{name} differs from the port's build on {label}")
    del want
    if call[0] == "split":
        bound = CS.call_bytes("split_multi", call[1:])
    else:
        bound = CS.call_bytes("compact_multi", call)
        lib = CS.library_call("compact_multi", call)
        if lib is not None:
            fns["x[mask]"] = lib
    for fn in fns.values():  # warm-up
        fn()
    samples = {name: [] for name in fns}
    for _ in range(REPS):
        for name, fn in fns.items():
            samples[name].append(event_ms(fn))
    bound_ms = bound / HBM_BYTES_PER_S * 1e3
    times = "; ".join(f"{name} {statistics.median(v):.4f} ms ({bound_ms / statistics.median(v):.2f})"
                      for name, v in samples.items())
    shares = "" if call[0] == "split" else f"; {CS.sector_shares('compact_multi', call)}"
    print(f"{label}: {describe(call)}: bound {bound_ms:.4f} ms; {times}{shares} ({smi})", flush=True)


def main_path_calls(quick=False):
    """(label, B1 call) for each B1 call of the three queries at QUERY_N rows
    (quick: the flagship's only)."""
    queries = (
        ("flagship", lambda: flagship.flagship_query(flagship.make_batch(QUERY_N, 0, "cuda"))),
        ("sort_join", lambda: flagship.sort_join_query(flagship.make_batch(QUERY_N, 0, "cuda"))),
        ("groupby 100m", lambda: flagship.groupby_query(flagship.make_groupby_batch(QUERY_N, "100m", 0, "cuda"))),
    )
    for qname, run in queries[:1] if quick else queries:
        with CS.recorded_calls() as calls:
            out = run()
            torch.cuda.synchronize()
        del out
        for i, args in enumerate(calls["compact_multi"]):
            yield f"{qname} call {i + 1}", args
        del calls
        torch.cuda.empty_cache()


def shaped_calls(gen):
    n = QUERY_N
    k = torch.randint(0, 10_000, (n,), generator=gen, device="cuda").to(torch.int32)
    v = torch.randn(n, generator=gen, device="cuda")
    for p in ("0.01", "0.99"):
        yield f"filter planes, mask {p}", ([k, v], [], B.pack_bits(CS._rand_mask(n, p, gen, "cuda")), n)
    vplanes, wplanes = CS._b1_planes("16 planes", n // 4, gen, "cuda")
    yield "16 mixed planes, mask 0.5", (vplanes, wplanes, B.pack_bits(CS._rand_mask(n // 4, "0.5", gen, "cuda")),
                                        n // 4)
    del vplanes, wplanes
    planes, mask, _ = CS._split_args(n, "0.5", gen, "cuda")
    yield "B8 mask 0.5", ("split", planes, mask, None)
    yield "B8 bit 0", ("split", planes, None, 0)


def profile_builds(libs, smi) -> None:
    """The flagship query under the profiler with each build in turns, before
    and after a replay of its kernel calls (see the module note)."""
    import numpy as np

    batch = flagship.make_batch(QUERY_N, 0, "cuda")
    own_lib = C3._lib
    builds = {"port build": own_lib(), "baseline build": libs["baseline"]}
    try:
        answers = {}
        for tag, lib in builds.items():
            C3._lib = lambda lib=lib: lib
            rows, groups = flagship.flagship_query(batch)
            answers[tag] = (rows, *(groups[c].raw_values() for c in groups.column_names))
        a, b = answers.values()
        if a[0] != b[0] or not all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:])):
            raise RuntimeError("the two builds give different flagship answers")
        print(f"profile: both builds give the same flagship answer ({a[0]} rows kept, {len(a[1])} groups)")
        for when in ("fresh", "after the replay"):
            if when != "fresh":
                C3._lib = own_lib
                with CS.recorded_calls() as calls:
                    flagship.flagship_query(batch)
                    torch.cuda.synchronize()
                CS.replay_calls(calls, smi, f"flagship n={QUERY_N}")
                del calls
                torch.cuda.empty_cache()
            seen = {tag: [] for tag in builds}
            for tag in ("port build", "baseline build", "baseline build", "port build"):
                C3._lib = lambda lib=builds[tag]: lib
                got = CS.profile_query(f"flagship, {when}, {tag}", QUERY_N, flagship.flagship_query, batch, smi)
                if got is not None:
                    seen[tag].append(got)
            for tag, v in seen.items():
                print(f"profile flagship, {when}, {tag}: query interval "
                      f"{', '.join(f'{w:.3f}' for w, _ in v)} ms, device busy "
                      f"{', '.join(f'{b:.3f}' for _, b in v)} ms, idle share "
                      f"{', '.join(f'{1 - b / w:.3f}' for w, b in v)} ({smi})", flush=True)
    finally:
        C3._lib = own_lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="another compaction3.cu with the same C entries, timed beside")
    parser.add_argument("--quick", action="store_true", help="the flagship's calls and the B8 mask split only")
    parser.add_argument("--profile", action="store_true",
                        help="profile the flagship query with the port's build and the baseline's, in turns")
    opts = parser.parse_args()
    if opts.profile and not opts.baseline:
        parser.error("--profile needs --baseline")
    if not torch.cuda.is_available():
        print("compaction_tile_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    smi = CS.smi_line()
    print(smi)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the port's own build beside the variants'
        port = pool.submit(_build.load)
        libs = build_all(opts.baseline, only_baseline=opts.profile)
        port.result()
    if opts.profile:
        profile_builds(libs, smi)
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    for label, call in main_path_calls(opts.quick):
        time_call(label, call, libs, smi)
        del call
    for label, call in shaped_calls(gen):
        if opts.quick and label != "B8 mask 0.5":
            continue
        time_call(label, call, libs, smi)
        del call
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
