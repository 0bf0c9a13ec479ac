#!/usr/bin/env python3
"""Time kernel B7 (arrow_tpu_torch/csrc/merge.cu) at several tile shapes on
one CUDA card, on the main paths' own calls and on a few shaped ones.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/merge_tile_shapes.py [--baseline OTHER/merge.cu] [--quick] [--only NAME,...]

Each variant is merge.cu with its threads a block (``kThreads``), outputs a
thread (``kItems``; a tile is their product) and shared plane buffers in its
ring (``kBuffers``) replaced, and some with source substitutions:
"cpasync" copies every whole 16-byte chunk of a window by cp.async where
the kernel copies a window's aligned middle by one bulk copy (TMA); "reg",
after "cpasync", loads those chunks into registers and stores them to
shared memory; "inblock" drops the partition launch and has two warps of
each block find the tile's co-ranks by a warp-parallel search (32 probes a
step) before the block starts its copies; "x-nomerge" writes the sources
without searching or comparing (wrong output: it shows what the merge in
shared memory costs, and so what padding the stage against bank conflicts
could gain at most).
``--baseline`` adds a variant built from another merge.cu (an earlier
design, unpacked from git); one without ``arrow_merge_scratch_bytes`` is
called as the first design's C entry was, without a scratch.  The variants
are built in parallel with the port's nvcc flags into
build/merge_variants/, checked bit for bit against the port's own build on
each call, and timed in turns on one card (CUDA events, the median of 7
samples of 4 back-to-back calls of the C entry alone; outputs, shared by
the variants, and scratch allocated once, outside the time).

The calls: both B7 calls of the sort-join query at 2^27 rows (the join's
expand and rank fill, recorded as chip_smoke.py records them), then the
merge sort route's pass shapes (key and row id in unique-payload mode,
2^27 rows, runs of 8192 and of 2^26 rows of random keys), 8 planes and one
plane in one pair of 2^26-row runs.  Each line gives the call, its bound
(chip_smoke.py's call_bytes over 3.35 TB/s), each variant's time with the
share of the bound it reaches, torch.sort of the key, and a clone of every
plane (the same bytes moved in order: what the card reaches on a copy).  ``--quick``
times the sort-join's two calls only; ``--only`` builds and times the named
variants only (and the baseline).
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
from arrow_tpu_torch.compute.kernels import merge as M  # noqa: E402

# name -> (threads a block, outputs a thread, plane buffers in the ring, source substitutions);
# the first is the kernel's own shape
VARIANTS = {
    "t128i29b3": (128, 29, 3, ()),
    "t128i29b2": (128, 29, 2, ()),
    "t128i33b3": (128, 33, 3, ()),
    "t128i47b2": (128, 47, 2, ()),
    "t256i31b2": (256, 31, 2, ()),
    "t256i17b2": (256, 17, 2, ()),
    "t256i16b3": (256, 16, 3, ()),
    "t512i8b3": (512, 8, 3, ()),
    "t128i16b3": (128, 16, 3, ()),
    "t512i16b3": (512, 16, 3, ()),
    "t128i29b3cpasync": (128, 29, 3, ("cpasync",)),
    "t128i33b3cpasync": (128, 33, 3, ("cpasync",)),
    "t128i31b3cpasync": (128, 31, 3, ("cpasync",)),
    "t256i31b2cpasync": (256, 31, 2, ("cpasync",)),
    "t256i15b3cpasync": (256, 15, 3, ("cpasync",)),
    "t256i16b3cpasync": (256, 16, 3, ("cpasync",)),
    "t128i29b3reg": (128, 29, 3, ("cpasync", "reg")),
    "t256i16b3reg": (256, 16, 3, ("cpasync", "reg")),
    "t128i29b3inblock": (128, 29, 3, ("inblock",)),
    "t256i16b3inblock": (256, 16, 3, ("cpasync", "inblock")),
    "x-nomerge-t128i29b3": (128, 29, 3, ("x-nomerge",)),
    "x-nomerge-t256i16b3": (256, 16, 3, ("cpasync", "x-nomerge")),
}
_WARP_CO_RANK = """// Two warps of a block: the co-rank of output k, 32 probes a step.
template <bool UNIQUE>
__device__ long long warp_co_rank(long long k, const int32_t* ka, const int32_t* pa, long long la,
                                  const int32_t* kb, const int32_t* pb, long long lb) {
  const int lane = threadIdx.x & 31;
  long long lo = k > lb ? k - lb : 0;
  long long hi = k < la ? k : la;
  auto before = [&](long long m) {
    return a_first<UNIQUE>(ka[m], UNIQUE ? pa[m] : 0, kb[k - 1 - m], UNIQUE ? pb[k - 1 - m] : 0);
  };
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    const long long m = lo + lane * step;
    const int c = __popc(__ballot_sync(0xffffffffu, m < hi && before(m)));
    const long long nhi = lo + c * step < hi ? lo + c * step : hi;
    lo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = nhi;
  }
  const long long m = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, m < hi && before(m)));
}

// One block a tile (see the note at the top)."""
_IN_BLOCK_TILE = """__shared__ int block_corank[2];
  if (2 * run >= kTile && threadIdx.x < 64) {
    const Place at = place(blockIdx.x, n, run);
    const long long la = at.plen < run ? at.plen : run;
    const long long o = threadIdx.x < 32 ? at.o0 : (at.o0 + kTile < at.plen ? at.o0 + kTile : at.plen);
    const int32_t* ka = planes.in[0] + at.pstart;
    const int32_t* pa = UNIQUE ? planes.in[1] + at.pstart : nullptr;
    const long long r = warp_co_rank<UNIQUE>(o, ka, pa, la, ka + la, UNIQUE ? pa + la : nullptr, at.plen - la);
    if ((threadIdx.x & 31) == 0) block_corank[threadIdx.x >> 5] = static_cast<int>(r);
  }
  __syncthreads();
  const Tile t = tile_of(blockIdx.x, n, run, block_corank - blockIdx.x);"""
_CP_ASYNC_COPIES = """// Start the copies of a plane's A and B windows into its buffer, each
// window's row i at its chunk shift + i: 16-byte cp.async copies of whole
// chunks, 4-byte ones at the ends; thread 0 arrives on `bar` with no bytes.
__device__ __forceinline__ void copy_windows(int32_t* buf, const int32_t* in, const Tile& t,
                                             unsigned long long* bar) {
  const int32_t* g[2] = {in + t.ga, in + t.gb};
  int32_t* s[2] = {buf, buf + stage_of(in, t).b_at};
  const int count[2] = {t.la, t.lb};
  for (int w = 0; w < 2; ++w) {
    const int sh = chunk_shift(g[w]);
    const int32_t* base = g[w] - sh;
    const int end = sh + count[w];
    for (int k = threadIdx.x * 4; k < end; k += kThreads * 4) {
      if (k >= sh && k + 4 <= end) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" : : "r"(smem_addr(s[w] + k)), "l"(base + k) : "memory");
      } else {
        for (int e = 0; e < 4; ++e) {
          if (k + e >= sh && k + e < end) copy_async4(s[w] + k + e, base + k + e);
        }
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" : : "r"(smem_addr(bar)) : "memory");
}

"""
# substitution -> (old, new) pairs of source text, each found once (an old
# that is a pair of markers stands for the text from the first up to the
# second); one whose name starts with "x-" gives wrong output: it is timed
# to see what a step costs, and not checked
MODS = {
    "cpasync": (  # 16-byte cp.async copies of the whole chunks in place of bulk copies
        (("// Start the copies of a plane's A and B windows", "// Sources of outputs"), _CP_ASYNC_COPIES),
    ),
    "reg": (  # after "cpasync"
        ('asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" : : "r"(smem_addr(s[w] + k)), "l"(base + k) : "memory");',
         "*reinterpret_cast<int4*>(s[w] + k) = __ldg(reinterpret_cast<const int4*>(base + k));"),
        ('asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" : : "r"(smem_addr(smem)), "l"(gmem) : "memory");',
         "*static_cast<int32_t*>(smem) = __ldg(static_cast<const int32_t*>(gmem));"),
        ('asm volatile("cp.async.commit_group;" : : : "memory");', "(void)0;"),
        ('asm volatile("cp.async.wait_group %0;" : : "n"(N) : "memory");', "(void)0;"),
    ),
    "inblock": (
        ("// One block a tile (see the note at the top).", _WARP_CO_RANK),
        ("const Tile t = tile_of(blockIdx.x, n, run, corank);", _IN_BLOCK_TILE),
        ("  if (2 * run >= kTile) {\n    const long long blocks", "  if (false) {\n    const long long blocks"),
    ),
    "x-nomerge": (
        ("  int i = co_rank<UNIQUE, int>(first, ka, pa, la, kb, pb, lb);",
         "  for (int x = first; x < last; ++x) src[x] = x < la ? va + x : vb + x - la;\n"
         "  if (first >= 0) return;\n  int i = 0;"),
    ),
}
QUERY_N = 1 << 27
HBM_BYTES_PER_S = 3.35e12
REPS, CALLS = 7, 4
OUT = HERE / "build" / "merge_variants"


def variant_source(threads: int, items: int, buffers: int, mods: tuple) -> str:
    src = (HERE / "arrow_tpu_torch" / "csrc" / "merge.cu").read_text()
    for name, value in (("kThreads", threads), ("kItems", items), ("kBuffers", buffers)):
        src, count = re.subn(rf"constexpr int {name} = \w+;", f"constexpr int {name} = {value};", src)
        if count != 1:
            raise RuntimeError(f"merge.cu no longer holds one definition of {name}")
    for old, new in (pair for mod in mods for pair in MODS[mod]):
        if isinstance(old, tuple):
            start, end = (src.index(marker) for marker in old)
            old = src[start:end]
        if src.count(old) != 1:
            raise RuntimeError(f"merge.cu no longer holds {old!r} once")
        src = src.replace(old, new)
    return src


def build_variant(name: str, baseline) -> str:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    src = pathlib.Path(baseline).read_text() if name == "baseline" else variant_source(*VARIANTS[name])
    (d / "merge.cu").write_text(src)
    shutil.copy(HERE / "arrow_tpu_torch" / "csrc" / "common.cu", d / "common.cu")
    return _build.build_library(d / "lib.so", [d / "merge.cu", d / "common.cu"])[1]


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A variant's library with its C entries declared: this design's, or the
    first design's entry (no scratch argument)."""
    if hasattr(lib, "arrow_merge_scratch_bytes"):
        return M.declare(lib)
    lib.arrow_merge_pass.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.arrow_merge_pass.restype = ctypes.c_int
    return lib


def build_all(baseline, only=None) -> dict:
    names = [*(only or VARIANTS), *(["baseline"] if baseline else [])]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(lambda name: build_variant(name, baseline), names)))
    libs = {}
    for name, log in logs.items():
        # registers, shared memory and spills of each kernel of the variant
        regs, entry = [], None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                entry = m.group(1)[-32:]
            elif entry and "Used" in ln:
                regs.append(f"{entry} {ln.split('Used')[1].split(',')[0].strip()}")
            elif entry and "spill" in ln and "0 bytes spill stores" not in ln:
                regs.append(f"{entry} {ln.strip()}")
        print(f"{name}: {'; '.join(regs)}")
        libs[name] = declare(ctypes.CDLL(str(OUT / name / "lib.so")))
    return libs


def launcher(lib, call, outs):
    """One variant's C entry on fixed arguments (planes, run_len, unique),
    writing to `outs` (shared by the variants)."""
    planes, run_len, unique = call
    n, k = planes[0].shape[0], len(planes)
    stream = torch.cuda.current_stream().cuda_stream
    ins_p = (ctypes.c_void_p * k)(*[p.data_ptr() for p in planes])
    outs_p = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    if hasattr(lib, "arrow_merge_scratch_bytes"):
        scratch = torch.empty(lib.arrow_merge_scratch_bytes(n, run_len), dtype=torch.uint8, device="cuda")
        extra = (scratch.data_ptr(),)
    else:
        extra = ()

    def run():
        err = lib.arrow_merge_pass(ins_p, outs_p, k, n, run_len, int(unique), *extra, stream)
        if err:
            raise RuntimeError(f"the C entry returned {err}")
        return outs

    return run


def event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def time_call(label, call, libs, smi) -> None:
    planes, run_len, unique = call
    want = M.merge_pass_cuda(*call)
    outs = [torch.empty_like(w) for w in want]
    fns = {name: launcher(lib, call, outs) for name, lib in libs.items()}
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        if not name.startswith("x-") and not CS._exact(got, want)[0]:
            raise RuntimeError(f"{name} differs from the port's build on {label}")
    del want, got
    fns["torch.sort"] = CS.library_call("merge_pass", call)
    fns["clone"] = lambda: [p.clone() for p in planes]  # the same bytes, read and written in order
    for fn in fns.values():  # warm-up
        fn()
    samples = {name: [] for name in fns}
    for _ in range(REPS):
        for name, fn in fns.items():
            samples[name].append(event_ms(fn))
    bound_ms = CS.call_bytes("merge_pass", call) / HBM_BYTES_PER_S * 1e3
    times = "; ".join(f"{name} {statistics.median(v):.4f} ms ({bound_ms / statistics.median(v):.2f})"
                      for name, v in samples.items())
    print(f"{label}: {len(planes)} int32 planes, n={planes[0].shape[0]}, run_len={run_len}"
          f"{', unique payload' if unique else ''}: bound {bound_ms:.4f} ms; {times} ({smi})", flush=True)


def sort_join_calls():
    """(label, B7 call) for each B7 call of the sort-join query at QUERY_N rows."""
    batch = flagship.make_batch(QUERY_N, 0, "cuda")
    with CS.recorded_calls() as calls:
        out = flagship.sort_join_query(batch)
        torch.cuda.synchronize()
    del out, batch
    for label, args in zip(("sort_join expand", "sort_join rank fill"), calls["merge_pass"]):
        yield label, args
    del calls
    torch.cuda.empty_cache()


def random_runs(n, run_len, gen):
    """Random int32 keys sorted in runs of run_len rows, with their row ids."""
    key = torch.randint(-(2**31), 2**31, (n,), generator=gen, device="cuda", dtype=torch.int64).to(torch.int32)
    k, order = torch.sort(key.view(-1, run_len), dim=1, stable=True)
    return [k.reshape(-1), order.reshape(-1).to(torch.int32) + torch.arange(
        0, n, run_len, device="cuda", dtype=torch.int32).repeat_interleave(run_len)]


def shaped_calls(gen):
    n = QUERY_N
    for run_len in (8192, n // 2):
        yield f"merge route pass, runs of {run_len}", (random_runs(n, run_len, gen), run_len, True)
    planes = random_runs(n, n // 2, gen)
    extra = [torch.randint(-(2**31), 2**31, (n,), generator=gen, device="cuda", dtype=torch.int64)
             .to(torch.int32) for _ in range(M.MAX_PLANES - 2)]
    yield "8 planes, one pair", ([*planes, *extra], n // 2, False)
    del extra
    yield "one plane, one pair", ([planes[0]], n // 2, False)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", help="another merge.cu, timed beside")
    parser.add_argument("--quick", action="store_true", help="the sort-join's two calls only")
    parser.add_argument("--only", help="comma-separated variants to build and time (default: all)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("merge_tile_shapes: needs a CUDA card", file=sys.stderr)
        return 2
    smi = CS.smi_line()
    print(smi)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the port's own build beside the variants'
        port = pool.submit(_build.load)
        libs = build_all(opts.baseline, opts.only.split(",") if opts.only else None)
        port.result()
    for label, call in sort_join_calls():
        time_call(label, call, libs, smi)
        del call
    if not opts.quick:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        for label, call in shaped_calls(gen):
            time_call(label, call, libs, smi)
            del call
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
