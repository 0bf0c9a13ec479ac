"""The redesigned probe kernels against other designs of theirs, timed in
turns on one card.

    python -m arrow_tpu_torch.tools.probe_designs [--labels LABEL ...] [--rounds N] [--sass]

``grid_1d_blockspec``, ``matmul_int8_s32acc``, ``dynamic_slice_vmem_rows``,
``dma_unaligned_row_write``, ``dma_unaligned_row_offset``,
``prefetch_scalar_grid``, ``transpose_32b_128x128``, ``hbm_to_hbm_dma`` and
``bitcast_f32_u32`` (``csrc/mosaic_probe.cu``), and the merge step in its
two forms, ``mb_step_rollpair`` and ``mb_step_taa`` (``csrc/probe_r4.cu``),
are laid out for the card.  Each other design is a variant of the kernel's
source, built into a library of its own under
``build/arrow_tpu_torch/designs/`` (the port's nvcc flags, one process a
design, all started together):

- ``earlier``: the source before the kernel's redesign, where the checkout
  holds it as ``build/parent/<commit>/arrow_tpu_torch/csrc/<source>`` for
  the kernel's commit in ``BEFORE`` (unpacked from git as the README says;
  not measured otherwise).  ``dma_unaligned_row_write``'s earlier design
  wrote only the window, into an output that its wrapper zeroed first: that
  fill is part of its call and of its time;
- ``staging``: the int8 product with its wgmma call cut out, whose output is
  then the zeroed accumulators: the staging and the stores alone;
- ``tile64``, ``tile128``: the int8 product in output tiles of 64 x 64 and
  64 x 128 (4 and 2 blocks) in place of 64 x 32 (8 blocks);
- ``window``: the row slice reading s first and then only the window's 8
  rows (two round trips), in place of every row at once (one);
- ``bulk``: the row write sending the window out as a bulk copy a block,
  shared to global, in place of 16-byte stores;
- ``bulk_in``: the row-offset copy bringing each block's 8 rows into
  shared memory by one bulk copy on an mbarrier, in place of the row
  slice's kernel (16-byte loads of every row with s);
- ``one_block``: the scalar add in one block of 512 threads, in place of
  the JAX grid's two blocks of 256;
- ``quads``, ``quads256``: the transpose as 4 x 4 blocks swapped between
  the lanes of a quad by warp shuffles, in 32 blocks of 128 threads or 16
  of 256, in place of a 32 x 32 tile a block in shared memory (16-byte
  loads and stores, one barrier);
- ``staged``: the HBM-to-HBM copy as a bulk copy into shared memory and one
  back out, in place of a 16-byte load and store a thread;
- ``warp_rows``: that copy's (and the bitcast's, the same kernel's)
  16-byte loads and stores in 8 blocks of one warp, a warp a row, in place
  of one block of 256 threads;
- ``exchange``: the merge step cleaning its stages of distance 8-1 in
  registers after a second exchange through shared memory, in place of
  between lanes by ``__shfl_xor_sync``.

Every design but ``staging`` is first held to the plain version on the
probe's inputs, a row window's at every legal s on random rows, the
scalar add's on full-range rows and scalars, where the sum wraps, the
transpose's, the copy's and the bitcast's on a full-range random tile, and
the merge step's (one block) on keys in [0, 100) with many ties, on
full-range keys and on all INT_MIN against all INT_MAX, each at R = 0, 1
and 5.  Then each kernel is timed in turns: plain, new, library, new, a
design, new, the next design, new, ...; device ms a call, queued behind a
spin kernel (:func:`arrow_tpu_torch.utils.timing.queued_seconds_per_call`),
beside an empty kernel's; the library call is
:func:`mosaic_probe.library_call`'s (``x + 1``, ``torch._int_mm``, a slice's
``clone``, ``F.pad``, ``x + s``, ``t().contiguous()``).  The merge step has
no library call, and its plain version reads R on the host, so it is timed
new, a design, new, ...: the probe's call at R = 3, and us a step on one
block from the slope between two R (:func:`probe_r4.us_per_step`), beside
one SM's floor for a step (its operations over one SM's integer rate).
``chip_smoke.py``'s ``probes`` phase runs the same.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..compute.kernels import _build
from . import mosaic_probe as MP
from . import probe_r4 as PR
from .common import gpu_line

SOURCE = _build.CSRC_DIR / "mosaic_probe.cu"
R4_SOURCE = _build.CSRC_DIR / "probe_r4.cu"
PARENT = _build.BUILD_DIR.parent / "parent"
# the commit before each kernel's redesign, whose source is its earlier design
BEFORE = {"grid_1d_blockspec": "9d785cc", "matmul_int8_s32acc": "9d785cc",
          "dynamic_slice_vmem_rows": "70dca0e", "dma_unaligned_row_write": "70dca0e",
          "dma_unaligned_row_offset": "829306e", "prefetch_scalar_grid": "829306e",
          "transpose_32b_128x128": "9f34100", "hbm_to_hbm_dma": "9f34100",
          "bitcast_f32_u32": "aeb9ac2", "mb_step_rollpair": "aeb9ac2", "mb_step_taa": "aeb9ac2"}
REDESIGNED = tuple(BEFORE)
FILLED_BEFORE = ("dma_unaligned_row_write",)  # earlier designs that wrote into an output zeroed by the wrapper
# a window at device row s in [0, 56]
WINDOWED = ("dynamic_slice_vmem_rows", "dma_unaligned_row_write", "dma_unaligned_row_offset")
WRAPPED = ("prefetch_scalar_grid",)  # an int32 sum that wraps
FULL_RANGE = ("transpose_32b_128x128", "hbm_to_hbm_dma", "bitcast_f32_u32")  # held on a full-range random tile too
STEP_HELD_R = (0, 1, 5)  # the merge steps' R on the held inputs beyond the probe's
OUT_DIR = _build.BUILD_DIR / "designs"
BUF_ROWS = PR.BUF // MP.LANES  # rows of 128 of each merge-step input
PRODUCT_CALL = "  wgmma_product(d, sa, sb);\n"
TILE = 32  # the source's output columns a block (kTileN)
WRAPPER_START = "__device__ __forceinline__ void wgmma_m64nNk32("
SLICE_EVERY_ROW = "constexpr bool kSliceEveryRow = true;"
WRITE_BULK = "constexpr bool kWriteBulk = false;"
OFFSET_BULK = "constexpr bool kOffsetBulk = false;"
SCALAR_ONE_BLOCK = "constexpr bool kScalarOneBlock = false;"
TRANSPOSE_SHARED = "constexpr bool kTransposeShared = true;"
TRANSPOSE_THREADS = "constexpr int kTransposeThreads = 128;"
HBM_BULK = "constexpr bool kHbmBulk = false;"
HBM_THREADS = "constexpr int kHbmThreads = 256;"
STEP_SHUFFLE = "constexpr bool kStepShuffle = true;"
SASS_KERNELS = ("merge_step", "copy_rows_direct", "bitcast_f32")  # the kernels whose SASS --sass counts
SASS_OPS = ("BAR.SYNC", "LDS", "STS", "SHFL", "LDG", "STG", "ISETP", "SEL")
SASS_LINE = re.compile(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")  # an instruction's opcode
# the designs that each kernel is timed against, in their turn's order
TURNS = {"grid_1d_blockspec": ("earlier",), "matmul_int8_s32acc": ("earlier", "staging", "tile64", "tile128"),
         "dynamic_slice_vmem_rows": ("earlier", "window"), "dma_unaligned_row_write": ("earlier", "bulk"),
         "dma_unaligned_row_offset": ("earlier", "bulk_in"), "prefetch_scalar_grid": ("earlier", "one_block"),
         "transpose_32b_128x128": ("earlier", "quads", "quads256"),
         "hbm_to_hbm_dma": ("earlier", "staged", "warp_rows"), "bitcast_f32_u32": ("earlier", "warp_rows"),
         "mb_step_rollpair": ("earlier", "exchange"), "mb_step_taa": ("earlier", "exchange")}


def wgmma_wrapper(n: int) -> str:
    """The source's wgmma wrapper for output tiles n columns wide
    (m64n{n}k32, n / 2 accumulators a thread)."""
    regs = n // 2
    rows = [", ".join(f"%{i}" for i in range(j, min(j + 16, regs))) for j in range(0, regs, 16)]
    outs = [", ".join(f'"+r"(d[{i}])' for i in range(j, min(j + 8, regs))) for j in range(0, regs, 8)]
    return (f"{WRAPPER_START}int32_t (&d)[kTileN / 2], uint64_t desc_a, uint64_t desc_b) {{\n"
            f"  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "\n'
            f'      "{{"\n'
            + ",\"\n".join(f'      "{r}' for r in rows) + '},"\n'
            f'      " %{regs}, %{regs + 1}, p;\\n}}\\n"\n'
            f"      :\n"
            + ",\n".join(f"        {o}" for o in outs) + "\n"
            f'      : "l"(desc_a), "l"(desc_b), "r"(1));\n'
            f"}}\n")


def _once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the source: {old.strip()[:60]!r} is not there once")
    return text.replace(old, new)


def _tile(text: str, n: int) -> str:
    """The source with output tiles n columns wide."""
    text = _once(text, wgmma_wrapper(TILE), wgmma_wrapper(n))
    return _once(text, f"constexpr int kTileN = {TILE};", f"constexpr int kTileN = {n};")


def probe_of(label: str) -> MP.Probe:
    return MP.BY_LABEL.get(label) or PR.BY_NAME[label]


def source_of(label: str) -> pathlib.Path:
    """The source that holds `label`'s kernel."""
    return R4_SOURCE if label in PR.BY_NAME else SOURCE


def earlier_source(label: str) -> pathlib.Path:
    """Where the checkout holds the source before `label`'s redesign."""
    return PARENT / BEFORE[label] / "arrow_tpu_torch" / "csrc" / source_of(label).name


def library_name(label: str, design: str) -> str:
    """The name of the library that holds `label`'s `design`: the earlier
    designs by commit and source, the rest by their own name."""
    return f"earlier_{BEFORE[label]}_{source_of(label).stem}" if design == "earlier" else design


def design_sources() -> Dict[str, str]:
    """Each design's source, by library name (the earlier ones where the
    checkout holds them)."""
    text = SOURCE.read_text()
    quads = _once(text, TRANSPOSE_SHARED, TRANSPOSE_SHARED.replace("true", "false"))
    designs = {"staging": _once(text, PRODUCT_CALL, ""), "tile64": _tile(text, 64), "tile128": _tile(text, 128),
               "window": _once(text, SLICE_EVERY_ROW, SLICE_EVERY_ROW.replace("true", "false")),
               "bulk": _once(text, WRITE_BULK, WRITE_BULK.replace("false", "true")),
               "bulk_in": _once(text, OFFSET_BULK, OFFSET_BULK.replace("false", "true")),
               "one_block": _once(text, SCALAR_ONE_BLOCK, SCALAR_ONE_BLOCK.replace("false", "true")),
               "quads": quads,
               "quads256": _once(quads, TRANSPOSE_THREADS, TRANSPOSE_THREADS.replace("128", "256")),
               "staged": _once(text, HBM_BULK, HBM_BULK.replace("false", "true")),
               "warp_rows": _once(text, HBM_THREADS, HBM_THREADS.replace("256", "32")),
               "exchange": _once(R4_SOURCE.read_text(), STEP_SHUFFLE, STEP_SHUFFLE.replace("true", "false"))}
    for label in REDESIGNED:
        if earlier_source(label).is_file():
            designs[library_name(label, "earlier")] = earlier_source(label).read_text()
    return designs


def build() -> Tuple[Dict[str, ctypes.CDLL], float]:
    """Build every design (one nvcc process each, all started together) and
    load it; returns (libraries by name, wall seconds)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in design_sources().items():
        src = OUT_DIR / f"{name}.cu"
        src.write_text(text)
        jobs[name] = (OUT_DIR / f"lib_{name}.so", src)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        for done in [pool.submit(_build.build_library, lib, [src]) for lib, src in jobs.values()]:
            done.result()
    return {name: ctypes.CDLL(str(lib)) for name, (lib, _) in jobs.items()}, time.perf_counter() - t0


def design_call(lib: ctypes.CDLL, probe: MP.Probe, zeroed: bool = False) -> Callable[..., torch.Tensor]:
    """`lib`'s C entry of the probe as a call on the probe's inputs into a new
    output, as the probe's wrapper makes it (one block for a merge step; no
    launch counted); `zeroed`: the output is zeroed first, as the wrapper of
    a design that writes part of it did."""
    fn = getattr(lib, f"arrow_probe_{probe.label}")
    counts = (1,) if probe.blocked else ()
    fn.argtypes = [ctypes.c_void_p] * (len(probe.inputs()) + 1) + [ctypes.c_int] * len(counts) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(*args):
        out = (torch.zeros if zeroed else torch.empty)(probe.shape, dtype=probe.dtype, device=args[0].device)
        err = fn(*[a.data_ptr() for a in args], out.data_ptr(), *counts, _build.stream_of(out))
        _build.check(err, probe.label)
        return out

    return call


def design_entries(libs: Dict[str, ctypes.CDLL], label: str) -> Dict[str, Callable[..., torch.Tensor]]:
    """Calls of `label`'s designs that were built, by design name; an earlier
    design that wrote part of the output gets a zeroed one."""
    return {name: design_call(libs[library_name(label, name)], probe_of(label),
                              zeroed=name == "earlier" and label in FILLED_BEFORE)
            for name in TURNS.get(label, ()) if library_name(label, name) in libs}


def design_calls(libs: Dict[str, ctypes.CDLL], label: str, args) -> Dict[str, Callable[[], torch.Tensor]]:
    """Calls of `label`'s designs that were built, on `args`, by design name."""
    return {name: functools.partial(fn, *args) for name, fn in design_entries(libs, label).items()}


def queued_ms(fn: Callable, what: str) -> float:
    from ..utils.timing import queued_seconds_per_call

    s = queued_seconds_per_call(fn)
    if s is None:
        raise RuntimeError(f"{what}: the host does not get ahead of the device")
    return s * 1e3


def _full_range(shape, device) -> torch.Tensor:
    """Random int32 values over the whole range, the same at every call."""
    return torch.from_numpy(np.random.default_rng(15).integers(-2 ** 31, 2 ** 31, shape, np.int32)).to(device)


def step_pairs(device) -> Dict[str, torch.Tensor]:
    """The merge step's (A, B) pairs beyond the probe's, stacked: keys in
    [0, 100) with many ties, full-range keys, all INT_MIN against all
    INT_MAX."""
    shape = (2, BUF_ROWS, MP.LANES)
    ends = torch.tensor([-2 ** 31, 2 ** 31 - 1], dtype=torch.int32)[:, None, None].expand(shape)
    return {"ties": torch.from_numpy(np.random.default_rng(18).integers(0, 100, shape, np.int32)).to(device),
            "full range": _full_range(shape, device), "ends": ends.contiguous().to(device)}


def held_inputs(probe: MP.Probe, device) -> Iterator[List[torch.Tensor]]:
    """The inputs each design is held to the plain version on: the probe's;
    for a row window every legal s on full-range random rows; for the scalar
    add full-range rows with a scalar at either end of the int32 range; for
    the transpose, the copy and the bitcast a full-range random tile; for
    the merge steps each of ``step_pairs`` at each R of STEP_HELD_R."""
    yield MP.inputs_on(probe, device)
    if probe.label in PR.MERGE_STEPS:
        for a, b in step_pairs(device).values():
            for r in STEP_HELD_R:
                yield [torch.full((1,), r, dtype=torch.int32, device=device), a, b]
    if probe.label in FULL_RANGE:
        (tile,) = probe.inputs()  # the bitcast's float tile as the bits of full-range int32s
        yield [_full_range(tile.shape, device).view(torch.from_numpy(tile).dtype)]
    if probe.label in WINDOWED + WRAPPED:
        rows = _full_range(probe.inputs()[1].shape, device)
        for s in range(64 - 8 + 1) if probe.label in WINDOWED else (2 ** 31 - 3, -2 ** 31 + 3):
            yield [torch.full((1,), s, dtype=torch.int32, device=device), rows]


def _in_turns(times: List[Tuple[str, float]], digits: int) -> str:
    """The turns, then each design's median over new's (plain left out)."""
    medians = {name: statistics.median(t for n, t in times if n == name) for name, _ in times}
    ratios = ", ".join(f"{name} {t / medians['new']:.3f}" for name, t in medians.items()
                       if name not in ("new", "plain"))
    return ", ".join(f"{name} {t:.{digits}f}" for name, t in times) + f"; over new's median: {ratios}"


def run(device, log: Callable[[str], None] = print, labels=REDESIGNED, rounds: int = 1) -> Dict[str, list]:
    """Build the designs, hold `labels`' designs to the plain versions and
    time them in turns on `device`, the turns `rounds` times over; logs a
    line a kernel (and for a merge step a second, us a step) and returns its
    (name, ms) turns by label (and the merge steps' (name, us a step) turns
    by "<label> us_per_step")."""
    libs, seconds = build()
    missing = sorted({str(earlier_source(label)) for label in REDESIGNED
                      if library_name(label, "earlier") not in libs})
    log(f"built the designs {sorted(libs)} in {seconds:.1f} s"
        + (f"; not measured, the earlier designs in {missing} (not there)" if missing else ""))
    empty_ms = queued_ms(lambda: MP.empty_launch(device), "an empty kernel")
    result = {}
    for label in labels:
        probe = probe_of(label)
        for args in held_inputs(probe, device):
            want = MP.plain(probe, *args)
            for name, fn in {"new": lambda: MP.launch(probe, *args), **design_calls(libs, label, args)}.items():
                if name != "staging" and not torch.equal(fn(), want):
                    raise RuntimeError(f"{label}: the {name} design disagrees with the plain version "
                                       f"on inputs {[a.flatten()[:4].tolist() for a in args]}")
        args = MP.inputs_on(probe, device)
        fns = {"plain": lambda: MP.plain(probe, *args), "new": lambda: MP.launch(probe, *args),
               "library": MP.library_call(label, args), **design_calls(libs, label, args)}
        # a merge step's plain version reads R on the host, and it has no library call
        turns = ["new"] if label in PR.MERGE_STEPS else ["plain", "new", "library", "new"]
        for name in TURNS[label]:
            turns += [name, "new"] if name in fns else []
        turns *= rounds
        times = [(name, queued_ms(fns[name], f"{label}, {name}")) for name in turns]
        log(f"{label}, designs in turns, device ms a call (queued): {_in_turns(times, 5)}; "
            f"an empty kernel {empty_ms:.5f}")
        result[label] = times
        if label in PR.MERGE_STEPS:
            _, a, b = args
            calls = {"new": functools.partial(MP.launch, probe), **design_entries(libs, label)}
            steps = [(name, PR.us_per_step(lambda r, call=calls[name]: call(r, a, b), device, PR.STEPS))
                     for name in turns]
            log(f"{label}, designs in turns, us a step on one block (slope of R = {PR.STEPS[0]} to "
                f"{PR.STEPS[1]}): {_in_turns(steps, 3)}; {PR.sm_floor_line()}")
            result[f"{label} us_per_step"] = steps
    return result


def sass_counts(library: pathlib.Path) -> Dict[str, Dict[str, int]]:
    """Instructions by opcode (SASS_OPS, any suffix) and in all ("all") of
    each kernel in `library` whose name holds one of SASS_KERNELS, from
    ``cuobjdump -sass`` (the CUDA toolkit's), by mangled name."""
    tool = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            current = counts.setdefault(name, dict.fromkeys((*SASS_OPS, "all"), 0)) if any(
                k in name for k in SASS_KERNELS) else None
            continue
        # "        /*0090*/                   @!P0 LDS.64 R4, [R2+0x10] ;"
        op = SASS_LINE.match(line) if current is not None else None
        if op:
            current["all"] += 1
            for k in SASS_OPS:
                current[k] += op.group(1) == k or op.group(1).startswith(k + ".")
    return counts


def main(argv=None) -> int:
    import argparse

    from ..parallel.dryrun import device_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", action="store_true",
                    help="also print the SASS counts of the merge step's and the copy's kernels in each library")
    ap.add_argument("--labels", nargs="+", choices=REDESIGNED, default=REDESIGNED, help="the kernels (default: all)")
    ap.add_argument("--rounds", type=int, default=1, help="time each kernel's turns this many times over")
    args = ap.parse_args(argv)
    device = torch.device(device_name(None))
    if device.type != "cuda":
        print("probe_designs: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, device: {device} ({torch.cuda.get_device_name(device)}; {gpu_line()})")
    run(device, labels=args.labels, rounds=args.rounds)
    if args.sass:
        for lib in [_build.load().path, *sorted(OUT_DIR.glob("lib_*.so"))]:
            for name, ops in sass_counts(lib).items():
                print(f"SASS of {name} in {lib.name}: {ops}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
