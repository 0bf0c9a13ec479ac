"""The redesigned probe kernels against other designs of theirs, timed in
turns on one card.

    python -m arrow_tpu_torch.tools.probe_designs [--labels LABEL ...] [--rounds N] [--sass]

``grid_1d_blockspec``, ``matmul_int8_s32acc``, ``dynamic_slice_vmem_rows``,
``dma_unaligned_row_write``, ``dma_unaligned_row_offset``,
``prefetch_scalar_grid``, ``transpose_32b_128x128``, ``hbm_to_hbm_dma``,
``bitcast_f32_u32``, ``cumsum_sublanes_f32``, the sublane gather
``gather_sublanes_taa_axis0``, the sized copy ``dma_dynamic_size_rows``,
the row store ``dynamic_store_vmem_rows`` (whose C entry launches the row
write's ``write_rows``), the in-row sort ``lax_sort_in_kernel``, the lane
cumsum ``cumsum_lanes_i32`` and the lane gather ``gather_lanes`` behind
its four probes (:data:`GATHER_LANES`) (``csrc/mosaic_probe.cu``),
and the merge step in its two forms, ``mb_step_rollpair`` and
``mb_step_taa``, and the mask matmul ``i1_to_bf16_astype``
(``csrc/probe_r4.cu``), are laid out for the card.  Each other design is a variant of the kernel's
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
  ``mask_staging``: the mask matmul with its product (ldmatrix and mma.sync)
  cut out the same way (an empty asm that takes the band's address stands
  in, so that the band's stores are kept): the loads, the compares and the
  stores alone, the floor of its function on the card (it has no library
  call);
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
  between lanes by ``__shfl_xor_sync``;
- ``cumsum_staged``: the column cumsum through a tile in shared memory
  (16-byte loads, a barrier, the adds in place, 16-byte stores), in place of
  a thread's 64 rows in registers; ``cumsum_block``: the register design in
  one block of 128 threads, in place of 4 blocks of 32;
- ``direct``: the sublane gather without shared memory, each thread loading
  its 16 bytes of idx and then x at the 4 gathered rows (a second,
  dependent round trip), in place of a 16-column stripe a block through
  shared memory with x and idx loaded together;
- ``count_first``: the sized copy loading s and then only the rows below
  it (two round trips), in place of every row loaded with s (one);
- ``eight_a_lane``: the in-row sort with 16 lanes a row, 8 consecutive
  elements a lane (two 16-byte loads), two rows a warp in 4 blocks of one
  warp (18 stages between a lane's registers, 10 by shuffles of width 16),
  in place of a warp a row, 4 elements a lane, in 8 blocks (13 stages in
  registers, 15 by shuffles);
- ``warp_blocks``: the lane cumsum in 8 blocks of one warp, in place of
  one block of 8 warps;
- ``row_staged``: the lane gather through the warp's row in shared memory
  (16-byte stores, a ``__syncwarp``, 4 reads), in place of each output
  shuffled from the lane that holds it (W / 32 ``__shfl_sync`` and selects
  an output).

Every design but ``staging`` is first held to the plain version on the
probe's inputs, a row window's (the row store's too) at every legal s on
full-range random rows, the scalar add's on full-range rows and scalars,
where the sum wraps, the transpose's, the copy's and the bitcast's on a
full-range random tile, the sublane gather's on a full-range random tile
with each of :func:`gather_indices`, the sized copy's at every s from -1 to
65 (the clamp's both sides) on full-range random rows, and the merge step's
(one block) on keys in [0, 100) with many ties, on full-range keys and on
all INT_MIN against all INT_MAX, each at R = 0, 1 and 5, the column cumsum's
bit for bit on an order-sensitive tile (:func:`ordered_tile`) and on
normals, the mask matmul's on every row count from 0 to 128
(:func:`count_tiles`), the in-row sort's on each of :func:`sort_tiles`, the
lane cumsum's on a full-range random tile, where the sum wraps, and on each
of :func:`one_hot_tiles`, and the lane gathers' on a full-range random x
(float32 of full-range bits for ``gather_lanes_f32``) with each of
:func:`lane_indices`.
Then each kernel is timed in turns: plain, new, library, new, a design, new,
the next design, new, ...; device ms a call, queued behind a spin kernel
(:func:`arrow_tpu_torch.utils.timing.queued_seconds_per_call`), beside an
empty kernel's; the library call is :func:`mosaic_probe.library_call`'s
(``x + 1``, ``torch._int_mm``, a slice's ``clone``, ``F.pad``, ``x + s``,
``t().contiguous()``, ``torch.cumsum``, ``torch.take_along_dim``,
``torch.sort``); a kernel without one (the mask matmul) is timed plain, new,
a design, new, .... The merge step has no library call, and its plain
version reads R on the host, so it is timed new, a design, new, ...: the
probe's call at R = 3, and us a step on one block from the slope between two
R (:func:`probe_r4.us_per_step`), beside one SM's floor for a step (its
operations over one SM's integer rate).
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
          "bitcast_f32_u32": "aeb9ac2", "mb_step_rollpair": "aeb9ac2", "mb_step_taa": "aeb9ac2",
          "cumsum_sublanes_f32": "9e5ff2a", "i1_to_bf16_astype": "9e5ff2a",
          "gather_sublanes_taa_axis0": "81001b6", "dma_dynamic_size_rows": "81001b6",
          "dynamic_store_vmem_rows": "dfc6a14", "lax_sort_in_kernel": "dfc6a14",
          "cumsum_lanes_i32": "a5e35e7", "gather_lanes_taa_8x128_i32": "a5e35e7",
          "gather_lanes_taa_256x128_i32": "a5e35e7", "gather_lanes_f32": "a5e35e7",
          "gather_lanes_256wide_2gathers": "a5e35e7"}
REDESIGNED = tuple(BEFORE)
# the probes that launch the lane gather gather_lanes<W, Warps>
GATHER_LANES = ("gather_lanes_taa_8x128_i32", "gather_lanes_taa_256x128_i32", "gather_lanes_f32",
                "gather_lanes_256wide_2gathers")
FILLED_BEFORE = ("dma_unaligned_row_write",)  # earlier designs that wrote into an output zeroed by the wrapper
# a window at device row s in [0, 56]
WINDOWED = ("dynamic_slice_vmem_rows", "dma_unaligned_row_write", "dma_unaligned_row_offset",
            "dynamic_store_vmem_rows")
WRAPPED = ("prefetch_scalar_grid",)  # an int32 sum that wraps
FULL_RANGE = ("transpose_32b_128x128", "hbm_to_hbm_dma", "bitcast_f32_u32")  # held on a full-range random tile too
SIZED_HELD = range(-1, 64 + 2)  # the sized copy's s on the held inputs: every row count and the clamp's both sides
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
CUMSUM_STAGED = "constexpr bool kCumsumStaged = false;"
CUMSUM_THREADS = "constexpr int kCumsumThreads = 32;"
GATHER_DIRECT = "constexpr bool kGatherDirect = false;"
SIZED_COUNT_FIRST = "constexpr bool kSizedCountFirst = false;"
SORT_EIGHT_A_LANE = "constexpr bool kSortEightALane = false;"
CUMSUM_LANES_GRID = "constexpr bool kCumsumLanesGrid = false;"
GATHER_SHUFFLE = "constexpr bool kGatherShuffle = true;"
MASK_PRODUCT_CALL = "  mask_product(c, sa, lane);\n"
# in its place in mask_staging: the band's address escapes, so its stores (and the loads and compares) stay
MASK_STAGING_STANDIN = '  asm volatile("" : : "r"(sa) : "memory");\n'
STAGING = ("staging", "mask_staging")  # designs with a part cut out: timed, not held to the plain version
# the kernels whose SASS --sass counts
SASS_KERNELS = ("merge_step", "copy_rows_direct", "bitcast_f32", "cumsum_rows", "mask_matmul", "gather_stripe",
                "gather_direct", "gather_sublanes", "copy_rows_sized", "sort_rows", "write_rows", "store_rows",
                "cumsum_lanes", "gather_lanes")
SASS_OPS = ("BAR.SYNC", "LDS", "STS", "SHFL", "LDG", "STG", "ISETP", "SEL", "FADD", "HMMA")
# LDGs counted after the first of these in a kernel: "late LDG" after its first FADD or HMMA (loads behind
# its arithmetic), "LDG after BAR.SYNC" after its first barrier (loads behind it), "LDG after SHFL, STS or
# STG" after its first shuffle or store (loads behind a value the warp passes on)
LATE = {"late LDG": ("FADD", "HMMA"), "LDG after BAR.SYNC": ("BAR.SYNC",),
        "LDG after SHFL, STS or STG": ("SHFL", "STS", "STG")}
SASS_LINE = re.compile(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")  # an instruction's opcode
# the designs that each kernel is timed against, in their turn's order
TURNS = {"grid_1d_blockspec": ("earlier",), "matmul_int8_s32acc": ("earlier", "staging", "tile64", "tile128"),
         "dynamic_slice_vmem_rows": ("earlier", "window"), "dma_unaligned_row_write": ("earlier", "bulk"),
         "dma_unaligned_row_offset": ("earlier", "bulk_in"), "prefetch_scalar_grid": ("earlier", "one_block"),
         "transpose_32b_128x128": ("earlier", "quads", "quads256"),
         "hbm_to_hbm_dma": ("earlier", "staged", "warp_rows"), "bitcast_f32_u32": ("earlier", "warp_rows"),
         "mb_step_rollpair": ("earlier", "exchange"), "mb_step_taa": ("earlier", "exchange"),
         "cumsum_sublanes_f32": ("earlier", "cumsum_staged", "cumsum_block"),
         "i1_to_bf16_astype": ("earlier", "mask_staging"),
         "gather_sublanes_taa_axis0": ("earlier", "direct"),
         "dma_dynamic_size_rows": ("earlier", "count_first"),
         "dynamic_store_vmem_rows": ("earlier",), "lax_sort_in_kernel": ("earlier", "eight_a_lane"),
         "cumsum_lanes_i32": ("earlier", "warp_blocks"),
         **{label: ("earlier", "row_staged") for label in GATHER_LANES}}


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
    text, r4 = SOURCE.read_text(), R4_SOURCE.read_text()
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
               "exchange": _once(r4, STEP_SHUFFLE, STEP_SHUFFLE.replace("true", "false")),
               "cumsum_staged": _once(text, CUMSUM_STAGED, CUMSUM_STAGED.replace("false", "true")),
               "cumsum_block": _once(text, CUMSUM_THREADS, CUMSUM_THREADS.replace("32", "128")),
               "mask_staging": _once(r4, MASK_PRODUCT_CALL, MASK_STAGING_STANDIN),
               "direct": _once(text, GATHER_DIRECT, GATHER_DIRECT.replace("false", "true")),
               "count_first": _once(text, SIZED_COUNT_FIRST, SIZED_COUNT_FIRST.replace("false", "true")),
               "eight_a_lane": _once(text, SORT_EIGHT_A_LANE, SORT_EIGHT_A_LANE.replace("false", "true")),
               "warp_blocks": _once(text, CUMSUM_LANES_GRID, CUMSUM_LANES_GRID.replace("false", "true")),
               "row_staged": _once(text, GATHER_SHUFFLE, GATHER_SHUFFLE.replace("true", "false"))}
    for label in REDESIGNED:
        if earlier_source(label).is_file():
            designs[library_name(label, "earlier")] = earlier_source(label).read_text()
    return designs


def build(names=None) -> Tuple[Dict[str, ctypes.CDLL], float]:
    """Build every design, or those in `names` (one nvcc process each, all
    started together) and load it, nvcc's report (registers, stack, spills)
    beside it as ``<name>.log``; returns (libraries by name, wall seconds)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in design_sources().items():
        if names is not None and name not in names:
            continue
        src = OUT_DIR / f"{name}.cu"
        src.write_text(text)
        jobs[name] = (OUT_DIR / f"lib_{name}.so", src)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        builds = {name: pool.submit(_build.build_library, lib, [src]) for name, (lib, src) in jobs.items()}
        for name, done in builds.items():
            (OUT_DIR / f"{name}.log").write_text(done.result()[1])
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


def ordered_tile() -> np.ndarray:
    """A (64, 128) float32 tile on which the order of a column's adds shows:
    each column mixes +-1e8 with values near 1 (1e8 + 1 rounds back to 1e8
    in float32) in rows 0-47, and holds +inf, -inf and NaN at rows of its
    own among 48-63."""
    rng = np.random.default_rng(19)
    tile = (1 + 1e-3 * rng.standard_normal((64, MP.LANES))).astype(np.float32)
    big = rng.random(tile.shape) < 0.25
    tile[big] = rng.choice(np.float32([1e8, -1e8]), int(big.sum()))
    for c in range(MP.LANES):
        tile[48 + rng.permutation(16)[:3], c] = [np.inf, -np.inf, np.nan]
    return tile


def count_tiles() -> List[np.ndarray]:
    """Two (128, 128) int32 tiles whose rows have every count of positive
    entries from 0 to 128 (0-127 in the first, 1-128 in the second, the rows
    shuffled): the positives 1, INT_MAX or drawn from [1, 2^31), the rest 0,
    -1, INT_MIN or drawn from [-2^31, 0), so that > 0 is held at its edge."""
    rng = np.random.default_rng(19)
    shape = (MP.LANES, MP.LANES)
    pos = np.where(rng.random(shape) < 0.5, rng.choice([1, 2 ** 31 - 1], shape), rng.integers(1, 2 ** 31, shape))
    neg = np.where(rng.random(shape) < 0.6, rng.choice([0, -1, -2 ** 31], shape), rng.integers(-2 ** 31, 0, shape))
    tiles = []
    for first in (0, 1):
        counts = rng.permutation(np.arange(first, first + MP.LANES))
        positive = np.argsort(rng.random(shape), 1) < counts[:, None]  # `count` random columns a row
        tiles.append(np.where(positive, pos, neg).astype(np.int32))
    return tiles


def gather_indices() -> Dict[str, np.ndarray]:
    """The sublane gather's (64, 128) int32 row indices beyond the probe's:
    all 0, all 63, the identity (idx[r, c] = r) and random, so that a
    slipped row or column shows."""
    shape = (64, MP.LANES)
    rows = np.arange(64, dtype=np.int32)[:, None]
    return {"zeros": np.zeros(shape, np.int32), "last": np.full(shape, 63, np.int32),
            "identity": np.broadcast_to(rows, shape).copy(),
            "random": np.random.default_rng(20).integers(0, 64, shape, np.int32)}


def sort_tiles() -> Dict[str, np.ndarray]:
    """The in-row sort's (8, 128) int32 tiles beyond the probe's: full-range
    random values with INT_MIN and INT_MAX in every row, all values equal,
    rows already ascending, rows descending, rows of only 4 distinct values,
    and rows that are bitonic sequences (ascending, then descending, turning
    at a random column), so that a stage that compares the wrong way
    shows."""
    rng = np.random.default_rng(21)
    shape = (8, MP.LANES)
    full = rng.integers(-2 ** 31, 2 ** 31, shape, np.int32)
    for row in full:
        row[rng.permutation(MP.LANES)[:2]] = [-2 ** 31, 2 ** 31 - 1]
    ascending = np.sort(rng.integers(-2 ** 31, 2 ** 31, shape, np.int32), 1)
    bitonic = np.sort(rng.integers(-2 ** 31, 2 ** 31, shape, np.int32), 1)
    for row in bitonic:
        turn = rng.integers(1, MP.LANES)
        row[turn:] = row[turn:][::-1].copy()
    four = np.int32([-2 ** 31, -1, 0, 2 ** 31 - 1])
    return {"full range": full, "equal": np.full(shape, -7, np.int32), "ascending": ascending,
            "descending": ascending[:, ::-1].copy(), "four values": rng.choice(four, shape),
            "bitonic": bitonic}


def one_hot_tiles() -> List[np.ndarray]:
    """The lane cumsum's 16 (8, 128) int32 tiles of a single 1 a row: tile t
    row r at column 8t + r, so that together they put a 1 at each of the 128
    columns, and a carry lost or misplaced at any lane's boundary shows."""
    tiles = np.zeros((16, 8, MP.LANES), np.int32)
    t, r = np.meshgrid(np.arange(16), np.arange(8), indexing="ij")
    tiles[t, r, 8 * t + r] = 1
    return list(tiles)


def lane_indices(rows: int, width: int) -> Dict[str, np.ndarray]:
    """A lane gather's (rows, 128) int32 indices into rows `width` wide,
    beyond the probe's: all 0, all width - 1, the identity (idx[r, c] = c),
    the reversal (width - 1 - c), at width 256 the upper half alone, and
    random, so that a slipped lane or row, or a lost upper half, shows."""
    shape = (rows, MP.LANES)
    cols = np.broadcast_to(np.arange(MP.LANES, dtype=np.int32), shape)
    rng = np.random.default_rng(22)
    idx = {"zeros": np.zeros(shape, np.int32), "last": np.full(shape, width - 1, np.int32),
           "identity": cols.copy(), "reversal": width - 1 - cols}
    if width > MP.LANES:
        idx["upper half"] = rng.integers(width // 2, width, shape, np.int32)
    idx["random"] = rng.integers(0, width, shape, np.int32)
    return idx


def held_inputs(probe: MP.Probe, device) -> Iterator[List[torch.Tensor]]:
    """The inputs each design is held to the plain version on: the probe's;
    for a row window (the row store too) every legal s on full-range random
    rows; for the scalar add full-range rows with a scalar at either end of
    the int32 range; for the transpose, the copy and the bitcast a
    full-range random tile; for the merge steps each of ``step_pairs`` at
    each R of STEP_HELD_R; for the column cumsum ``ordered_tile`` and
    normals; for the mask matmul each of ``count_tiles``; for the sublane
    gather a full-range random tile with each of ``gather_indices``; for the
    sized copy each s of SIZED_HELD on full-range random rows; for the
    in-row sort each of ``sort_tiles``; for the lane cumsum a full-range
    random tile and each of ``one_hot_tiles``; for the lane gathers a
    full-range random x (its bits as float32 for ``gather_lanes_f32``, with
    -0 and a signalling NaN in every row) with each of ``lane_indices``."""
    yield MP.inputs_on(probe, device)
    if probe.label == "cumsum_lanes_i32":
        yield [_full_range((8, MP.LANES), device)]
        for tile in one_hot_tiles():
            yield [torch.from_numpy(tile).to(device)]
    if probe.label in GATHER_LANES:
        x, idx = probe.inputs()
        full = _full_range(x.shape, device)
        if x.dtype == np.float32:  # row r: -0 at column r, a signalling NaN at column width - 1 - r
            rows = torch.arange(len(x), device=device)
            full[rows, rows] = -2 ** 31
            full[rows, x.shape[1] - 1 - rows] = 0x7F800001
        full = full.view(torch.from_numpy(x).dtype)
        for cols in lane_indices(len(idx), x.shape[1]).values():
            yield [full, torch.from_numpy(cols).to(device)]
    if probe.label == "gather_sublanes_taa_axis0":
        x = _full_range((64, MP.LANES), device)
        for idx in gather_indices().values():
            yield [x, torch.from_numpy(idx).to(device)]
    if probe.label == "lax_sort_in_kernel":
        for tile in sort_tiles().values():
            yield [torch.from_numpy(tile).to(device)]
    if probe.label == "dma_dynamic_size_rows":
        rows = _full_range((64, MP.LANES), device)
        for s in SIZED_HELD:
            yield [torch.full((1,), s, dtype=torch.int32, device=device), rows]
    if probe.label == "cumsum_sublanes_f32":
        normals = np.random.default_rng(19).standard_normal((64, MP.LANES)).astype(np.float32)
        for tile in (ordered_tile(), normals):
            yield [torch.from_numpy(tile).to(device)]
    if probe.label == "i1_to_bf16_astype":
        for tile in count_tiles():
            yield [torch.from_numpy(tile).to(device)]
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


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal in dtype, shape and every bit (NaNs and signed zeros too)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[got.element_size()]
        got, want = got.view(bits), want.view(bits)
    return torch.equal(got, want)


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
                if name not in STAGING and not same_bits(fn(), want):
                    raise RuntimeError(f"{label}: the {name} design disagrees with the plain version "
                                       f"on inputs {[a.flatten()[:4].tolist() for a in args]}")
        args = MP.inputs_on(probe, device)
        fns = {"plain": lambda: MP.plain(probe, *args), "new": lambda: MP.launch(probe, *args),
               "library": MP.library_call(label, args), **design_calls(libs, label, args)}
        # a merge step's plain version reads R on the host, and it has no library call
        turns = ["new"] if label in PR.MERGE_STEPS else ["plain", "new"] + (
            ["library", "new"] if fns["library"] is not None else [])
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
    """:func:`count_sass` of ``cuobjdump -sass`` (the CUDA toolkit's) of
    `library`."""
    tool = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    return count_sass(subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                                     check=True).stdout)


def count_sass(text: str) -> Dict[str, Dict[str, int]]:
    """Instructions by opcode (SASS_OPS, any suffix), in all ("all") and the
    LDGs after the first of each of LATE's opcodes (by LATE's key) of each
    kernel in cuobjdump's SASS `text` whose name holds one of SASS_KERNELS,
    by mangled name."""
    counts: Dict[str, Dict[str, int]] = {}
    current, passed = None, set()  # passed: the keys of LATE whose first opcode has come
    is_op = lambda op, k: op == k or op.startswith(k + ".")  # noqa: E731
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            current = counts.setdefault(name, dict.fromkeys((*SASS_OPS, "all", *LATE), 0)) if any(
                k in name for k in SASS_KERNELS) else None
            passed = set()
            continue
        # "        /*0090*/                   @!P0 LDS.64 R4, [R2+0x10] ;"
        op = SASS_LINE.match(line) if current is not None else None
        if op:
            op = op.group(1)
            current["all"] += 1
            for k in SASS_OPS:
                current[k] += is_op(op, k)
            for key, after in LATE.items():
                current[key] += key in passed and is_op(op, "LDG")
                if any(is_op(op, k) for k in after):
                    passed.add(key)
    return counts


def main(argv=None) -> int:
    import argparse

    from ..parallel.dryrun import device_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass", action="store_true",
                    help="also print the SASS counts of the merge step's, the copy's, the cumsum's, the mask matmul's, "
                         "the sublane gather's, the sized copy's, the row write's and store's, the in-row sort's, "
                         "the lane cumsum's and the lane gather's kernels in each library")
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
