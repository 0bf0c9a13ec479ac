"""The redesigned probe kernels against other designs of theirs, timed in
turns on one card.

    python -m arrow_tpu_torch.tools.probe_designs

``grid_1d_blockspec``, ``matmul_int8_s32acc``, ``dynamic_slice_vmem_rows``,
``dma_unaligned_row_write``, ``dma_unaligned_row_offset`` and
``prefetch_scalar_grid`` (``csrc/mosaic_probe.cu``) are laid out for the
card.  Each other design is a variant of a ``mosaic_probe.cu``, built
into a library of its own under ``build/arrow_tpu_torch/designs/`` (the
port's nvcc flags, one process a design, all started together):

- ``earlier``: the source before the kernel's redesign, where the checkout
  holds it as ``build/parent/<commit>/arrow_tpu_torch/csrc/mosaic_probe.cu``
  for the kernel's commit in ``BEFORE`` (unpacked from git as the README
  says; not measured otherwise).  ``dma_unaligned_row_write``'s earlier
  design wrote only the window, into an output that its wrapper zeroed
  first: that fill is part of its call and of its time;
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
  the JAX grid's two blocks of 256.

Every design but ``staging`` is first held to the plain version on the
probe's inputs, a row window's at every legal s on random rows, and the
scalar add's on full-range rows and scalars, where the sum wraps.  Then
each kernel is timed in turns: plain, new, library, new, a design, new, the
next design, new, ...; device ms a call, queued behind a spin kernel
(:func:`arrow_tpu_torch.utils.timing.queued_seconds_per_call`), beside an
empty kernel's; the library call is :func:`mosaic_probe.library_call`'s
(``x + 1``, ``torch._int_mm``, a slice's ``clone``, ``F.pad``, ``x + s``).
``chip_smoke.py``'s ``probes`` phase runs the same.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import statistics
import sys
import time
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..compute.kernels import _build
from . import mosaic_probe as MP
from .common import gpu_line

SOURCE = _build.CSRC_DIR / "mosaic_probe.cu"
PARENT = _build.BUILD_DIR.parent / "parent"
# the commit before each kernel's redesign, whose source is its earlier design
BEFORE = {"grid_1d_blockspec": "9d785cc", "matmul_int8_s32acc": "9d785cc",
          "dynamic_slice_vmem_rows": "70dca0e", "dma_unaligned_row_write": "70dca0e",
          "dma_unaligned_row_offset": "829306e", "prefetch_scalar_grid": "829306e"}
REDESIGNED = tuple(BEFORE)
FILLED_BEFORE = ("dma_unaligned_row_write",)  # earlier designs that wrote into an output zeroed by the wrapper
# a window at device row s in [0, 56]
WINDOWED = ("dynamic_slice_vmem_rows", "dma_unaligned_row_write", "dma_unaligned_row_offset")
WRAPPED = ("prefetch_scalar_grid",)  # an int32 sum that wraps
OUT_DIR = _build.BUILD_DIR / "designs"
PRODUCT_CALL = "  wgmma_product(d, sa, sb);\n"
TILE = 32  # the source's output columns a block (kTileN)
WRAPPER_START = "__device__ __forceinline__ void wgmma_m64nNk32("
SLICE_EVERY_ROW = "constexpr bool kSliceEveryRow = true;"
WRITE_BULK = "constexpr bool kWriteBulk = false;"
OFFSET_BULK = "constexpr bool kOffsetBulk = false;"
SCALAR_ONE_BLOCK = "constexpr bool kScalarOneBlock = false;"
# the designs that each kernel is timed against, in their turn's order
TURNS = {"grid_1d_blockspec": ("earlier",), "matmul_int8_s32acc": ("earlier", "staging", "tile64", "tile128"),
         "dynamic_slice_vmem_rows": ("earlier", "window"), "dma_unaligned_row_write": ("earlier", "bulk"),
         "dma_unaligned_row_offset": ("earlier", "bulk_in"), "prefetch_scalar_grid": ("earlier", "one_block")}


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
        raise RuntimeError(f"mosaic_probe.cu: {old.strip()[:60]!r} is not there once")
    return text.replace(old, new)


def _tile(text: str, n: int) -> str:
    """The source with output tiles n columns wide."""
    text = _once(text, wgmma_wrapper(TILE), wgmma_wrapper(n))
    return _once(text, f"constexpr int kTileN = {TILE};", f"constexpr int kTileN = {n};")


def earlier_source(label: str) -> pathlib.Path:
    """Where the checkout holds the source before `label`'s redesign."""
    return PARENT / BEFORE[label] / "arrow_tpu_torch" / "csrc" / "mosaic_probe.cu"


def library_name(label: str, design: str) -> str:
    """The name of the library that holds `label`'s `design`: the earlier
    designs by commit, the rest by their own name."""
    return f"earlier_{BEFORE[label]}" if design == "earlier" else design


def design_sources() -> Dict[str, str]:
    """Each design's source, by library name (the earlier ones where the
    checkout holds them)."""
    text = SOURCE.read_text()
    designs = {"staging": _once(text, PRODUCT_CALL, ""), "tile64": _tile(text, 64), "tile128": _tile(text, 128),
               "window": _once(text, SLICE_EVERY_ROW, SLICE_EVERY_ROW.replace("true", "false")),
               "bulk": _once(text, WRITE_BULK, WRITE_BULK.replace("false", "true")),
               "bulk_in": _once(text, OFFSET_BULK, OFFSET_BULK.replace("false", "true")),
               "one_block": _once(text, SCALAR_ONE_BLOCK, SCALAR_ONE_BLOCK.replace("false", "true"))}
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
        src = OUT_DIR / f"mosaic_probe_{name}.cu"
        src.write_text(text)
        jobs[name] = (OUT_DIR / f"lib_{name}.so", src)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        for done in [pool.submit(_build.build_library, lib, [src]) for lib, src in jobs.values()]:
            done.result()
    return {name: ctypes.CDLL(str(lib)) for name, (lib, _) in jobs.items()}, time.perf_counter() - t0


def design_call(lib: ctypes.CDLL, probe: MP.Probe, args, zeroed: bool = False) -> Callable[[], torch.Tensor]:
    """A call of `lib`'s C entry of the probe on `args` into a new output, as
    the probe's wrapper makes it (no launch counted); `zeroed`: the output
    is zeroed first, as the wrapper of a design that writes part of it did."""
    fn = getattr(lib, f"arrow_probe_{probe.label}")
    fn.argtypes = [ctypes.c_void_p] * (len(args) + 2)
    fn.restype = ctypes.c_int

    def call():
        out = (torch.zeros if zeroed else torch.empty)(probe.shape, dtype=probe.dtype, device=args[0].device)
        _build.check(fn(*[a.data_ptr() for a in args], out.data_ptr(), _build.stream_of(out)), probe.label)
        return out

    return call


def design_calls(libs: Dict[str, ctypes.CDLL], label: str, args) -> Dict[str, Callable[[], torch.Tensor]]:
    """Calls of `label`'s designs that were built, on `args`, by design name;
    an earlier design that wrote part of the output gets a zeroed one."""
    probe = MP.BY_LABEL[label]
    return {name: design_call(libs[library_name(label, name)], probe, args,
                              zeroed=name == "earlier" and label in FILLED_BEFORE)
            for name in TURNS[label] if library_name(label, name) in libs}


def queued_ms(fn: Callable, what: str) -> float:
    from ..utils.timing import queued_seconds_per_call

    s = queued_seconds_per_call(fn)
    if s is None:
        raise RuntimeError(f"{what}: the host does not get ahead of the device")
    return s * 1e3


def held_inputs(probe: MP.Probe, device) -> Iterator[List[torch.Tensor]]:
    """The inputs each design is held to the plain version on: the probe's;
    for a row window every legal s on full-range random rows; for the scalar
    add full-range rows with a scalar at either end of the int32 range."""
    yield MP.inputs_on(probe, device)
    if probe.label in WINDOWED + WRAPPED:
        shape = probe.inputs()[1].shape
        rows = torch.from_numpy(np.random.default_rng(15).integers(-2 ** 31, 2 ** 31, shape, np.int32)).to(device)
        for s in range(64 - 8 + 1) if probe.label in WINDOWED else (2 ** 31 - 3, -2 ** 31 + 3):
            yield [torch.full((1,), s, dtype=torch.int32, device=device), rows]


def run(device, log: Callable[[str], None] = print) -> Dict[str, list]:
    """Build the designs, hold them to the plain versions and time them in
    turns on `device`; logs a line a kernel and returns its (name, ms)
    turns by label."""
    libs, seconds = build()
    missing = sorted({str(earlier_source(label)) for label in REDESIGNED
                      if library_name(label, "earlier") not in libs})
    log(f"built the designs {sorted(libs)} in {seconds:.1f} s"
        + (f"; not measured, the earlier designs in {missing} (not there)" if missing else ""))
    empty_ms = queued_ms(lambda: MP.empty_launch(device), "an empty kernel")
    result = {}
    for label in REDESIGNED:
        probe = MP.BY_LABEL[label]
        for args in held_inputs(probe, device):
            want = MP.plain(probe, *args)
            for name, fn in {"new": lambda: MP.launch(probe, *args), **design_calls(libs, label, args)}.items():
                if name != "staging" and not torch.equal(fn(), want):
                    raise RuntimeError(f"{label}: the {name} design disagrees with the plain version "
                                       f"on inputs {[a.flatten()[:4].tolist() for a in args]}")
        args = MP.inputs_on(probe, device)
        fns = {"plain": lambda: MP.plain(probe, *args), "new": lambda: MP.launch(probe, *args),
               "library": MP.library_call(label, args), **design_calls(libs, label, args)}
        turns = ["plain", "new", "library", "new"]
        for name in TURNS[label]:
            turns += [name, "new"] if name in fns else []
        times = [(name, queued_ms(fns[name], f"{label}, {name}")) for name in turns]
        new = statistics.median(t for name, t in times if name == "new")
        ratios = ", ".join(f"{name} {t / new:.3f}" for name, t in times if name not in ("new", "plain"))
        log(f"{label}, designs in turns, device ms a call (queued): "
            + ", ".join(f"{name} {t:.5f}" for name, t in times)
            + f"; over new's median: {ratios}; an empty kernel {empty_ms:.5f}")
        result[label] = times
    return result


def main() -> int:
    from ..parallel.dryrun import device_name

    device = torch.device(device_name(None))
    if device.type != "cuda":
        print("probe_designs: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, device: {device} ({torch.cuda.get_device_name(device)}; {gpu_line()})")
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
