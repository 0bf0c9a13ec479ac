"""The two redesigned probe kernels against other designs of theirs, timed in
turns on one card.

    python -m arrow_tpu_torch.tools.probe_designs

``grid_1d_blockspec`` and ``matmul_int8_s32acc`` (``csrc/mosaic_probe.cu``)
are laid out for the card.  Each other design is a variant of a
``mosaic_probe.cu``, built into a library of its own under
``build/arrow_tpu_torch/designs/`` (the port's nvcc flags, one process a
design, all started together):

- ``earlier``: the source before the redesign, where the checkout holds it
  as ``build/parent/arrow_tpu_torch/csrc/mosaic_probe.cu`` (unpacked from
  git as the README says; not measured otherwise);
- ``staging``: the int8 product with its wgmma call cut out, whose output is
  then the zeroed accumulators: the staging and the stores alone;
- ``tile64``, ``tile128``: the int8 product in output tiles of 64 x 64 and
  64 x 128 (4 and 2 blocks) in place of 64 x 32 (8 blocks).

Every design but ``staging`` is first held to the plain version on the
probe's inputs.  Then each kernel is timed in turns: plain, new, a design,
new, the next design, new, ...; device ms a call, queued behind a spin
kernel (:func:`arrow_tpu_torch.utils.timing.queued_seconds_per_call`),
beside an empty kernel's and the library call's (``x + 1``,
``torch._int_mm``).  ``chip_smoke.py``'s ``probes`` phase runs the same.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import statistics
import sys
import time
from typing import Callable, Dict, Tuple

import torch

from ..compute.kernels import _build
from . import mosaic_probe as MP
from .common import gpu_line

REDESIGNED = ("grid_1d_blockspec", "matmul_int8_s32acc")
SOURCE = _build.CSRC_DIR / "mosaic_probe.cu"
EARLIER = _build.BUILD_DIR.parent / "parent" / "arrow_tpu_torch" / "csrc" / "mosaic_probe.cu"
OUT_DIR = _build.BUILD_DIR / "designs"
PRODUCT_CALL = "  wgmma_product(d, sa, sb);\n"
TILE = 32  # the source's output columns a block (kTileN)
WRAPPER_START = "__device__ __forceinline__ void wgmma_m64nNk32("
LIBRARY = {"grid_1d_blockspec": lambda x: x + 1, "matmul_int8_s32acc": torch._int_mm}
# the designs that each kernel is timed against, in their turn's order
TURNS = {"grid_1d_blockspec": ("earlier",), "matmul_int8_s32acc": ("earlier", "staging", "tile64", "tile128")}


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


def design_sources() -> Dict[str, str]:
    """Each design's source, by name (``earlier`` where the checkout holds it)."""
    text = SOURCE.read_text()
    designs = {"staging": _once(text, PRODUCT_CALL, ""), "tile64": _tile(text, 64), "tile128": _tile(text, 128)}
    if EARLIER.is_file():
        designs["earlier"] = EARLIER.read_text()
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


def design_call(lib: ctypes.CDLL, probe: MP.Probe, args) -> Callable[[], torch.Tensor]:
    """A call of `lib`'s C entry of the probe on `args` into a new output, as
    the probe's wrapper makes it (no launch counted)."""
    fn = getattr(lib, f"arrow_probe_{probe.label}")
    fn.argtypes = [ctypes.c_void_p] * (len(args) + 2)
    fn.restype = ctypes.c_int

    def call():
        out = torch.empty(probe.shape, dtype=probe.dtype, device=args[0].device)
        _build.check(fn(*[a.data_ptr() for a in args], out.data_ptr(), _build.stream_of(out)), probe.label)
        return out

    return call


def queued_ms(fn: Callable, what: str) -> float:
    from ..utils.timing import queued_seconds_per_call

    s = queued_seconds_per_call(fn)
    if s is None:
        raise RuntimeError(f"{what}: the host does not get ahead of the device")
    return s * 1e3


def run(device, log: Callable[[str], None] = print) -> Dict[str, list]:
    """Build the designs, hold them to the plain versions and time them in
    turns on `device`; logs a line a kernel and returns its (name, ms)
    turns by label."""
    libs, seconds = build()
    missing = "" if "earlier" in libs else f"; the earlier design: not measured ({EARLIER} is not there)"
    log(f"built the designs {sorted(libs)} in {seconds:.1f} s{missing}")
    empty_ms = queued_ms(lambda: MP.empty_launch(device), "an empty kernel")
    result = {}
    for label in REDESIGNED:
        probe = MP.BY_LABEL[label]
        args = MP.inputs_on(probe, device)
        fns = {"plain": lambda: MP.plain(probe, *args), "new": lambda: MP.launch(probe, *args),
               "library": lambda: LIBRARY[label](*args)}
        fns.update((name, design_call(libs[name], probe, args)) for name in TURNS[label] if name in libs)
        want = fns["plain"]()
        for name in fns.keys() - {"staging"}:
            if not torch.equal(fns[name](), want):
                raise RuntimeError(f"{label}: the {name} design disagrees with the plain version")
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
