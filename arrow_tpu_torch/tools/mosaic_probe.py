"""Capability probes of the card: the counterpart of ``tools/mosaic_probe.py``.

    python -m arrow_tpu_torch.tools.mosaic_probe               # the 25 probes on the card
    python -m arrow_tpu_torch.tools.mosaic_probe --quick       # those whose label holds a QUICK substring
    python -m arrow_tpu_torch.tools.mosaic_probe gather        # those whose label holds "gather"
    python -m arrow_tpu_torch.tools.mosaic_probe --device cpu  # the plain versions on the CPU

The JAX tool checks that the TPU's compiler takes 25 small Pallas kernels:
lane and sublane gathers, rolls, dynamic row windows, DMA copies at row
offsets, in-kernel scans, a sort and a transpose, unsigned bit operations, a
scalar loop in scratch memory, int8 matmul, compare masks cast to int8 and
bf16, and gridded calls.  Here each probe is a kernel written by hand for
Hopper (``arrow_tpu_torch/csrc/mosaic_probe.cu``, whose note says how each
group maps onto the card), registered in ``_build.KERNELS`` under the
probe's label, with a plain PyTorch version beside it.

Each probe builds the JAX probe's inputs (the same shapes, dtypes and numpy
seeds), runs :func:`run` on them (the kernel for tensors on a card, the
plain version for tensors on the CPU) and checks the result against the JAX
probe's numpy oracle, printing ``[OK]`` or ``[FAIL]`` and going on; the
``=== MATRIX ===`` at the end lists every probe run.  Unsigned 32-bit values
are held in int32 storage, as everywhere in the port.  Where the JAX output
holds uninitialised rows (the DMA probes that write part of it), the
port's kernels write zeros there and its oracle holds them to zero;
``Probe.rows`` names the rows that the JAX probe writes, which are all that
can be held against it.  :func:`library_call` gives, where there is one, a
PyTorch call of a probe's function: a yardstick timed beside the kernel,
called nowhere else.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compute.kernels import _build
from ..parallel.dryrun import device_name

SOURCE = "arrow_tpu_torch/csrc/mosaic_probe.cu"
JAX_TOOL = "tools/mosaic_probe.py"
SIMPLE_CALL = 61  # the pallas_call of simple_call, which 19 of the probes use
LANES = 128


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: its label, its pallas_call site in the JAX tool, its
    inputs (numpy, in the order of the JAX call's arguments), its plain
    version, its numpy oracle (None where the JAX tool has none), its
    output's shape and dtype."""

    label: str
    site: int
    inputs: Callable[[], Tuple[np.ndarray, ...]]
    plain: Callable[..., torch.Tensor]
    oracle: Optional[Callable[..., np.ndarray]]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    rows: Optional[Callable[..., slice]] = None  # rows the JAX probe writes, from the inputs (all when None)
    ops: int = 0  # operations, for the bound (at the rate chip_smoke.py's OPS_PER_S gives the probe)
    blocked: bool = False  # the C entry takes a block count, each block on the same data into its own output

    @property
    def kernel(self) -> _build.Kernel:
        return _build.KERNELS[self.label]


# ---------------------------------------------------------------------------
# plain versions: PyTorch ops on CPU and CUDA tensors alike, with no host
# read of a device scalar


def _rows_of(s: torch.Tensor, count: int) -> torch.Tensor:
    """Row indices s[0], ..., s[0] + count - 1 on s's device."""
    return s.long() + torch.arange(count, device=s.device)


def _gather_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def _roll_lanes(a: torch.Tensor, shift) -> torch.Tensor:
    """np.roll along the lanes by `shift`: an int, or a (1,) int32 tensor on
    a's device."""
    return a[:, (torch.arange(LANES, device=a.device) - shift) % LANES]


def _unsigned(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & 0xFFFFFFFF


def _to_int32(u: torch.Tensor) -> torch.Tensor:
    """u32 values in int64 as their int32 bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _popcount(u: torch.Tensor) -> torch.Tensor:
    """Bits set in each u32 value held in int64 (SWAR)."""
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) & 0xFFFFFFFF) >> 24


def _shifts_popcount(x: torch.Tensor) -> torch.Tensor:
    u = _unsigned(x)
    return _to_int32((u >> 3) ^ ((u << 2) & 0xFFFFFFFF) ^ _popcount(u))


def _scan(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive running sum along `dim`, one slice after another."""
    out = x.clone()
    for i in range(1, x.shape[dim]):
        out.select(dim, i).add_(out.select(dim, i - 1))
    return out


def bitonic_rows(a: torch.Tensor) -> torch.Tensor:
    """Each row (a power of two wide) sorted ascending by a bitonic network."""
    width = a.shape[1]
    c = torch.arange(width, device=a.device)
    k = 2
    while k <= width:
        d = k // 2
        while d:
            p = a[:, c ^ d]
            keep_min = ((c & d) == 0) == ((c & k) == 0)
            a = torch.where(keep_min, torch.minimum(a, p), torch.maximum(a, p))
            d //= 2
        k *= 2
    return a


def _matmul_s8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 @ int8 -> int32, exact, as a broadcast product summed in int64
    (PyTorch has no integer matmul on a card)."""
    return (a.long()[:, :, None] * b.long()[None]).sum(1).to(torch.int32)


def _store_rows(s: torch.Tensor, a: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.zeros(rows, a.shape[1], dtype=a.dtype, device=a.device)
    out[_rows_of(s, a.shape[0])] = a
    return out


def _first_rows(s: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    keep = torch.arange(src.shape[0], device=src.device)[:, None] < s.long()
    return torch.where(keep, src, torch.zeros((), dtype=src.dtype, device=src.device))


# ---------------------------------------------------------------------------
# the JAX probes' inputs and oracles (numpy)


def _i32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


def _arange(rows: int, width: int = LANES, dtype=np.int32) -> np.ndarray:
    return np.arange(rows * width, dtype=dtype).reshape(rows, width)


def _lane_idx(seed: int, rows: int, high: int = LANES) -> np.ndarray:
    return _i32(np.random.default_rng(seed).integers(0, high, (rows, LANES)))


def _scalar(v: int) -> np.ndarray:
    return np.full((1,), v, np.int32)


def _mod100() -> np.ndarray:
    return _arange(32) % 100


def _int8_pair() -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(4)
    return (np.asarray(rng.integers(-100, 100, (128, 128)), np.int8),
            np.asarray(rng.integers(-100, 100, (128, 128)), np.int8))


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.vectorize(lambda v: bin(int(v)).count("1"))(x).astype(np.uint32)


def _u32_oracle(a: np.ndarray) -> np.ndarray:
    xn = a.view(np.uint32)
    return ((xn >> 3) ^ (xn << np.uint32(2)) ^ _popcount_np(xn)).view(np.int32)


def _at(s: np.ndarray) -> slice:
    return slice(int(s[0]), int(s[0]) + 8)


def _store_oracle(s, a):
    exp = np.zeros((64, 128), np.int32)
    exp[_at(s)] = a
    return exp


PROBES: List[Probe] = [  # in the JAX tool's order of runs
    Probe("cmp_to_bf16_vector", SIMPLE_CALL, lambda: (_mod100(),),
          lambda a: (a > 50).to(torch.bfloat16), lambda a: (a > 50).astype(np.float32),
          (32, 128), torch.bfloat16),
    Probe("bitcast_f32_u32", SIMPLE_CALL, lambda: (np.ones((8, 128), np.float32),),
          lambda a: a.view(torch.int32).clone(), lambda a: np.full((8, 128), 0x3F800000, np.uint32).view(np.int32),
          (8, 128), torch.int32),
    Probe("cumsum_lanes_i32", SIMPLE_CALL, lambda: (np.ones((8, 128), np.int32),),
          lambda a: _scan(a, 1), lambda a: np.cumsum(a, 1, dtype=np.int32), (8, 128), torch.int32),
    Probe("cumsum_sublanes_f32", SIMPLE_CALL, lambda: (np.ones((64, 128), np.float32),),
          lambda a: _scan(a, 0), lambda a: np.cumsum(a, 0, dtype=np.float32), (64, 128), torch.float32),
    Probe("dma_dynamic_size_rows", 281, lambda: (_scalar(8), _arange(64)),
          _first_rows, lambda s, src: np.where(np.arange(64)[:, None] < s[0], src, 0), (64, 128), torch.int32,
          rows=lambda s, src: slice(0, int(s[0]))),
    Probe("dma_unaligned_row_offset", 230, lambda: (_scalar(3), _arange(64)),
          lambda s, src: src[_rows_of(s, 8)], lambda s, src: src[_at(s)], (8, 128), torch.int32),
    Probe("dma_unaligned_row_write", 254, lambda: (_scalar(5), _arange(8)),
          lambda s, src: _store_rows(s, src, 64), _store_oracle, (64, 128), torch.int32,
          rows=lambda s, src: _at(s)),
    Probe("dynamic_slice_vmem_rows", SIMPLE_CALL, lambda: (_scalar(21), _arange(64)),
          lambda s, a: a[_rows_of(s, 8)], lambda s, a: a[_at(s)], (8, 128), torch.int32),
    Probe("dynamic_store_vmem_rows", SIMPLE_CALL, lambda: (_scalar(13), _arange(8)),
          lambda s, a: _store_rows(s, a, 64), _store_oracle, (64, 128), torch.int32),
    Probe("gather_lanes_256wide_2gathers", SIMPLE_CALL, lambda: (_arange(8, 256), _lane_idx(7, 8, 256)),
          _gather_lanes, lambda t, idx: np.take_along_axis(t, idx, 1), (8, 128), torch.int32),
    Probe("grid_1d_blockspec", 77, lambda: (_arange(256),),
          lambda x: x + 1, lambda x: x + 1, (256, 128), torch.int32),
    Probe("hbm_to_hbm_dma", 387, lambda: (_arange(64),),
          lambda src: src[8:16].clone(), lambda src: src[8:16], (8, 128), torch.int32),
    Probe("cmp_to_int8_vector", SIMPLE_CALL, lambda: (_mod100(),),
          lambda a: (a > 50).to(torch.int8), lambda a: (a > 50).astype(np.int8), (32, 128), torch.int8),
    Probe("matmul_int8_s32acc", SIMPLE_CALL, _int8_pair, _matmul_s8,
          lambda a, b: a.astype(np.int32) @ b.astype(np.int32), (128, 128), torch.int32, ops=2 * 128 ** 3),
    Probe("prefetch_scalar_grid", 428, lambda: (_scalar(7), _arange(16)),
          lambda s, x: x + s, lambda s, x: x + s[0], (16, 128), torch.int32),
    Probe("pltpu_roll_dynamic", SIMPLE_CALL, lambda: (_scalar(5), _arange(8)),
          lambda s, a: _roll_lanes(a, s), lambda s, a: np.roll(a, int(s[0]), 1), (8, 128), torch.int32),
    Probe("pltpu_roll_static", SIMPLE_CALL, lambda: (_arange(8),),
          lambda a: _roll_lanes(a, 3), lambda a: np.roll(a, 3, 1),
          (8, 128), torch.int32),
    Probe("smem_scratch_scalar_loop", SIMPLE_CALL, lambda: (_arange(8),),
          lambda a: a[:8, 0].sum(dtype=torch.int32).expand(8, 128).clone(),
          lambda a: np.full((8, 128), sum(int(i * 128) for i in range(8)), np.int32), (8, 128), torch.int32),
    Probe("lax_sort_in_kernel", SIMPLE_CALL,
          lambda: (_i32(np.random.default_rng(5).integers(0, 1000, (8, 128))),),
          bitonic_rows, lambda a: np.sort(a, 1), (8, 128), torch.int32),
    Probe("gather_lanes_taa_8x128_i32", SIMPLE_CALL, lambda: (_arange(8), _lane_idx(0, 8)),
          _gather_lanes, lambda x, idx: np.take_along_axis(x, idx, 1), (8, 128), torch.int32),
    Probe("gather_lanes_taa_256x128_i32", SIMPLE_CALL, lambda: (_arange(256), _lane_idx(1, 256)),
          _gather_lanes, lambda x, idx: np.take_along_axis(x, idx, 1), (256, 128), torch.int32),
    Probe("gather_lanes_f32", SIMPLE_CALL, lambda: (_arange(8, dtype=np.float32), _lane_idx(3, 8)),
          _gather_lanes, lambda x, idx: np.take_along_axis(x, idx, 1), (8, 128), torch.float32),
    Probe("gather_sublanes_taa_axis0", SIMPLE_CALL, lambda: (_arange(64), _lane_idx(2, 64, 64)),
          lambda x, idx: x[idx.long(), torch.arange(LANES, device=x.device)[None]],
          lambda x, idx: np.take_along_axis(x, idx, 0), (64, 128), torch.int32),
    Probe("transpose_32b_128x128", SIMPLE_CALL, lambda: (_arange(128),),
          lambda a: a.t().contiguous(), lambda a: a.T, (128, 128), torch.int32),
    Probe("u32_shifts_popcount", SIMPLE_CALL, lambda: (_arange(8, dtype=np.uint32).view(np.int32),),
          _shifts_popcount, _u32_oracle, (8, 128), torch.int32),
]
BY_LABEL = {p.label: p for p in PROBES}

for _p in PROBES:
    _build.register_kernel(_build.Kernel(name=_p.label, source=SOURCE,
                                         replaces=f"{JAX_TOOL}:{_p.site} ({_p.label})"))

# the JAX tool's quick set: labels holding one of these
QUICK = ("roll", "grid", "smem_scratch", "gather_lanes_taa_8", "int8")


# ---------------------------------------------------------------------------
# the wrappers


@functools.lru_cache(maxsize=None)
def _specs(probe: Probe) -> Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]:
    """(shape, dtype) of each of the probe's inputs."""
    return tuple((a.shape, torch.from_numpy(a).dtype) for a in probe.inputs())


def check_args(probe: Probe, args: Sequence[torch.Tensor]) -> None:
    """Raise unless `args` are the probe's inputs' shapes and dtypes, on one
    device."""
    specs = _specs(probe)
    if len(args) != len(specs):
        raise ValueError(f"{probe.label} takes {len(specs)} inputs, not {len(args)}")
    for i, (a, (shape, dtype)) in enumerate(zip(args, specs)):
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{probe.label} input {i}: {tuple(a.shape)} {a.dtype}, not {shape} {dtype}")
        if a.device != args[0].device:
            raise ValueError(f"{probe.label} input {i} is on {a.device}, input 0 on {args[0].device}")


@functools.lru_cache(maxsize=None)
def c_entry(name: str, pointers: int, ints: int = 0):
    """The library's C entry `name`, declared as taking `pointers` pointers,
    `ints` ints and the stream, and returning a CUDA error."""
    fn = getattr(_build.load().cdll, name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(probe: Probe, *args: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """Launch the probe's kernel on CUDA tensors.  A ``blocked`` probe's
    kernel runs `blocks` blocks, each on the same data into its own output,
    all returned, stacked, unless `blocks` is 1."""
    check_args(probe, args)
    device = args[0].device
    if device.type != "cuda":
        raise ValueError(f"{probe.label}: the kernel needs CUDA tensors")
    if blocks != 1 and not (probe.blocked and blocks > 1):
        raise ValueError(f"{probe.label}: {blocks} blocks")
    # the kernels move 16 bytes at a time: an input that starts off a 16-byte boundary is copied
    args = [a.contiguous() for a in args]
    args = [a if a.data_ptr() % 16 == 0 else a.clone() for a in args]
    out = torch.empty((blocks, *probe.shape), dtype=probe.dtype, device=device)
    fn = c_entry(f"arrow_probe_{probe.label}", len(args) + 1, int(probe.blocked))
    counts = (blocks,) if probe.blocked else ()
    with torch.cuda.device(device):
        err = fn(*[a.data_ptr() for a in args], out.data_ptr(), *counts, _build.stream_of(out))
    _build.check(err, probe.label)
    probe.kernel.launches += 1
    return out[0] if blocks == 1 else out


def plain(probe: Probe, *args: torch.Tensor) -> torch.Tensor:
    """The probe's plain PyTorch version, on any device."""
    check_args(probe, args)
    return probe.plain(*args)


def run(probe: Probe, *args: torch.Tensor) -> torch.Tensor:
    """The probe's function on `args`: the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    if args[0].device.type == "cpu":
        return plain(probe, *args)
    return launch(probe, *args)


def empty_launch(device) -> None:
    """Launch an empty kernel on `device`'s current stream (the launch time
    that bounds every probe from below)."""
    fn = c_entry("arrow_probe_empty", 0)
    with torch.cuda.device(device):
        _build.check(fn(torch.cuda.current_stream(device).cuda_stream), "empty kernel")


def library_call(label: str, args: Sequence[torch.Tensor]) -> Optional[Callable[[], object]]:
    """One PyTorch call that computes the probe's function on its inputs (a
    probe of this module or of probe_r4), or None where PyTorch has none
    (i1_to_bf16_astype: no one call compares, casts and multiplies; the
    merge steps; smem_scratch_scalar_loop: no one call sums a column and
    fills a tile with it; u32_shifts_popcount: PyTorch has no popcount, nor
    a logical right shift of 32-bit values).  int64 indices, host shifts
    and offsets, and the compare casts' int8 or bf16 output, are made here,
    outside the call."""
    import torch.nn.functional as F

    if label in ("cmp_to_bf16_vector", "cmp_to_int8_vector"):
        a = args[0]
        out = torch.empty(a.shape, dtype=BY_LABEL[label].dtype, device=a.device)
        return lambda: torch.gt(a, 50, out=out)
    if label.startswith("gather_lanes"):
        x, idx = args[0], args[1].long()
        return lambda: torch.take_along_dim(x, idx, 1)
    if label == "gather_sublanes_taa_axis0":
        x, idx = args[0], args[1].long()
        return lambda: torch.take_along_dim(x, idx, 0)
    if label.startswith("pltpu_roll"):
        shift, a = (3, args[0]) if label == "pltpu_roll_static" else (int(args[0][0]), args[1])
        return lambda: torch.roll(a, shift, 1)
    if label.startswith("cumsum"):
        a, dim = args[0], 1 if label == "cumsum_lanes_i32" else 0
        return lambda: torch.cumsum(a, dim, dtype=a.dtype)
    if label == "lax_sort_in_kernel":
        return lambda: torch.sort(args[0], 1).values
    if label == "matmul_int8_s32acc":
        return lambda: torch._int_mm(args[0], args[1])
    if label == "transpose_32b_128x128":
        return lambda: args[0].t().contiguous()
    if label in ("dma_unaligned_row_offset", "dynamic_slice_vmem_rows"):
        first = int(args[0][0])
        return lambda: args[1][first:first + 8].clone()
    if label == "hbm_to_hbm_dma":
        return lambda: args[0][8:16].clone()
    if label in ("dma_unaligned_row_write", "dynamic_store_vmem_rows"):
        first, rows = int(args[0][0]), args[1]
        return lambda: F.pad(rows, (0, 0, first, 64 - len(rows) - first))
    if label == "dma_dynamic_size_rows":
        count, src = int(args[0][0]), args[1]
        return lambda: F.pad(src[:count], (0, 0, 0, len(src) - count))
    if label == "bitcast_f32_u32":
        return lambda: args[0].view(torch.int32).clone()
    if label == "grid_1d_blockspec":
        return lambda: args[0] + 1
    if label == "prefetch_scalar_grid":
        return lambda: args[1] + args[0]
    return None


# ---------------------------------------------------------------------------
# the tool


def inputs_on(probe: Probe, device) -> List[torch.Tensor]:
    return [torch.from_numpy(a).to(device) for a in probe.inputs()]


def as_numpy(t: torch.Tensor) -> np.ndarray:
    """A result on the host, bf16 as float32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def check(probe: Probe, device) -> None:
    """Run the probe on `device` and hold it to the JAX probe's oracle
    (exact); raises on a mismatch."""
    host = probe.inputs()
    got = as_numpy(run(probe, *inputs_on(probe, device)))
    np.testing.assert_array_equal(got, np.asarray(probe.oracle(*host)))


RESULTS: List[Tuple[str, str, str]] = []


def selected(arg: Optional[str]) -> List[Probe]:
    """The probes to run for the command line's argument: all, the QUICK
    ones (``--quick``), or those whose label holds `arg`."""
    if arg == "--quick":
        return [p for p in PROBES if any(q in p.label for q in QUICK)]
    return [p for p in PROBES if not arg or arg in p.label]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", help="run the probes whose label holds this (or --quick)")
    ap.add_argument("--quick", action="store_true", help="run the QUICK probes")
    ap.add_argument("--device", default=None, help="the device (default: cuda:0 when there is one)")
    args = ap.parse_args(argv)
    device = torch.device(device_name(args.device))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"torch {torch.__version__}, device: {device} ({name})", flush=True)
    RESULTS.clear()
    for probe in selected("--quick" if args.quick else args.label):
        try:
            check(probe, device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            RESULTS.append((probe.label, "OK", ""))
            print(f"[OK]   {probe.label}", flush=True)
        except Exception as e:  # noqa: BLE001  (the matrix records a failure and goes on)
            msg = str(e).split("\n")[0][:160]
            RESULTS.append((probe.label, "FAIL", msg))
            print(f"[FAIL] {probe.label}: {msg}", flush=True)
    print("\n=== MATRIX ===")
    for label, status, msg in RESULTS:
        print(f"{status:5s} {label} {msg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
