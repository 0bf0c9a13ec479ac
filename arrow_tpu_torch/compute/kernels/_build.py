"""Build and load the port's hand-written CUDA kernels.

All ``arrow_tpu_torch/csrc/*.cu`` sources are compiled by ``nvcc`` into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The build happens at the first kernel launch (never at import: the CPU tests
import every module on machines without ``nvcc``).  It writes to
``build/arrow_tpu_torch/`` at the root of the checkout, and the library's
name carries a hash of the sources and flags, so a stale library is never
loaded.

Each kernel is described by a :class:`Kernel` record in :data:`KERNELS`,
which also holds its launch count: the wrapper adds one where it launches the
kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "arrow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel of the port and its launch count."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel it replaces
    route: str = "cuda"
    launches: int = 0


#: every kernel of the port, by name
KERNELS: Dict[str, Kernel] = {}


def register_kernel(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


@dataclasses.dataclass(frozen=True)
class Library:
    cdll: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float  # 0.0 when an up-to-date library was found
    log: str  # nvcc's output (register and shared-memory use per kernel)


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libarrow_tpu_torch_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def load() -> Library:
    """Build the library if no up-to-date one exists, then load it."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    path = _library_path()
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    cdll = ctypes.CDLL(str(path))
    cdll.arrow_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.arrow_cuda_error_string.restype = ctypes.c_char_p
    return Library(cdll, path, seconds, log)


def check(err: int, what: str) -> None:
    """Raise if a C wrapper returned a CUDA error."""
    if err != 0:
        msg = load().cdll.arrow_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
