"""Build and load the port's hand-written CUDA kernels.

All ``arrow_tpu_torch/csrc/*.cu`` sources are compiled by ``nvcc``, one
process for each source, all started together, and linked into one shared
library with a plain C interface, which is loaded with ``ctypes``.
The build happens at the first kernel launch (never at import: the CPU tests
import every module on machines without ``nvcc``).  It writes to
``build/arrow_tpu_torch/`` at the root of the checkout, and the library's
name carries a hash of the sources and flags, so a stale library is never
loaded.

Each kernel is described by a :class:`Kernel` record in :data:`KERNELS`,
which also holds its launch count: the wrapper adds one where it launches the
kernel, and nowhere else.

:func:`build_generated` is the second entry point: it builds CUDA sources
that the port generates at run time (``runtime/fusion.py``), each into a
library of its own under ``build/arrow_tpu_torch/fused/``, named by a hash of
the source and the flags, and loads it.
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
from typing import Dict, Tuple

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "arrow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


GENERATED_DIR = BUILD_DIR / "fused"
#: the generated sources' flags: no FMA contraction, since the eager ops
#: round a product and a sum apart
GENERATED_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-shared",
)


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel of the port and its launch count."""

    name: str
    source: str  # path in the repository
    replaces: str  # file:line of the TPU kernel it replaces
    route: str = "cuda"
    launches: int = 0
    passes: int = 0  # radix sorts only: the passes its calls made (kernel or plain version)


#: every kernel of the port, by name
KERNELS: Dict[str, Kernel] = {}


def register_kernel(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.passes = 0


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


def build_library(out: pathlib.Path, cu_sources) -> Tuple[float, str]:
    """Compile each source with its own nvcc process, all started together,
    and link the objects into the shared library `out`.  Returns (seconds,
    nvcc's output); raises if a step fails."""
    t0 = time.perf_counter()
    objs = [out.with_name(f"{out.name}.{i}.{src.stem}.o") for i, src in enumerate(cu_sources)]
    procs = [
        subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(cu_sources, objs)
    ]
    logs, failed = [], []
    try:
        for src, proc in zip(cu_sources, procs):
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{''.join(logs)}")
        link = subprocess.run([_nvcc(), "-shared", "-o", str(out), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"linking {out.name} failed ({link.returncode}):\n{logs[-1]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return time.perf_counter() - t0, "".join(logs)


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
        seconds, log = build_library(tmp, [src for src in sources() if src.suffix == ".cu"])
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


#: (library names, wall seconds) of each batch of generated sources this
#: process built (a batch's nvcc processes run together); a library found up
#: to date on disk is not listed
GENERATED_BUILDS: list = []
_GENERATED: Dict[pathlib.Path, ctypes.CDLL] = {}


def generated_path(source: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(GENERATED_FLAGS).encode())
    h.update(source.encode())
    return GENERATED_DIR / f"libfused_{h.hexdigest()[:16]}.so"


def build_generated(sources) -> list:
    """Build (one nvcc process for each source not built yet, all started
    together) and load generated CUDA sources; returns their ctypes
    libraries, in order.  Raises if a build fails."""
    if not torch.cuda.is_available():
        raise RuntimeError("the generated kernels need a CUDA device")
    paths = [generated_path(src) for src in sources]
    todo = {}
    for path, src in zip(paths, sources):
        if path not in _GENERATED and not path.exists():
            todo[path] = src
    if todo:
        GENERATED_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for path, src in todo.items():
            cu = path.with_suffix(f".{os.getpid()}.cu")
            cu.write_text(src)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            procs.append((path, cu, tmp, subprocess.Popen(
                [_nvcc(), *GENERATED_FLAGS, "-o", str(tmp), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        try:
            for path, cu, tmp, proc in procs:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(f"{cu.name} ({proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, path)
        finally:
            for path, cu, tmp, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
                if not failed:
                    cu.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed on generated sources (kept beside the libraries):\n"
                               + "\n".join(failed))
        GENERATED_BUILDS.append((tuple(path.name for path in todo), time.perf_counter() - t0))
    for path in paths:
        if path not in _GENERATED:
            _GENERATED[path] = ctypes.CDLL(str(path))
    return [_GENERATED[path] for path in paths]
