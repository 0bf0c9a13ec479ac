"""Bindings to the C++ host runtime (``csrc/host_runtime.cpp``), with a numpy
fallback (counterpart of ``arrow_tpu/runtime/native.py``).

The host tier packs and unpacks validity bits, counts set bits and ANDs
word buffers on the host.  The port builds its own copy of the library from
the source with ``g++`` at first use, into ``build/arrow_tpu_torch/`` at the
root of the checkout, under a name that hashes the source, the flags and the
machine (so a stale or foreign library is never loaded).  It does not load
``csrc/libarrowtpu_host.so``, which was built for another host.  Where the
build fails (no ``g++``), :func:`have_native` is False and each function
returns None, so that its caller runs the numpy fallback; results are
identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import platform
import shutil
import subprocess
import threading
from typing import Iterable, Optional, Tuple

import numpy as np

log = logging.getLogger("arrow_tpu_torch")

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "host_runtime.cpp"
BUILD_DIR = ROOT / "build" / "arrow_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LIB = None
_LIB_TRIED = False
_LOCK = threading.Lock()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join((*CXX_FLAGS, platform.machine())).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libarrow_tpu_torch_host_{h.hexdigest()[:16]}.so"


def _build() -> Optional[pathlib.Path]:
    """The host library, built if no up-to-date one exists; None where it
    cannot be built."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not SOURCE.exists():
        return None
    path = library_path()
    if path.exists():
        return path
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        log.warning("arrow_tpu_torch: building the host runtime failed:\n%s", proc.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)
    return path


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        with _LOCK:
            if not _LIB_TRIED:
                path = _build()
                if path is not None:
                    try:
                        lib = ctypes.CDLL(str(path))
                        vp, sz = ctypes.c_void_p, ctypes.c_size_t
                        for fn, args, res in (("atpu_pack_bits", [vp, sz, vp], None),
                                              ("atpu_unpack_bits", [vp, sz, vp], None),
                                              ("atpu_popcount", [vp, sz], ctypes.c_uint64),
                                              ("atpu_and_words", [vp, vp, sz, vp], None)):
                            getattr(lib, fn).argtypes = args
                            getattr(lib, fn).restype = res
                        _LIB = lib
                        log.info("arrow_tpu_torch: loaded the C++ host runtime %s", path)
                    except OSError as e:
                        log.warning("arrow_tpu_torch: failed to load the host runtime: %s", e)
                _LIB_TRIED = True
    return _LIB


def have_native() -> bool:
    return _lib() is not None


def densify_optionals(
    values: Iterable[Optional[object]], np_dtype
) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """One pass over optionals -> (dense values with 0 at nulls, bool valid
    mask, n).  The mask is None when the input is a plain ndarray or holds
    no None."""
    if isinstance(values, np.ndarray):
        if values.dtype == object:
            values = values.tolist()
        else:
            arr = values.astype(np_dtype) if np_dtype is not None else values
            return arr, None, arr.shape[0]
    vals = list(values)
    n = len(vals)
    mask = np.fromiter((v is not None for v in vals), count=n, dtype=np.bool_)
    if mask.all():
        return np.asarray(vals, dtype=np_dtype), None, n
    dense = np.asarray([0 if v is None else v for v in vals], dtype=np_dtype)
    return dense, mask, n


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def pack_bits_native(mask: np.ndarray, pad_words: int) -> Optional[np.ndarray]:
    """bool bytes -> `pad_words` LSB-first uint32 words; None if the native
    library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if pad_words * 32 < mask.shape[0]:
        raise ValueError(f"{mask.shape[0]} bits do not fit in {pad_words} words")
    out = np.zeros(pad_words, dtype=np.uint32)
    lib.atpu_pack_bits(_ptr(mask), mask.shape[0], _ptr(out))
    return out


def unpack_bits_native(words: np.ndarray, n: int) -> Optional[np.ndarray]:
    """32-bit words -> bool[n]; None if the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words).view(np.uint32)
    if n > words.shape[0] * 32:
        raise ValueError(f"{n} bits asked of {words.shape[0]} words")
    out = np.zeros(n, dtype=np.uint8)
    lib.atpu_unpack_bits(_ptr(words), n, _ptr(out))
    return out.view(np.bool_)


def popcount_native(words: np.ndarray) -> Optional[int]:
    """Set bits over 32-bit words (a validity's null count); None if the
    native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words).view(np.uint32)
    return int(lib.atpu_popcount(_ptr(words), words.shape[0]))


def and_words_native(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """AND of two 32-bit word buffers of one shape; None if the native
    library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a).view(np.uint32)
    b = np.ascontiguousarray(b).view(np.uint32)
    if a.shape != b.shape:
        raise ValueError(f"word buffers of {a.shape} and {b.shape}")
    out = np.empty_like(a)
    lib.atpu_and_words(_ptr(a), _ptr(b), a.shape[0], _ptr(out))
    return out
