"""take_columns (compute.kernels), the join's output take, on the CPU: its
plain version against ``ops.take`` column by column and against a numpy
oracle, over every element width (1, 2, 4 and 8 bytes) and BOOL's packed
bits, with and without validity, at lengths of 0, of the whole capacity
and of no multiple of 4 or 32, with indices past the source's rows (which
clamp to its last row), and the zeros past the length; the wrapper's
argument checks; and the kernel's CUDA source itself, built for the host
with g++ against tests/cuda_host_shim.h (a warp emulated by 32 threads),
called through the wrapper's own launch code, against the plain version.
The CUDA kernel is held to the plain version on the card in
tests/test_torch_cuda.py."""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import arrow_tpu_torch as att
from arrow_tpu_torch import kernels as TK
from arrow_tpu_torch.compute import kernels as TCK
from arrow_tpu_torch.compute.kernels import take as TT
from arrow_tpu_torch.ops.kernel import array_av
from arrow_tpu_torch.utils import bits as TB
from torch_helpers import TAKE_KINDS, TAKE_SHAPES, TAKE_SRC_ROWS, exact_column, index_plane

A = att.ArrowType


def _bits_of(words: torch.Tensor, n: int) -> np.ndarray:
    return TB.unpack_bits_np(words.numpy(), n)


def oracle(col, idx, length):
    """(data bytes, validity bits or None) of the take, in numpy: each of the
    first `length` rows from the clamped index, zeros after."""
    ids = idx.data.numpy().view(np.uint32).astype(np.int64)
    cap = ids.shape[0]
    live = np.arange(cap) < length

    def bits(words):
        src = _bits_of(words, words.shape[0] * 32)
        return src[np.minimum(ids, src.shape[0] - 1)] & live

    valid = None if col.validity is None else bits(col.validity)
    if col.dtype is A.BOOL:
        return TB.pack_bits_np(bits(col.data)).tobytes(), valid
    host = col.data.numpy()
    out = np.where(live, host[np.minimum(ids, host.shape[0] - 1)], np.zeros((), host.dtype))
    return out.astype(host.dtype).tobytes(), valid


def same(got, want):
    """Two AVs or arrays alike bit for bit: data, validity, length, type."""
    assert got.dtype is want.dtype and got.length == want.length
    assert got.data.dtype == want.data.dtype and got.data.shape == want.data.shape
    assert got.data.numpy().tobytes() == want.data.numpy().tobytes()
    assert (got.validity is None) == (want.validity is None)
    if got.validity is not None:
        assert torch.equal(got.validity, want.validity)


@pytest.mark.parametrize("shape", TAKE_SHAPES, ids=lambda s: f"cap{s[0]}-len{s[1]}")
@pytest.mark.parametrize("nulls", [False, True], ids=["no_validity", "validity"])
@pytest.mark.parametrize("kind", TAKE_KINDS)
def test_plain_matches_take_column_by_column(kind, nulls, shape):
    cap, length = shape
    rng = np.random.default_rng([TAKE_KINDS.index(kind), nulls, cap, length])
    cols = [exact_column(rng, kind, TAKE_SRC_ROWS, nulls), exact_column(rng, kind, TAKE_SRC_ROWS + 3, nulls)]
    idx = [index_plane(rng, cap, length, TAKE_SRC_ROWS), index_plane(rng, cap, length, TAKE_SRC_ROWS + 3)]
    picked = [(array_av(cols[0]), 0), (array_av(cols[1]), 1), (array_av(cols[0]), 1)]
    outs = TT.take_columns_plain(picked, [i.data for i in idx], length)
    for (av, p), out in zip(picked, outs):
        col = cols[0] if av.data is cols[0].data else cols[1]
        same(out, TK.take(col, idx[p]))
        data, valid = oracle(col, idx[p], length)
        assert out.data.numpy().tobytes() == data
        if valid is not None:
            assert np.array_equal(_bits_of(out.validity, cap), valid)
        tail = out.data.numpy()[TB.num_words(length) if kind == "bool" else length:]
        assert not tail.any(), "data past the length must be zero"
        if out.validity is not None:
            assert not _bits_of(out.validity, TB.num_words(cap) * 32)[length:].any()


@pytest.mark.parametrize("emit", ["cpu", "plain_versions"])
def test_operators_entry_takes_the_plain_version(emit):
    """On CPU tensors, and inside plain_versions(), compute.kernels'
    entry computes with the plain version and counts no launch; more than
    MAX_COLUMNS columns are one call."""
    rng = np.random.default_rng(7)
    cols = [exact_column(rng, kind, TAKE_SRC_ROWS, i % 2 == 0) for i, kind in enumerate(TAKE_KINDS * 2)]
    assert len(cols) > TT.MAX_COLUMNS
    idx = [index_plane(rng, 200, 133, TAKE_SRC_ROWS), index_plane(rng, 200, 133, TAKE_SRC_ROWS)]
    picked = [(array_av(c), i % 2) for i, c in enumerate(cols)]
    before = TT.KERNEL.launches
    if emit == "cpu":
        outs = TCK.take_columns(picked, [i.data for i in idx], 133)
    else:
        with TCK.plain_versions():
            outs = TCK.take_columns(picked, [i.data for i in idx], 133)
    assert TT.KERNEL.launches == before and len(outs) == len(cols)
    for (av, p), out, col in zip(picked, outs, cols):
        same(out, TK.take(col, idx[p]))


def test_wrapper_checks_its_arguments():
    rng = np.random.default_rng(3)
    col = array_av(exact_column(rng, "int32", TAKE_SRC_ROWS, True))
    p = index_plane(rng, 64, 40, TAKE_SRC_ROWS).data
    assert TT._check([(col, 0), (col, 1)], [p, p], 40) == 64
    bad = [
        ([(col, 0)], [p, p, p], 40, "index planes"),
        ([(col, 0)], [p, p[:32]], 40, "rows"),
        ([(col, 0)], [p], 65, "outside"),
        ([(col, 1)], [p], 40, "reads index plane"),
        ([(col, 0)], [p.to(torch.int64)], 40, "int32"),
        ([(col._replace(data=col.data[:0]), 0)], [p], 40, "empty"),
        ([(col._replace(validity=col.validity.to(torch.int64)), 0)], [p], 40, "int32 words"),
    ]
    for columns, planes, length, what in bad:
        with pytest.raises(ValueError, match=what):
            TT._check(columns, planes, length)
    with pytest.raises(ValueError, match="CUDA"):
        TT.take_columns_cuda([(col, 0)], [p], 40)


HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE.parent / "arrow_tpu_torch" / "csrc" / "take_columns.cu"
LAUNCH = re.compile(r"(\w+)<<<(\w+), (\w+), 0, \w+>>>\((\w+)\);")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/take_columns.cu built for the host with g++, its launch run by
    the shim's emulation; declared as the wrapper declares the card's."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("take_columns_host")
    shutil.copy(HERE / "cuda_host_shim.h", d / "cuda_runtime.h")
    src, n = LAUNCH.subn(r"emulate_launch(\2, \3, [&] { \1(\4); });", SOURCE.read_text())
    assert n == 1, "the kernel's launch line moved"
    (d / "take_columns.cpp").write_text(src)
    lib = d / "libtake_columns_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", str(d), "-o", str(lib),
                    str(d / "take_columns.cpp")], check=True, capture_output=True)
    return TT.declare(ctypes.CDLL(str(lib)))


@pytest.mark.parametrize("ncols", [1, 3, 16, 17, 33])
@pytest.mark.parametrize("shape", [*TAKE_SHAPES[1:], (1000, 999), (4099, 3001)], ids=lambda s: f"cap{s[0]}-len{s[1]}")
def test_kernel_source_on_the_host_matches_plain(host_kernel, shape, ncols):
    """Every width, BOOL and validity mixed over both planes, one launch a
    16 columns, sources one row into their buffers; bit for bit."""
    cap, length = shape
    rng = np.random.default_rng([cap, length, ncols])
    cols = [array_av(exact_column(rng, kind, TAKE_SRC_ROWS + 1000 * (i % 2), i % 3 == 0))
            for i, kind in enumerate((TAKE_KINDS * 4)[:ncols])]
    cols = [c if i % 4 != 3 or c.dtype is A.BOOL else c._replace(data=c.data[1:]) for i, c in enumerate(cols)]
    planes = [index_plane(rng, cap, length, TAKE_SRC_ROWS + 1000 * i).data for i in range(2)]
    columns = [(c, i % 2) for i, c in enumerate(cols)]
    assert TT._check(columns, planes, length) == cap
    outs = TT.outputs(columns, cap, length, "cpu")
    assert TT.launch(host_kernel, columns, planes, length, outs, None) == -(-ncols // TT.MAX_COLUMNS)
    for got, want in zip(outs, TT.take_columns_plain(columns, planes, length)):
        same(got, want)
