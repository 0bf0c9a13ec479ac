"""Kernel B1 (stable multi-plane compaction): the plain PyTorch version
against arrow_tpu's compact_multi_pallas (interpret mode on the CPU).  The CUDA kernel is held against the plain
version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from arrow_tpu.compute.kernels.compaction3 import compact_multi_pallas
from arrow_tpu.utils import bits as JB
from arrow_tpu_torch.compute.kernels import compaction3 as C3
from arrow_tpu_torch.utils import bits as TB
from torch_helpers import EDGE_PATTERNS, edge_pattern

SELECTIVITIES = [0.0, 0.01, 0.5, 0.99, 1.0]


def _inputs(rng, n, sel):
    vals = [
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
        rng.standard_normal(n).astype(np.float32),
        rng.integers(0, 2**32, n, dtype=np.uint32),
    ]
    words = [JB.pack_bits_np(rng.random(n) < p, n // 32) for p in (0.3, 0.8)]
    mask = JB.pack_bits_np(rng.random(n) < sel, n // 32)
    return vals, words, mask


def _assert_matches_pallas(vals, words, mask, n):
    import jax.numpy as jnp

    jv, jw, jc = compact_multi_pallas(
        tuple(jnp.asarray(v) for v in vals),
        tuple(jnp.asarray(w) for w in words),
        jnp.asarray(mask),
    )
    tv, tw, tc = C3.compact_multi_plain(
        [torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v) for v in vals],
        [torch.from_numpy(w.view(np.int32)) for w in words],
        torch.from_numpy(mask.view(np.int32)),
    )
    assert int(tc) == int(jc)
    for j, t in zip(jv, tv):  # first n rows exact, zeros from the count on
        np.testing.assert_array_equal(t.numpy().view(np.uint8), np.asarray(j)[:n].view(np.uint8))
    for j, t in zip(jw, tw):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j)[:n])


@pytest.mark.parametrize("n", [8192, 65536])
def test_plain_matches_pallas(n):
    for i, sel in enumerate(SELECTIVITIES):
        rng = np.random.default_rng([n, i])
        vals, words, mask = _inputs(rng, n, sel)
        _assert_matches_pallas(vals, words, mask, n)


@pytest.mark.parametrize("pattern", EDGE_PATTERNS)
@pytest.mark.parametrize("n", [8192, 16384])
def test_plain_matches_pallas_on_edge_patterns(n, pattern):
    rng = np.random.default_rng([n, len(pattern)])
    vals, words, _ = _inputs(rng, n, 0.5)
    _assert_matches_pallas(vals, words, JB.pack_bits_np(edge_pattern(pattern, n), n // 32), n)


@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 8193])
def test_plain_any_length_and_width(n):
    rng = np.random.default_rng(n)
    a = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)
    b = rng.standard_normal(n)
    c = rng.integers(0, 100, n).astype(np.int32)
    flags = rng.random(n) < 0.4
    wflags = rng.random(n) < 0.5
    mask = torch.from_numpy(TB.pack_bits_np(flags).view(np.int32))
    words = torch.from_numpy(TB.pack_bits_np(wflags).view(np.int32))
    (oa, ob, oc), (ow,), count = C3.compact_multi(
        [torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)], [words], mask, n
    )
    k = int(flags.sum())
    assert int(count) == k and count.dtype == torch.int32
    for out, src in ((oa, a), (ob, b), (oc, c), (ow, wflags.astype(np.int32))):
        assert out.shape[0] == n
        np.testing.assert_array_equal(out.numpy()[:k], src[flags])
        assert not out.numpy()[k:].any()


def test_wrapper_routes_by_device():
    mask = torch.tensor([0b1011], dtype=torch.int32)
    vals = torch.arange(4, dtype=torch.int32)
    (out,), _, count = C3.compact_multi([vals], [], mask)
    assert out.tolist() == [0, 1, 3, 0] and int(count) == 3
    with pytest.raises(ValueError):
        C3.compact_multi_cuda([vals], [], mask)
