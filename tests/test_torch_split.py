"""Kernels B8 (stable dual-output split) and B9 (single-plane compaction):
the plain PyTorch versions against arrow_tpu's split_multi_pallas (mask and
bit forms) and compact_pallas, both run interpreted here as
``tests/test_filter_pallas.py`` runs them.  The JAX outputs carry capacity
slack past n; the first n rows are compared, exactly.  The CUDA kernels are
held against the plain versions in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from arrow_tpu.compute.kernels.compaction import compact_pallas
from arrow_tpu.compute.kernels.compaction3 import split_multi_pallas
from arrow_tpu.utils import bits as JB
from arrow_tpu_torch.compute.kernels import compaction as C1
from arrow_tpu_torch.compute.kernels import compaction3 as C3
from torch_helpers import EDGE_PATTERNS, edge_pattern

N = 16384
SELECTIVITIES = [0.0, 0.03, 0.5, 1.0]


def _planes(rng):
    a = rng.integers(-(2**31), 2**31, N).astype(np.int32)
    b = rng.standard_normal(N).astype(np.float32)
    return a, b


def _torch(*arrays):
    return [torch.from_numpy(x) for x in arrays]


def _assert_split(jout, tout, n):
    (jsel, junsel, jc), (tsel, tunsel, tc) = jout, tout
    c = int(tc)
    assert c == int(jc) and tc.dtype == torch.int32
    for j, t in zip(jsel, tsel):
        np.testing.assert_array_equal(t.numpy().view(np.int32), np.asarray(j)[:n])
    for j, t in zip(junsel, tunsel):
        np.testing.assert_array_equal(t.numpy().view(np.int32), np.asarray(j)[:n])
    for t in tsel:
        assert not t.numpy()[c:].any()
    for t in tunsel:
        assert not t.numpy()[n - c:].any()


@pytest.mark.parametrize("sel_p", SELECTIVITIES)
def test_split_mask_form_matches_pallas(sel_p):
    import jax.numpy as jnp

    rng = np.random.default_rng(int(sel_p * 100) + 3)
    a, b = _planes(rng)
    mask = rng.random(N) < sel_p
    mw = JB.pack_bits_np(mask, N // 32)
    jout = split_multi_pallas((jnp.asarray(a), jnp.asarray(b.view(np.int32))), jnp.asarray(mw))
    tout = C3.split_multi(_torch(a, b), torch.from_numpy(mw.view(np.int32)))
    _assert_split(jout, tout, N)
    np.testing.assert_array_equal(tout[0][0].numpy()[: mask.sum()], a[mask])
    np.testing.assert_array_equal(tout[1][1].numpy()[: N - mask.sum()], b[~mask])


@pytest.mark.parametrize("pattern", EDGE_PATTERNS)
@pytest.mark.parametrize("n", [8192, 16384])
def test_split_mask_form_matches_pallas_on_edge_patterns(n, pattern):
    import jax.numpy as jnp

    rng = np.random.default_rng([n, len(pattern)])
    a = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    b = rng.standard_normal(n).astype(np.float32)
    mask = edge_pattern(pattern, n)
    mw = JB.pack_bits_np(mask, n // 32)
    jout = split_multi_pallas((jnp.asarray(a), jnp.asarray(b.view(np.int32))), jnp.asarray(mw))
    tout = C3.split_multi_plain(_torch(a, b), torch.from_numpy(mw.view(np.int32)))
    _assert_split(jout, tout, n)
    np.testing.assert_array_equal(tout[0][0].numpy()[: mask.sum()], a[mask])
    np.testing.assert_array_equal(tout[1][1].numpy()[: n - mask.sum()], b[~mask])


@pytest.mark.parametrize("bit", [0, 13, 31])
def test_split_bit_form_matches_pallas(bit):
    """Rows whose plane-0 bit is zero are the selected ones."""
    import jax.numpy as jnp

    rng = np.random.default_rng(bit)
    a, b = _planes(rng)
    jout = split_multi_pallas((jnp.asarray(a), jnp.asarray(b.view(np.int32))), bit=bit)
    tout = C3.split_multi(_torch(a, b), bit=bit)
    _assert_split(jout, tout, N)
    assert int(tout[2]) == int((((a.view(np.uint32) >> bit) & 1) == 0).sum())


@pytest.mark.parametrize("n", [0, 1, 33, 8193])
def test_split_any_length(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2**31, n).astype(np.int32)
    flags = rng.random(n) < 0.4
    mask = torch.from_numpy(JB.pack_bits_np(flags).view(np.int32))
    (sa,), (ua,), c = C3.split_multi([torch.from_numpy(a)], mask)
    k = int(flags.sum())
    assert int(c) == k and sa.shape[0] == ua.shape[0] == n
    np.testing.assert_array_equal(sa.numpy()[:k], a[flags])
    np.testing.assert_array_equal(ua.numpy()[: n - k], a[~flags])


def test_split_wrapper_routes_and_checks():
    a = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        C3.split_multi_cuda([a], bit=3)
    with pytest.raises(ValueError):  # both selections
        C3.split_multi([a], torch.zeros(2, dtype=torch.int32), bit=1)
    with pytest.raises(ValueError):  # 8-byte plane
        C3.split_multi([a.to(torch.int64)], bit=1)
    with pytest.raises(ValueError):
        C3.split_multi([a] * 9, bit=1)


@pytest.mark.parametrize("sel_p", SELECTIVITIES)
def test_compact_matches_pallas(sel_p):
    import jax.numpy as jnp

    rng = np.random.default_rng(int(sel_p * 100) + 5)
    vals = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(N) < sel_p
    mw = JB.pack_bits_np(mask, N // 32)
    jout, jc = compact_pallas(jnp.asarray(vals), jnp.asarray(mw), interpret=True)
    out, c = C1.compact(torch.from_numpy(vals.view(np.int32)), torch.from_numpy(mw.view(np.int32)))
    k = int(c)
    assert k == int(jc) == int(mask.sum()) and out.shape[0] == N
    np.testing.assert_array_equal(out.numpy().view(np.uint32)[:k], np.asarray(jout)[:k])
    np.testing.assert_array_equal(out.numpy().view(np.uint32)[:k], vals[mask])
    assert not out.numpy()[k:].any()


def test_compact_wrapper_routes_and_checks():
    mask = torch.tensor([0b101], dtype=torch.int32)
    out, c = C1.compact(torch.arange(3, dtype=torch.float32), mask)
    assert out.tolist() == [0.0, 2.0, 0.0] and int(c) == 2
    with pytest.raises(ValueError):
        C1.compact_cuda(torch.arange(3, dtype=torch.int32), mask)
    with pytest.raises(ValueError):
        C1.compact(torch.arange(3, dtype=torch.int64), mask)
