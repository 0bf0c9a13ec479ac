"""Kernel B2 (inclusive segmented scan): the plain PyTorch version against
arrow_tpu's segmented_scan_pallas and segscan_pallas (interpret mode on the
CPU; the latter for 2 and 3 planes that share one flag plane) and its XLA
ladder.  The CUDA kernel is held against the plain version in
test_torch_cuda.py.

Integer results are exact.  f32 add differs from the Pallas kernel only in
summation order (block ladder + carry against one ladder over all rows), so
it is held to rtol=1e-6 on positive values; the f64 ladder adds in the JAX
CPU order and is exact."""

import numpy as np
import pytest
import torch

from arrow_tpu.compute.kernels.segscan import (
    combine_add, combine_first, combine_max, segmented_scan_pallas, segscan_pallas,
)
from arrow_tpu.utils import scans as JS
from arrow_tpu_torch.compute import kernels as CK
from arrow_tpu_torch.compute.kernels import segscan as S

N = 65536
OPS = ["add", "max", "min", "first"]
# (dtype, ops) that the Pallas kernel computes: its 64-bit path has add and
# first only; u32 add/first are the i32 bits
PALLAS_CASES = (
    [("int32", op) for op in OPS]
    + [("uint32", op) for op in ("max", "min")]
    + [("float32", op) for op in OPS]
    + [("int64", op) for op in ("add", "first")]
)


def _values(rng, name, n):
    if name == "float32":
        return rng.random(n).astype(np.float32)
    if name == "float64":
        return rng.standard_normal(n)
    info = np.iinfo(np.dtype(name))
    return rng.integers(info.min, info.max, n, dtype=np.dtype(name), endpoint=True)


def _torch(v):
    unsigned = v.dtype.kind == "u"
    if unsigned:
        v = v.view(np.int32 if v.dtype.itemsize == 4 else np.int64)
    return torch.from_numpy(v), unsigned


@pytest.mark.parametrize("name,op", PALLAS_CASES)
def test_plain_matches_pallas(name, op):
    import jax.numpy as jnp

    rng = np.random.default_rng([PALLAS_CASES.index((name, op))])
    vals = _values(rng, name, N)
    tv, unsigned = _torch(vals)
    for density in (0.0, 0.001, 0.3):  # 0.0: no starts, the plain scan
        flags = rng.random(N) < density
        want = np.asarray(segmented_scan_pallas(jnp.asarray(vals), jnp.asarray(flags), op, interpret=True))
        tflags = torch.from_numpy(flags) if density else None
        got = S.segmented_scan_plain(tv, tflags, op, unsigned).numpy()
        got = got.view(want.dtype)
        if name == "float32" and op == "add":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,op", [
    ("int64", "max"), ("int64", "min"), ("uint64", "max"), ("uint64", "min"),
    ("float64", "add"), ("float64", "max"),
])
def test_plain_matches_xla_ladder(name, op):
    import jax.numpy as jnp

    combine = {"add": lambda a, b: a + b, "max": jnp.maximum, "min": jnp.minimum}[op]
    rng = np.random.default_rng(7)
    vals = _values(rng, name, 4099)
    flags = rng.random(4099) < 0.01
    want = np.asarray(JS.segmented_scan(jnp.asarray(vals), jnp.asarray(flags), combine))
    tv, unsigned = _torch(vals)
    got = S.segmented_scan_plain(tv, torch.from_numpy(flags), op, unsigned).numpy()
    np.testing.assert_array_equal(got.view(want.dtype), want)


def test_f64_add_tolerance_rejects_f32_accumulation():
    """The f64 add tolerance that holds the CUDA kernel to its plain version
    (1e-12) admits a change of summation order, and rejects a scan that
    accumulates the f64 values in f32."""
    rng = np.random.default_rng(3)
    vals = rng.random(N) + 0.5
    flags = rng.random(N) < 0.001
    flags[0] = True
    got = S.segmented_scan_plain(torch.from_numpy(vals), torch.from_numpy(flags), "add").numpy()
    in_order = np.concatenate([np.cumsum(seg) for seg in np.split(vals, np.flatnonzero(flags)[1:])])
    np.testing.assert_allclose(got, in_order, rtol=1e-12, atol=0)
    f32 = S.segmented_scan_plain(torch.from_numpy(vals).float(), torch.from_numpy(flags), "add")
    assert np.max(np.abs(f32.double().numpy() - got) / got) > 1e-12


def test_wrapper_routes_by_device_and_checks_args():
    v = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    f = torch.tensor([False, False, True, False])
    assert S.segmented_scan(v, f, "add").tolist() == [1, 3, 3, 7]
    assert S.segmented_scan(v, None, "first").tolist() == [1, 1, 1, 1]
    with pytest.raises(ValueError):
        S.segmented_scan_cuda(v, f, "add")
    with pytest.raises(ValueError):
        S.segmented_scan(v, f, "mul")
    with pytest.raises(ValueError):
        S.segmented_scan(v.to(torch.int16), f, "add")


MULTI_N = 16384
MULTI_COMBINES = {"max": combine_max, "add": combine_add, "first": combine_first}


@pytest.mark.parametrize("nplanes", [2, 3])
@pytest.mark.parametrize("op", list(MULTI_COMBINES))
def test_multi_plain_matches_pallas(op, nplanes):
    """int32 planes sharing one flag plane, as the JAX join fills (key,
    probe row, lo) in one segscan_pallas call; exact (int32 adds wrap in
    both packages)."""
    import jax.numpy as jnp

    rng = np.random.default_rng([nplanes, len(op)])
    planes = [rng.integers(-(2**31), 2**31, MULTI_N).astype(np.int32) for _ in range(nplanes)]
    for density in (0.0, 0.001, 0.3):  # 0.0: no starts, the plain scan
        flags = rng.random(MULTI_N) < density
        want = segscan_pallas(
            tuple(jnp.asarray(p) for p in planes), jnp.asarray(flags) if density else None,
            MULTI_COMBINES[op], interpret=True,
        )
        tflags = torch.from_numpy(flags) if density else None
        got = S.segmented_scan_multi_plain([torch.from_numpy(p) for p in planes], tflags, op)
        assert len(got) == nplanes
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _bad_planes():
    v = torch.arange(8, dtype=torch.int32)
    return {
        "none": [],
        "four": [v] * 4,
        "mixed_dtype": [v, v.to(torch.int64)],
        "mixed_length": [v, v[:7]],
        "mixed_device": [v, torch.zeros(8, dtype=torch.int32, device="meta")],
    }


@pytest.mark.parametrize("case", list(_bad_planes()))
@pytest.mark.parametrize(
    "fn", [S.segmented_scan_multi, S.segmented_scan_multi_plain, S.segmented_scan_multi_cuda],
    ids=["wrapper", "plain", "cuda"],
)
def test_multi_rejects_bad_planes(fn, case):
    with pytest.raises(ValueError):
        fn(_bad_planes()[case], None, "max")


def test_multi_routes_by_device():
    """On CPU tensors the wrapper (and the operators' entry, inside
    plain_versions() or not) gives the plain version on each plane; the
    CUDA launcher refuses CPU tensors."""
    rng = np.random.default_rng(11)
    planes = [torch.from_numpy(rng.integers(-50, 50, 1000).astype(np.int32)) for _ in range(3)]
    flags = torch.from_numpy(rng.random(1000) < 0.05)
    want = [S.segmented_scan_plain(p, flags, "max") for p in planes]
    for got in (S.segmented_scan_multi(planes, flags, "max"), CK.segmented_scan_multi(planes, flags, "max")):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with CK.plain_versions():
        assert all(torch.equal(g, w) for g, w in zip(CK.segmented_scan_multi(planes, flags, "max"), want))
    assert torch.equal(S.segmented_scan(planes[0], flags, "max"), want[0])
    with pytest.raises(ValueError):
        S.segmented_scan_multi_cuda(planes, flags, "max")
