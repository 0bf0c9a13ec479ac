"""The whole slice: the flagship query (compare -> filter -> sort group-by) in
both packages, fed the same batch through Arrow buffers; and the port's
independence from JAX."""

import contextlib
import os
import subprocess
import sys

import numpy as np

from arrow_tpu import compute as JC
from arrow_tpu import kernels as JK
from arrow_tpu.table import RecordBatch as JBatch
from arrow_tpu_torch import flagship
from arrow_tpu_torch.compute.kernels import plain_versions
from torch_helpers import assert_same, batch_to_torch

N = 1 << 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_query(jb):
    kept = JC.filter(jb, JK.gt_scalar(jb["v"], 0.0))
    return kept.num_rows, JC.hash_aggregate(
        kept["k"], [("total", kept["v"], "sum"), ("n", None, "count")]
    )


def test_flagship_matches_jax_and_numpy():
    cols = flagship.make_host_columns(N, seed=0)
    jb = JBatch.from_numpy(cols)
    want_rows, want = _jax_query(jb)
    for route in (contextlib.nullcontext, plain_versions):
        with route():
            rows, got = flagship.flagship_query(batch_to_torch(jb))
        assert rows == want_rows
        assert_same(want["key"], got["key"])
        assert_same(want["n"], got["n"])
        assert_same(want["total"], got["total"], rtol=1e-6)
    count, keys, counts, sums = flagship.numpy_reference(cols["k"], cols["v"])
    assert rows == count
    np.testing.assert_array_equal(got["key"].raw_values(), keys)
    np.testing.assert_array_equal(got["n"].raw_values(), counts)
    np.testing.assert_allclose(got["total"].raw_values(), sums, rtol=1e-5)


def test_make_batch_is_entrys_batch():
    b = flagship.make_batch(1000, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(b["k"].raw_values(), rng.integers(0, 10_000, 1000).astype(np.uint32))
    np.testing.assert_array_equal(b["v"].raw_values(), rng.standard_normal(1000).astype(np.float32))
    assert b["k"].dtype.value == "uint32" and b["v"].dtype.value == "float32"


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import arrow_tpu_torch, arrow_tpu_torch.flagship as f\n"
        "rows, g = f.flagship_query(f.make_batch(4096, 0, 'cpu'))\n"
        "assert rows > 0 and g.num_rows > 0\n"
        "kept, g, j, (sk, sv) = f.sort_join_query(f.make_batch(4096, 0, 'cpu'))\n"
        "assert j.num_rows == kept.num_rows == sk.length > 0\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'arrow_tpu.')) for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
