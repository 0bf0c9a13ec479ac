"""save_table/load_table of arrow_tpu_torch against arrow_tpu: a table saved
by either package loads in the other (and in itself) as the same table,
every dtype, with and without nulls, bool columns of lengths that end inside
a word, and 0 rows."""

import numpy as np
import pytest

from arrow_tpu import io as jio
from arrow_tpu.table import RecordBatch as JBatch
from arrow_tpu_torch import io as tio
from torch_helpers import NUMERIC, assert_same, batch_to_torch, edge_values, make_pair

ROWS = [0, 1, 45, 300]


def _table(n, seed):
    rng = np.random.default_rng(seed)
    cols = {}
    for name in NUMERIC + ["bool"]:
        vals = edge_values(name, n, rng)
        cols[name] = make_pair(name, vals)[0]
        cols[f"{name}_nulls"] = make_pair(name, vals, rng.random(n) < 0.6)[0]
    return JBatch(cols)


def _same_table(jb, tb):
    assert jb.column_names == tb.column_names and jb.num_rows == tb.num_rows
    for name in jb.column_names:
        assert_same(jb[name], tb[name])


@pytest.mark.parametrize("n", ROWS)
def test_jax_saved_loads_in_the_port(tmp_path, n):
    jb = _table(n, n)
    jio.save_table(str(tmp_path / "t.npz"), jb)
    _same_table(jb, tio.load_table(str(tmp_path / "t.npz"), device="cpu"))


@pytest.mark.parametrize("n", ROWS)
def test_port_saved_loads_in_jax(tmp_path, n):
    jb = _table(n, 100 + n)
    tio.save_table(str(tmp_path / "t.npz"), batch_to_torch(jb))
    _same_table(jio.load_table(str(tmp_path / "t.npz")), batch_to_torch(jb))


@pytest.mark.parametrize("n", ROWS)
def test_port_round_trip(tmp_path, n):
    jb = _table(n, 200 + n)
    tio.save_table(str(tmp_path / "t.npz"), batch_to_torch(jb))
    _same_table(jb, tio.load_table(str(tmp_path / "t.npz"), device="cpu"))
    with np.load(str(tmp_path / "t.npz")) as z:  # the JAX package's layout
        assert int(z["__length__"]) == n and str(z["t::uint64"]) == "uint64"
        assert "v::int8" not in z.files
        assert ("v::int8_nulls" in z.files) == (jb["int8_nulls"].validity is not None)
