"""The rest of a run, on the CPU at a small size, with the timed path
broken underneath: each fault a cell can have makes ``correct`` false.
The cells are on one chip and hold no state across queries, so the faults
are half of the rows left out and an answer altered where it is produced
(no exchange between chips, no state to leave unchanged)."""

import pytest
import torch

import arrow_tpu_torch as att
from portbench import harness

CELLS = {
    "h2o-groupby-1e8-k100.q1-q2": "hash_aggregate",
    "h2o-groupby-1e8-k100.q3-q4-q5": "hash_aggregate",
    "h2o-join-1e8.q5-big": "hash_join",
    "h2o-join-1e8.q1-q2-small-medium": "hash_join",
}


def _half(arr):
    n = arr.length // 2
    return att.PrimitiveArray.from_torch(arr.data[:n].clone(), dtype=arr.dtype)


def _altered(batch, name):
    cols = batch.columns()
    col = cols[name]
    data = col.data.clone()
    data[col.length // 2] += 1
    cols[name] = att.PrimitiveArray.from_torch(data, length=col.length, dtype=col.dtype)
    return att.RecordBatch(cols)


def _broken(op, fault):
    orig = getattr(att.compute, op)
    if op == "hash_aggregate":
        def call(keys, aggs, *a, **kw):
            if fault == "half":
                return orig(_half(keys), [(n, _half(c), k) for n, c, k in aggs], *a, **kw)
            out = orig(keys, aggs, *a, **kw)
            return _altered(out, aggs[0][0])
    else:
        def call(left, right, *a, **kw):
            if fault == "half":
                left = att.RecordBatch({n: _half(c) for n, c in left.columns().items()})
                return orig(left, right, *a, **kw)
            out = orig(left, right, *a, **kw)
            return _altered(out, [n for n in out.column_names if n.startswith("v")][0])
    return call


@pytest.mark.parametrize("fault", ["half", "altered"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(small_catalog, monkeypatch, cell, fault):
    monkeypatch.setattr(att.compute, CELLS[cell], _broken(CELLS[cell], fault))
    result = harness.run_cell(small_catalog, cell, 77, 0.3, False, torch.device("cpu"), 0.0)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(small_catalog, cell):
    result = harness.run_cell(small_catalog, cell, 78, 0.3, False, torch.device("cpu"), 0.0)
    assert result["correct"] is True
