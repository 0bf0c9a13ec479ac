"""On the card: a traced run at a small size holds every launch in its
trace and reads every per-layer metric, and a measured run's peak leaves
out the results it keeps for its check.  Skips without a CUDA device."""

import pytest

from portbench import harness

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell", ["h2o-groupby-1e8-k100.q3-q4-q5", "h2o-join-1e8.q5-big"])
def test_traced_run_on_the_card(small_catalog, cuda, cell):
    result = harness.run_cell(small_catalog, cell, 31, 0.5, True, cuda, 0.0)
    assert result["correct"] is True
    want = {m["name"] for m in small_catalog.metrics(cell, True)}
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        if name.endswith("_roofline") or name.endswith("_share"):
            assert 0 < m["value"] <= 100, name
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.parametrize("cell", ["h2o-groupby-1e8-k100.q1-q2", "h2o-join-1e8.q1-q2-small-medium"])
def test_peak_leaves_out_the_kept_results(small_catalog, cuda, cell):
    result = harness.run_cell(small_catalog, cell, 32, 0.5, False, cuda, 0.0)
    assert result["correct"] is True
    peak = result["metrics"]["peak_mem_gib"]["value"] * 2**30
    assert 0 < peak < result["device"]["memory_peak_bytes"]
