"""A configuration, a cell, a metric and a judge added as files are found
by name, with no edit to any existing file."""

import copy
import json

import pytest
import torch

from portbench import harness


def test_new_cell_config_and_metric_found_by_name(tmp_path):
    base = tmp_path
    for sub in ("configs", "cells", "metrics"):
        (base / sub).mkdir()
    config = json.loads((harness.HERE / "configs" / "h2o-groupby-1e8-k100.json").read_text())
    config.update(name="tiny-groupby", N=5000, K=5)
    (base / "configs" / "tiny-groupby.json").write_text(json.dumps(config))
    cell = json.loads((harness.HERE / "cells" / "h2o-groupby-1e8-k100.q1-q2.json").read_text())
    cell.update(config="tiny-groupby", questions=["groupby_q5", "groupby_q1"], trace_rounds=3)
    (base / "cells" / "tiny-groupby.mix.json").write_text(json.dumps(cell))
    (base / "metrics" / "queries_done.py").write_text("def read(w):\n    return float(len(w.latencies))\n")
    bench = copy.deepcopy(json.loads((harness.ROOT / "BENCHMARK.json").read_text()))
    bench["workloads"].append({"name": "tiny-groupby.mix", "config": "tiny-groupby", "traffic": "mix",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("query_ms_p95", "rows_per_s"):
            m["workloads"].append("tiny-groupby.mix")
    bench["end_to_end"].append({"name": "queries_done", "unit": "queries", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["tiny-groupby.mix"]})
    cat = harness.Catalog(bases=[base, harness.HERE], benchmark=bench)
    assert cat.workload("tiny-groupby.mix")["config"] == "tiny-groupby"
    result = harness.run_cell(cat, "tiny-groupby.mix", 11, 0.2, False, torch.device("cpu"), 0.0)
    assert result["correct"] is True
    assert result["metrics"]["queries_done"]["value"] == result["attempted"]
    assert {"setup_s", "rows_per_s", "query_ms_p95"} <= set(result["metrics"])
    other = {m["name"] for m in cat.metrics("h2o-groupby-1e8-k100.q1-q2", False)}
    assert "queries_done" not in other


def test_new_operator_judge_found_by_name(tmp_path):
    (tmp_path / "judges").mkdir()
    (tmp_path / "judges" / "scalar.py").write_text(
        "def compare(program, reference):\n    return {'value': abs(program['s'] - reference['s'])}\n")
    cat = harness.Catalog(bases=[tmp_path, harness.HERE])
    assert cat.module("judges", "scalar").compare({"s": 3}, {"s": 5}) == {"value": 2}
    assert cat.module("judges", "join").compare({"k": torch.tensor([1])}, {"k": torch.tensor([1])})["rows"] == 0


def test_suffixed_metric_reads_with_the_base_reader():
    cat = harness.Catalog()
    cell = cat.json("cells", "h2o-groupby-1e8-k100.q1-q2")
    assert cell["metric_suffix"] == ".host"
    assert cat.reader("rows_per_s.host", cell) is cat.module("metrics", "rows_per_s")
    assert cat.reader("kernels.hand_share.host", cell) is cat.module("metrics", "kernels.hand_share")
    with pytest.raises(FileNotFoundError):
        cat.reader("rows_per_s.host", cat.json("cells", "h2o-join-1e8.q5-big"))
