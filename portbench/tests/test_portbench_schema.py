"""BENCHMARK.json against the benchmark's contract, and the result line's
schema from runs at a small size on the CPU."""

import json
import re
import sys

import pytest
import torch

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"] == []
        assert c["name"] in used


def test_workloads():
    assert 1 <= len(CELLS) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert NAME.match(w["traffic"]) and w["name"] == f"{w['config']}.{w['traffic']}"
        cell = harness.Catalog().json("cells", w["name"])
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    cat = harness.Catalog()
    for cell in CELLS:
        names = {m["name"] for m in cat.metrics(cell, False)}
        assert "setup_s" in names and len(names) >= 2 and cat.metrics(cell, True)
        for m in cat.metrics(cell, False) + cat.metrics(cell, True):
            assert callable(cat.reader(m["name"], cat.json("cells", cell)).read), (cell, m["name"])
        for m in cat.metrics(cell, True):  # the metric it moves is one the cell reports
            assert m["moves"] in names, (cell, m["name"])


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["h2o-groupby-1e8-k100.q1-q2", "h2o-join-1e8.q1-q2-small-medium"])
def test_result_line(small_catalog, cell, traced):
    result = harness.run_cell(small_catalog, cell, 2**33 + 5, 0.3, traced, torch.device("cpu"), 0.0)
    json.loads(json.dumps(result))
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if traced else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    units = {m["name"]: m["unit"] for m in small_catalog.metrics(cell, traced)}
    assert result["metrics"] and all(v["unit"] == units[k] for k, v in result["metrics"].items())
    assert all(isinstance(v["value"], float) for v in result["metrics"].values())
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert dev["window_s"] > 0 and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(result["breakdown"][k]) <= 10 for k in result["breakdown"])
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]


def test_no_device_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]
