"""Each question's least bytes, and the kernel formulas, against hand counts."""

import pytest
import torch

from portbench import counting

#: the columns each question reads, and its tables
READ = {
    "groupby_q1": {"x": ("id1", "v1")}, "groupby_q2": {"x": ("id1", "id2", "v1")},
    "groupby_q3": {"x": ("id3", "v1", "v3")}, "groupby_q4": {"x": ("id4", "v1", "v2", "v3")},
    "groupby_q5": {"x": ("id6", "v1", "v2", "v3")},
}


@pytest.mark.parametrize("question", sorted(READ))
def test_groupby_question_bytes(small_catalog, question):
    config = small_catalog.json("configs", "h2o-groupby-1e8-k100")
    raw = small_catalog.module("datagen", "h2o_groupby").make(config, ["x"], 1, torch.device("cpu"))
    q = small_catalog.module("questions", question)
    n = config["N"]
    width = {"int32": 4, "uint32": 4, "float64": 8}
    read = sum(n * width[config["tables"]["x"][c]] for c in READ[question]["x"])
    result = {"key": (123, 4), "v1": (123, 8)}
    assert counting.question_bytes(q, raw, result) == read + 123 * 12
    assert q.OPERATOR == "groupby" and q.TABLES == ("x",)


@pytest.mark.parametrize("question,build", [("join_q1", "small"), ("join_q2", "medium"), ("join_q5", "big")])
def test_join_question_bytes(small_catalog, question, build):
    config = small_catalog.json("configs", "h2o-join-1e8")
    raw = small_catalog.module("datagen", "h2o_join").make(config, ["x", build], 1, torch.device("cpu"))
    q = small_catalog.module("questions", question)
    width = {"uint32": 4, "float64": 8}
    read = sum(config["rows"][t] * width[ty] for t in ("x", build) for ty in config["tables"][t].values())
    assert read == sum(c.numel() * c.element_size() for t in ("x", build) for c in raw[t].values())
    result = {"id1": (10, 4), "v1": (10, 8)}
    assert counting.question_bytes(q, raw, result) == read + 120
    assert q.OPERATOR == "join" and q.TABLES == ("x", build)


def test_kernel_formulas():
    i32 = torch.zeros(1000, dtype=torch.int32)
    i64 = torch.zeros(1000, dtype=torch.int64)
    flags = torch.zeros(1000, dtype=torch.bool)
    assert counting.radix_sort(None, [i32, i64], 32, 600)[0] == 2 * 600 * 12
    assert counting.merge_pass(None, [i32, i32, i32], 8)[0] == 3 * 2 * 4000
    assert counting.segmented_scan(None, i64, flags, "add")[0] == 16000 + 1000
    assert counting.segmented_scan(None, i32, None, "max")[0] == 8000
    assert counting.segmented_scan_multi(None, [i32, i32, i32], flags, "max")[0] == 24000 + 1000
    count = torch.tensor(250, dtype=torch.int32)
    fixed, got, per_row = counting.compact_multi(((i32, i64), (), count), [i32, i64], [], None)
    assert (fixed, int(got), per_row) == (125 + 12000, 250, 12)
    assert counting.groupby_dense(None, i32, i32, 2, 700)[0] == 700 * 8 + 4096 * 12
    assert counting.groupby_region(None, i32, i32, 2, 4)[0] == 8000 + 4 * 4096 * 12
    assert set(counting.KERNEL_CALLS) == {
        "radix_sort", "merge_pass", "segmented_scan", "segmented_scan_multi", "compact_multi",
        "groupby_dense", "groupby_region"}


def test_peaks():
    assert counting.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert counting.peak_bytes_per_s("cpu") is None
