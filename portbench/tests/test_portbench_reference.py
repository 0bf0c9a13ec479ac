"""Each reference against a brute-force loop on tiny tables, and its control
(one precision lower) against the full-precision reference."""

import itertools
import math
import random

import pytest
import torch

from portbench import harness
from portbench.judges import groupby as judge_groupby, join as judge_join
from portbench.reference import common

GROUPBY = ("groupby_q1", "groupby_q2", "groupby_q3", "groupby_q4", "groupby_q5")
JOIN = ("join_q1", "join_q2", "join_q5")
#: each groupby question's key (q2: the composite) and aggregates
SPEC = {
    "groupby_q1": (("id1",), (("v1", "sum"),)),
    "groupby_q2": (("id1", "id2"), (("v1", "sum"),)),
    "groupby_q3": (("id3",), (("v1", "sum"), ("v3", "mean"))),
    "groupby_q4": (("id4",), (("v1", "mean"), ("v2", "mean"), ("v3", "mean"))),
    "groupby_q5": (("id6",), (("v1", "sum"), ("v2", "sum"), ("v3", "sum"))),
}


def _tiny_groupby(rows=300, k=4, seed=5):
    rng = random.Random(seed)
    x = {
        "id1": [rng.randrange(k) for _ in range(rows)], "id2": [rng.randrange(k) for _ in range(rows)],
        "id3": [rng.randrange(7) for _ in range(rows)], "id4": [rng.randrange(1, k + 1) for _ in range(rows)],
        "id5": [rng.randrange(1, k + 1) for _ in range(rows)], "id6": [rng.randrange(1, 8) for _ in range(rows)],
        "v1": [rng.randrange(1, 6) for _ in range(rows)], "v2": [rng.randrange(1, 16) for _ in range(rows)],
        "v3": [round(rng.random() * 100, 6) for _ in range(rows)],
    }
    tensors = {n: torch.tensor(v, dtype=torch.float64 if n == "v3" else torch.int32) for n, v in x.items()}
    config = harness.Catalog().json("configs", "h2o-groupby-1e8-k100")
    config["K"] = k
    return config, x, {"x": tensors}


@pytest.mark.parametrize("question", GROUPBY)
def test_groupby_reference_against_a_loop(question):
    config, x, tables = _tiny_groupby()
    got = harness.Catalog().module("reference", question).run(config, tables)
    keys, aggs = SPEC[question]
    groups = {}
    for i in range(len(x["v1"])):
        key = x[keys[0]][i] if len(keys) == 1 else x["id1"][i] * config["K"] + x["id2"][i]
        groups.setdefault(key, []).append(i)
    assert got["key"].tolist() == sorted(groups)
    for name, kind in aggs:
        for j, key in enumerate(sorted(groups)):
            vals = [x[name][i] for i in groups[key]]
            want = sum(vals) if kind == "sum" else math.fsum(vals) / len(vals)
            if name == "v3" and kind == "sum":
                want = math.fsum(vals)
            assert float(got[name][j]) == pytest.approx(want, rel=1e-12), (name, key)


def test_groupby_control_is_lower_precision():
    config, _x, tables = _tiny_groupby(rows=40000, k=2)
    ref = harness.Catalog().module("reference", "groupby_q4")
    full, lower = ref.run(config, tables), ref.run(config, tables, lower=True)
    numbers = judge_groupby.compare(lower, full)
    assert numbers["f64_rel_err"] > 1e-9  # float32 sums of v3
    assert numbers["keys"] == 0 and numbers["groups"] == 0
    # int16 sums wrap once a group's sum passes 32767 (20000 rows of v2 here)
    assert not torch.equal(lower["v2"], full["v2"])


def test_join_reference_against_a_loop():
    config = {"tables": {
        "l": {"k": "uint32", "a": "uint32", "v": "float64"},
        "r": {"k": "uint32", "a": "uint32", "w": "float64"},
    }}
    rng = random.Random(9)
    left = {"k": [rng.randrange(6) for _ in range(40)], "a": list(range(40)), "v": [rng.random() for _ in range(40)]}
    right = {"k": [rng.randrange(8) for _ in range(15)], "a": list(range(100, 115)),
             "w": [rng.random() for _ in range(15)]}
    mk = lambda cols: {n: torch.tensor(v, dtype=torch.float64 if n in "vw" else torch.int32)  # noqa: E731
                       for n, v in cols.items()}
    got = common.inner_join(config, {"l": mk(left), "r": mk(right)}, "l", "r", "k")
    assert sorted(got) == ["a_l", "a_r", "k", "v", "w"]
    want = sorted(
        (left["k"][i], left["a"][i], left["v"][i], right["a"][j], right["w"][j])
        for i, j in itertools.product(range(40), range(15)) if left["k"][i] == right["k"][j]
    )
    rows = sorted(zip(*(got[n].tolist() for n in ("k", "a_l", "v", "a_r", "w"))))
    assert rows == want
    lower = common.inner_join(config, {"l": mk(left), "r": mk(right)}, "l", "r", "k", lower=True)
    assert judge_join.compare(lower, got)["rows"] > 0
    assert judge_join.compare(got, got) == {"columns": 0, "rows": 0}


def test_join_compare_is_a_multiset_compare():
    a = {"k": torch.tensor([3, 1, 2, 2]), "v": torch.tensor([0.5, 1.5, 2.5, 2.5], dtype=torch.float64)}
    shuffled = {n: t[torch.tensor([2, 0, 3, 1])] for n, t in a.items()}
    assert judge_join.compare(shuffled, a) == {"columns": 0, "rows": 0}
    one_off = {"k": a["k"].clone(), "v": a["v"].clone()}
    one_off["v"][1] = torch.nextafter(one_off["v"][1], torch.tensor(9.0, dtype=torch.float64))
    assert judge_join.compare(one_off, a)["rows"] == 1
    dup = {n: torch.cat([t[:3], t[:1]]) for n, t in a.items()}  # a row twice, another missing
    assert judge_join.compare(dup, a)["rows"] > 0
    short = {n: t[:3] for n, t in a.items()}
    assert judge_join.compare(short, a)["rows"] >= 1
    assert judge_join.compare({"k": a["k"]}, a)["columns"] == 1


@pytest.mark.parametrize("question", JOIN)
def test_join_questions_reference_names(small_catalog, question):
    config = small_catalog.json("configs", "h2o-join-1e8")
    build = {"join_q1": "small", "join_q2": "medium", "join_q5": "big"}[question]
    raw = small_catalog.module("datagen", "h2o_join").make(config, ["x", build], 3, torch.device("cpu"))
    got = small_catalog.module("reference", question).run(config, raw)
    shared = set(config["tables"]["x"]) & set(config["tables"][build])
    key = {"join_q1": "id1", "join_q2": "id2", "join_q5": "id3"}[question]
    assert key in got and all(f"{n}_l" in got and f"{n}_r" in got for n in shared - {key})
    rows = got[key].numel()
    assert 0.85 * config["rows"]["x"] < rows < 0.95 * config["rows"]["x"]  # about 90% of x matches once
