"""TPC-H Q1 through the port on the CPU: the client's calls of
``portbench/questions/tpch_q1.py`` (the ops tier's compare, ``compute.filter``,
the key and price expressions, ``compute.hash_aggregate(method="auto")``)
against the plain reference ``portbench/reference/tpch_q1.py``, over the
benchmark's own lineitem generator at 2e5 rows on three seeds, each loaded by
path.  The sums and the count exact, the averages within the configuration's
limit, the mxu route taken; a column whose rows x largest value reaches 2^63
sends the query to the sort route, still exact; the reference with int16
sums (the control) fails the limits."""

import importlib.util
import json
import pathlib
import sys

import pytest
import torch

import arrow_tpu_torch as att

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
ROWS = 200_000


def _load(rel: str):
    if str(ROOT) not in sys.path:  # the portbench modules import their package
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(f"tpch_{rel.replace('/', '_')[:-3]}", BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _load("datagen/tpch_lineitem.py")
QUESTION = _load("questions/tpch_q1.py")
REFERENCE = _load("reference/tpch_q1.py")
JUDGE = _load("judges/filter_groupby.py")
CONFIG = {**json.loads((BENCH / "configs" / "tpch-sf10-lineitem.json").read_text()), "rows": ROWS}


def _tables(seed: int):
    raw = GEN.make(CONFIG, ["lineitem"], seed, torch.device("cpu"))
    types = CONFIG["tables"]["lineitem"]
    batch = att.RecordBatch({name: att.PrimitiveArray.from_torch(data, dtype=att.ArrowType(types[name]))
                             for name, data in raw["lineitem"].items()})
    return raw, {"lineitem": batch}


def _values(batch) -> dict:
    """The result as {column: int64 or float64 values}, as the benchmark reads it."""
    out = {}
    for name, col in batch.columns().items():
        data = col.data[: col.length]
        out[name] = data.to(torch.float64 if data.is_floating_point() else torch.int64)
    return out


def _routes(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, {e.name for e in prof.events() if e.name.startswith("att.groupby.route.")}


def _within_limits(numbers: dict) -> bool:
    return all(v <= CONFIG["limits"][k] for k, v in numbers.items())


@pytest.mark.parametrize("seed", [1, 2**33 + 29, 2_718_281_829])
def test_q1_through_the_port_matches_the_reference_on_the_mxu_route(seed):
    raw, tables = _tables(seed)
    result, routes = _routes(lambda: QUESTION.run(att, tables, CONFIG))
    assert routes == {"att.groupby.route.mxu"}
    got, want = _values(result), REFERENCE.run(CONFIG, raw)
    assert got["key"].tolist() == [0, 2, 3, 4]  # A/F, N/F, N/O, R/F
    for name in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "count_order"):
        assert torch.equal(got[name], want[name]), name
    numbers = JUDGE.compare(got, want)
    assert set(numbers) == {"groups", "keys", "int_aggs", "f64_rel_err"} and _within_limits(numbers)
    assert numbers["int_aggs"] == 0 and int(got["count_order"].sum()) == int((raw["lineitem"]["l_shipdate"] <= 10471).sum())


def test_sums_that_could_pass_int64_take_the_sort_route():
    """One price of 10^10 cents: a charge near 10^14, times 2e5 rows past
    2^63, so the mxu route declines (its sums exact in int64 only below) and
    the 64-bit columns skip the partition route: the sort route answers, and
    exactly."""
    raw, _ = _tables(5)
    price = raw["lineitem"]["l_extendedprice"]
    price[ROWS // 3] = 10**10
    assert (price[ROWS // 3] * 100 * 108) * ROWS >= 2**63
    _, tables = _tables(5)
    tables["lineitem"] = att.RecordBatch({**tables["lineitem"].columns(), "l_extendedprice":
                                          att.PrimitiveArray.from_torch(price, dtype=att.ArrowType.INT64)})
    result, routes = _routes(lambda: QUESTION.run(att, tables, CONFIG))
    assert "att.groupby.route.sort" in routes and "att.groupby.route.partition" not in routes
    numbers = JUDGE.compare(_values(result), REFERENCE.run(CONFIG, raw))
    assert numbers["int_aggs"] == 0 and _within_limits(numbers)


@pytest.mark.parametrize("seed", [3, 4])
def test_int16_control_fails_the_limits(seed):
    raw, _ = _tables(seed)
    want = REFERENCE.run(CONFIG, raw)
    numbers = JUDGE.compare(REFERENCE.run(CONFIG, raw, lower=True), want)
    assert not _within_limits(numbers)
    assert numbers["int_aggs"] > 0 and numbers["f64_rel_err"] > CONFIG["limits"]["f64_rel_err"]
