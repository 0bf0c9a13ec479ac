"""The TPC-H configuration on the CPU at a small size: the lineitem
generator's ranges and rules (clause 4.2.3), its seeding, Q1's least bytes,
the reference against a Python loop, the cell in a small catalog (a sound
run correct, half of the rows left out not), and the control failing."""

import collections

import pytest
import torch

import arrow_tpu_torch as att
from portbench import control, counting, harness
from portbench.tests.conftest import write_small

CONFIG_NAME, CELL = "tpch-sf10-lineitem", "tpch-sf10-lineitem.q1"
SIZES = {CONFIG_NAME: {"rows": 200_000}}


@pytest.fixture
def tpch_catalog(tmp_path):
    return harness.Catalog(bases=[write_small(tmp_path, SIZES), harness.HERE])


def _make(cat, seed, rows=200_000):
    config = dict(cat.json("configs", CONFIG_NAME), rows=rows)
    return config, cat.module("datagen", config["generator"]).make(config, ["lineitem"], seed, torch.device("cpu"))


def test_generator_ranges_and_rules():
    cat = harness.Catalog()
    gen = cat.module("datagen", "tpch_lineitem")
    config, raw = _make(cat, 2**40 + 3)
    li = raw["lineitem"]
    assert set(li) == set(config["tables"]["lineitem"])
    assert all(t.numel() == 200_000 for t in li.values())
    ship, flag, status = li["l_shipdate"], li["l_returnflag"], li["l_linestatus"]
    assert ship.dtype == torch.int32 and flag.dtype == status.dtype == torch.uint8
    assert int(ship.min()) >= gen.STARTDATE + 1 and int(ship.max()) <= gen.LAST_ORDERDATE + 121
    qty = li["l_quantity"]
    assert bool((qty % 100 == 0).all()) and int(qty.min()) == 100 and int(qty.max()) == 5000
    assert (int(li["l_discount"].min()), int(li["l_discount"].max())) == (0, 10)
    assert (int(li["l_tax"].min()), int(li["l_tax"].max())) == (0, 8)
    # status by ship date; the flag by receipt date (ship + 1..30 days) against CURRENTDATE
    assert torch.equal(status, (ship > gen.CURRENTDATE).to(torch.uint8))
    assert bool((flag[ship > gen.CURRENTDATE] == gen.FLAG_N).all())
    early = flag[ship <= gen.CURRENTDATE - 30]
    assert bool(((early == 0) | (early == gen.FLAG_R)).all())
    assert abs(float((early == 0).double().mean()) - 0.5) < 0.01  # A or R at random
    between = flag[(ship > gen.CURRENTDATE - 30) & (ship <= gen.CURRENTDATE)]
    assert set(between.tolist()) == {0, gen.FLAG_N, gen.FLAG_R}
    late = li["l_receiptdate"] > gen.CURRENTDATE
    assert bool((flag[late] == gen.FLAG_N).all()) and bool((flag[~late] != gen.FLAG_N).all())
    # price = quantity x P_RETAILPRICE of the line's part key in [1, SF x 200000]
    part = li["l_partkey"].long()
    assert int(part.min()) >= 1 and int(part.max()) <= config["SF"] * 200_000
    assert torch.equal(li["l_extendedprice"], (qty // 100) * gen.retail_price_cents(part))
    # the supplier is one of the part's four
    supp = li["l_suppkey"].long()
    four = torch.stack([gen.supplier_key(part, torch.full_like(part, j), config["SF"]) for j in range(4)])
    assert bool((four == supp).any(0).all()) and len(set(supp.tolist())) > 1000
    # orders: sparse keys, non-decreasing, each of 1-7 lines numbered from 1, dates of one order date
    key, line = li["l_orderkey"].long(), li["l_linenumber"].long()
    assert int(key[0]) == 1 and bool((key[1:] >= key[:-1]).all()) and bool(((key - 1) % 32 < 8).all())
    new = torch.cat([torch.tensor([True]), key[1:] != key[:-1]])
    assert bool((line[new] == 1).all()) and bool((line[1:][~new[1:]] == line[:-1][~new[1:]] + 1).all())
    assert int(line.max()) == 7 and 3.9 < 200_000 / int(new.sum()) < 4.1
    receipt, commit = li["l_receiptdate"], li["l_commitdate"]
    assert bool(((receipt - ship >= 1) & (receipt - ship <= 30)).all())
    assert bool(((commit - ship >= 30 - 121) & (commit - ship <= 90 - 1)).all())
    assert int(commit.min()) >= gen.STARTDATE + 30 and int(commit.max()) <= gen.LAST_ORDERDATE + 90
    assert set(li["l_shipinstruct"].tolist()) == set(range(4)) and set(li["l_shipmode"].tolist()) == set(range(7))
    comment = li["l_comment"]
    assert int(comment.min()) >= 0 and int(comment.max()) < 200_000
    # Q1's groups over the 98.6% of rows kept: A/F, N/F, N/O and R/F near 25, 0.6, 49 and 25%
    # (the specification's SF 1 answer: N/F 38,854 of 5,916,591 rows, 0.66%)
    kept = ship <= config["ship_cutoff"]
    assert 0.98 < float(kept.double().mean()) < 0.99
    shares = torch.bincount((flag.long() * 2 + status.long())[kept], minlength=6).double() / int(kept.sum())
    want = [0.25, 0.0, 0.0062, 0.494, 0.25, 0.0]
    assert all(abs(float(x) - w) < 0.006 for x, w in zip(shares, want)), shares.tolist()
    assert 0.004 < float(shares[2]) < 0.008 and float(shares[1] + shares[5]) == 0.0


def test_retail_price_formula():
    gen = harness.Catalog().module("datagen", "tpch_lineitem")
    for p in (1, 9, 10, 999, 1000, 200_010, 2_000_000):
        want = 90000 + (p // 10) % 20001 + 100 * (p % 1000)
        assert int(gen.retail_price_cents(torch.tensor([p]))[0]) == want


def test_same_seed_same_tables():
    cat = harness.Catalog()
    (_, a), (_, b), (_, c) = _make(cat, 7, 5000), _make(cat, 7, 5000), _make(cat, 8, 5000)
    assert all(torch.equal(a["lineitem"][k], b["lineitem"][k]) for k in a["lineitem"])
    assert not torch.equal(a["lineitem"]["l_extendedprice"], c["lineitem"]["l_extendedprice"])


def test_question_least_bytes():
    cat = harness.Catalog()
    question = cat.module("questions", "tpch_q1")
    assert question.OPERATOR == "filter_groupby" and question.TABLES == ("lineitem",)
    config, raw = _make(cat, 1, 1000)
    assert set(question.READS["lineitem"]) < set(config["tables"]["lineitem"]) == set(raw["lineitem"])
    assert len(question.READS["lineitem"]) == 7  # the other nine are resident and not read
    shapes = {"key": (4, 1), "sum_qty": (4, 8), "count_order": (4, 8)}
    assert counting.question_bytes(question, raw, shapes) == 1000 * (4 * 8 + 2 * 1 + 4) + 4 * 17


def test_reference_against_a_python_loop():
    cat = harness.Catalog()
    config, raw = _make(cat, 11, 3000)
    li = {k: v.tolist() for k, v in raw["lineitem"].items()}
    acc = collections.defaultdict(lambda: [0, 0, 0, 0, 0, 0])
    for i in range(3000):
        if li["l_shipdate"][i] > config["ship_cutoff"]:
            continue
        q, p, d, t = li["l_quantity"][i], li["l_extendedprice"][i], li["l_discount"][i], li["l_tax"][i]
        a = acc[li["l_returnflag"][i] * 2 + li["l_linestatus"][i]]
        for j, v in enumerate((q, p, p * (100 - d), p * (100 - d) * (100 + t), d, 1)):
            a[j] += v
    ref = cat.module("reference", "tpch_q1").run(config, raw)
    keys = sorted(acc)
    assert ref["key"].tolist() == keys
    for j, name in enumerate(("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge")):
        assert ref[name].tolist() == [acc[k][j] for k in keys]
    assert ref["count_order"].tolist() == [acc[k][5] for k in keys]
    assert ref["avg_qty"].tolist() == [acc[k][0] / acc[k][5] for k in keys]
    assert ref["avg_price"].tolist() == [acc[k][1] / acc[k][5] for k in keys]
    assert ref["avg_disc"].tolist() == [acc[k][4] / acc[k][5] for k in keys]


def test_cell_sound_run_is_correct(tpch_catalog):
    assert tpch_catalog.workload(CELL)["config"] == CONFIG_NAME
    result = harness.run_cell(tpch_catalog, CELL, 2**33 + 5, 0.3, False, torch.device("cpu"), 0.0)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"groups", "keys", "int_aggs", "f64_rel_err"}


def test_cell_half_the_rows_is_not_correct(tpch_catalog, monkeypatch):
    orig = att.compute.filter

    def half(batch, mask, *a, **kw):
        out = orig(batch, mask, *a, **kw)
        return att.RecordBatch({n: att.PrimitiveArray.from_torch(c.data[: c.length // 2].clone(), dtype=c.dtype)
                                for n, c in out.columns().items()})

    monkeypatch.setattr(att.compute, "filter", half)
    result = harness.run_cell(tpch_catalog, CELL, 77, 0.3, False, torch.device("cpu"), 0.0)
    assert result["correct"] is False and result["checks"]["int_aggs"]["value"] > 0


def test_control_fails_program_passes(tpch_catalog):
    limits = tpch_catalog.json("configs", CONFIG_NAME)["limits"]
    readings = control.readings(tpch_catalog, CELL, [5, 6], torch.device("cpu"))
    assert [side for _s, _q, side, _n in readings] == ["program", "control"] * 2
    for _seed, _q, side, numbers in readings:
        within = all(v <= limits[k] for k, v in numbers.items())
        assert within == (side == "program"), (side, numbers)


def test_traced_run_reads_the_new_metrics_where_it_can(tpch_catalog):
    """On the CPU the spans are there but no device work: the counts are
    read, the device-time metrics are left out."""
    result = harness.run_cell(tpch_catalog, CELL, 9, 0.3, True, torch.device("cpu"), 0.0)
    assert result["correct"] is True
    metrics = result["metrics"]
    reads = [k for k in metrics if k.startswith("host_reads_per_query")]
    assert len(reads) == 1 and metrics[reads[0]]["value"] == 3.0
    assert not any(k.startswith(("filter.compact_ms", "groupby.dense_ms", "ops.expr_ms")) for k in metrics)
