"""The generators against the rules of db-benchmark's datagen scripts, at
small N on the CPU."""

import torch

from portbench.datagen import h2o_join


def _tables(cat, config_name, tables, seed=7):
    config = cat.json("configs", config_name)
    return config, cat.module("datagen", config["generator"]).make(config, tables, seed, torch.device("cpu"))


def test_groupby_ranges_and_levels(small_catalog):
    config, t = _tables(small_catalog, "h2o-groupby-1e8-k100", ["x"])
    x, n, k = t["x"], config["N"], config["K"]
    assert list(x) == list(config["tables"]["x"])
    ranges = {"id1": (0, k - 1), "id2": (0, k - 1), "id3": (0, n // k - 1), "id4": (1, k), "id5": (1, k),
              "id6": (1, n // k), "v1": (1, 5), "v2": (1, 15)}
    for name, (lo, hi) in ranges.items():
        col = x[name]
        assert col.dtype == torch.int32 and col.numel() == n
        assert int(col.min()) == lo and int(col.max()) == hi, name
    for name in ("id1", "id2", "id4", "id5", "v1", "v2"):
        assert torch.unique(x[name]).numel() == ranges[name][1] - ranges[name][0] + 1
    for name in ("id3", "id6"):  # N/K levels drawn N times: nearly all present
        assert torch.unique(x[name]).numel() >= 0.99 * (n // k)
    v3 = x["v3"]
    assert v3.dtype == torch.float64 and 0 <= float(v3.min()) and float(v3.max()) <= 100
    assert float((v3 * 1e6 - torch.round(v3 * 1e6)).abs().max()) < 1e-6  # six decimals
    assert abs(float(v3.mean()) - 50) < 2


def test_same_seed_same_tables(small_catalog):
    _, a = _tables(small_catalog, "h2o-groupby-1e8-k100", ["x"], seed=2**40 + 3)
    _, b = _tables(small_catalog, "h2o-groupby-1e8-k100", ["x"], seed=2**40 + 3)
    _, c = _tables(small_catalog, "h2o-groupby-1e8-k100", ["x"], seed=2**40 + 4)
    assert all(torch.equal(a["x"][n], b["x"][n]) for n in a["x"])
    assert not torch.equal(a["x"]["v3"], c["x"]["v3"])


def test_join_keys_and_match_ratio(small_catalog):
    config, t = _tables(small_catalog, "h2o-join-1e8", ["x", "small", "medium", "big"])
    for name, cols in t.items():
        assert list(cols) == list(config["tables"][name])
        assert all(c.numel() == config["rows"][name] for c in cols.values())
    for key, factor in (("id1", "id4"), ("id2", "id5"), ("id3", "id6")):
        assert torch.equal(t["x"][key], t["x"][factor])  # the code of "id<k>" is k
    n3 = config["key_n"]["id3"]
    x3, b3 = t["x"]["id3"], t["big"]["id3"]
    assert torch.unique(x3).numel() == n3 and torch.unique(b3).numel() == n3
    assert 1 <= int(x3.min()) and int(x3.max()) <= n3 * 11 // 10
    assert int(torch.isin(x3, b3).sum()) == n3 * 9 // 10  # 90% of x finds its one big row
    for table, key in (("small", "id1"), ("medium", "id2")):  # build keys unique: all of c(x, r)
        assert torch.unique(t[table][key]).numel() == t[table][key].numel()
    for key, table in (("id1", "small"), ("id2", "medium")):
        share = float(torch.isin(t["x"][key], t[table][key]).double().mean())
        assert abs(share - 0.9) < 0.05, (key, share)


def test_sample_all_keeps_every_key():
    g = torch.Generator().manual_seed(3)
    pool = torch.arange(1, 51, dtype=torch.int32)
    out = h2o_join.sample_all(pool, 1000, g)
    assert out.numel() == 1000 and torch.equal(torch.unique(out), pool)
    x, l, r = h2o_join.split_xlr(100, g, torch.device("cpu"))
    assert (x.numel(), l.numel(), r.numel()) == (90, 10, 10)
    assert torch.equal(torch.sort(torch.cat([x, l, r])).values, torch.arange(1, 111, dtype=torch.int32))
