"""The comparison of a group-by's result: the program's against the plain
reference's, both as {column: values} with int64 or float64 values, the
group key in ``key`` and the groups in key order.

- ``groups``: the group counts' difference;
- ``keys``: groups whose key differs, the counts' difference included;
- ``int_aggs``: integer aggregates that differ;
- ``f64_rel_err``, where the question has a float aggregate: the largest
  |program - reference| / |reference| over them.
"""

import math

import torch


def compare(program: dict, reference: dict) -> dict:
    pkey, rkey = program.get("key"), reference["key"]
    if pkey is None:
        return {"groups": rkey.numel(), "keys": rkey.numel(), "int_aggs": rkey.numel(), "f64_rel_err": math.inf}
    groups = abs(pkey.numel() - rkey.numel())
    n = min(pkey.numel(), rkey.numel())
    keys = groups + int((pkey[:n] != rkey[:n]).sum())
    int_aggs, rel_err = 0, None
    for name, ref in reference.items():
        if name == "key":
            continue
        got = program.get(name)
        if ref.is_floating_point():
            err = math.inf
            if got is not None and got.is_floating_point():
                diff = (got[:n] - ref[:n]).abs() / ref[:n].abs().clamp(min=torch.finfo(torch.float64).tiny)
                err = float(torch.nan_to_num(diff, nan=math.inf).max()) if n else 0.0
            rel_err = err if rel_err is None else max(rel_err, err)
        elif got is None or got.is_floating_point():
            int_aggs += ref.numel()
        else:
            int_aggs += int((got[:n] != ref[:n]).sum())
    numbers = {"groups": groups, "keys": keys, "int_aggs": int_aggs}
    if rel_err is not None:
        numbers["f64_rel_err"] = rel_err
    return numbers
