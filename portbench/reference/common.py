"""Group-by and inner join in plain PyTorch (no kernel of the program)."""

import torch

_BITS = {"int32": 32, "uint32": 32, "int64": 64, "uint64": 64}


def column(config: dict, tables: dict, table: str, name: str) -> torch.Tensor:
    """A generated column as values: float64, or int64 (unsigned types read
    as unsigned from their signed storage)."""
    kind, data = config["tables"][table][name], tables[table][name]
    if kind.startswith("float"):
        return data.to(torch.float64)
    values = data.to(torch.int64)
    if kind.startswith("uint") and _BITS[kind] < 64:
        values &= (1 << _BITS[kind]) - 1
    return values


def groupby(key: torch.Tensor, aggs, lower: bool = False) -> dict:
    """GROUP BY `key` (int64): {"key": sorted distinct keys, name: aggregate}
    for each (name, values, "sum" | "mean") of `aggs`.  Sums accumulate in
    float64 and int64, or under `lower` in float32 and int16 (wrapping)."""
    keys, inverse, counts = torch.unique(key, sorted=True, return_inverse=True, return_counts=True)
    out = {"key": keys}
    for name, values, kind in aggs:
        if values.is_floating_point():
            acc = torch.float32 if lower else torch.float64
            total = torch.zeros(keys.numel(), dtype=acc, device=key.device)
            total = total.index_add_(0, inverse, values.to(acc)).to(torch.float64)
        else:
            total = torch.zeros(keys.numel(), dtype=torch.int64, device=key.device)
            total.index_add_(0, inverse, values)
            if lower:
                total = total.to(torch.int16).to(torch.int64)
        if kind == "sum":
            out[name] = total
        elif kind == "mean":
            out[name] = total.to(torch.float64) / counts.to(torch.float64)
        else:
            raise ValueError(f"unknown aggregate {kind!r}")
    return out


def inner_join(config: dict, tables: dict, left: str, right: str, on: str, lower: bool = False) -> dict:
    """left INNER JOIN right ON `on`: every left column, then every right
    column but the key; a name on both sides takes the suffix "_l" on the
    left and "_r" on the right.  Under `lower` float64 columns are carried
    as float32."""
    lkey = column(config, tables, left, on)
    rkey = column(config, tables, right, on)
    order = torch.argsort(rkey, stable=True)
    sorted_keys = rkey[order]
    lo = torch.searchsorted(sorted_keys, lkey)
    count = torch.searchsorted(sorted_keys, lkey, right=True) - lo
    total = int(count.sum())
    device = lkey.device
    lrow = torch.repeat_interleave(torch.arange(lkey.numel(), device=device), count, output_size=total)
    first = torch.cumsum(count, 0) - count
    rrow = order[lo[lrow] + torch.arange(total, device=device) - first[lrow]]
    del lo, count, first

    def carry(values: torch.Tensor) -> torch.Tensor:
        if lower and values.is_floating_point():
            return values.to(torch.float32).to(torch.float64)
        return values

    lcols, rcols = config["tables"][left], config["tables"][right]
    out = {}
    for name in lcols:
        clash = name in rcols and name != on
        out[name + "_l" if clash else name] = carry(column(config, tables, left, name)[lrow])
    for name in rcols:
        if name != on:
            out[name + "_r" if name in lcols else name] = carry(column(config, tables, right, name)[rrow])
    return out
