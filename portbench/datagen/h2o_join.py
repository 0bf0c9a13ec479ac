"""_data/join-datagen.R of H2O.ai db-benchmark, on the card.

    split_xlr(n): key = sample.int(n * 1.1); x = key[1..0.9n], l = key[0.9n+1..n],
                  r = key[n+1..1.1n]
    sample_all(x, size): every element of x once, then size - length(x) more
                  drawn from x with replacement, all shuffled
    keys: id1 = split_xlr(N/1e6), id2 = split_xlr(N/1e3), id3 = split_xlr(N)
    x (N rows):        id1-id3 = sample_all(c(k$x, k$l), N)
    small (N/1e6):     id1 = sample_all(c(k1$x, k1$r), N/1e6)
    medium (N/1e3):    id1, id2 = sample_all(c(k$x, k$r), N/1e3)
    big (N):           id1-id3 = sample_all(c(k$x, k$r), N)
    id4-id6 = sprintf("id%.0f", id1-id3); v1 (x), v2 (others) = round(runif(.N, max=100), 6)

with nas = 0 and sort = 0.  The factors id4-id6 are codes of a dictionary
whose code of "id<k>" is k, so each equals its integer column."""

import torch

from portbench.datagen.seeding import generator, runif_6dp

#: each table's key columns, the side of split_xlr it draws them from, and
#: its value column; the row counts and the keys' n are the configuration's
#: ``rows`` and ``key_n``
_TABLES = {
    "x": (("id1", "id2", "id3"), "l", "v1"),
    "small": (("id1",), "r", "v2"),
    "medium": (("id1", "id2"), "r", "v2"),
    "big": (("id1", "id2", "id3"), "r", "v2"),
}
_FACTOR = {"id1": "id4", "id2": "id5", "id3": "id6"}


def split_xlr(n: int, g: torch.Generator, device):
    """(x, l, r): a permutation of 1..1.1n cut at 0.9n and n."""
    key = torch.randperm(n * 11 // 10, generator=g, device=device, dtype=torch.int64) + 1
    key = key.to(torch.int32)
    return key[: n * 9 // 10], key[n * 9 // 10 : n], key[n:]


def sample_all(pool: torch.Tensor, size: int, g: torch.Generator) -> torch.Tensor:
    """Every element of `pool` once and `size - len(pool)` more drawn from it
    with replacement, shuffled."""
    extra = size - pool.numel()
    if extra < 0:
        raise ValueError("sample_all: pool larger than size")
    if extra:
        idx = torch.randint(0, pool.numel(), (extra,), generator=g, device=pool.device)
        pool = torch.cat([pool, pool[idx]])
    return pool[torch.randperm(size, generator=g, device=pool.device)]


def make(config: dict, tables, seed: int, device) -> dict:
    if config["nas"] != 0 or config["sort"] != 0:
        raise ValueError("only nas=0, sort=0 is generated")
    for name in tables:
        if name not in _TABLES:
            raise KeyError(f"no table {name!r} in the join data")
    needed = sorted({key for name in tables for key in _TABLES[name][0]})
    keys = {}
    for key in needed:  # each key set from its own generator
        keys[key] = split_xlr(int(config["key_n"][key]), generator(seed, f"keys.{key}", device), device)
    out = {}
    for name in tables:
        key_cols, side, value = _TABLES[name]
        rows = int(config["rows"][name])
        g = generator(seed, name, device)
        cols = {}
        for key in key_cols:
            shared, left, right = keys[key]
            cols[key] = sample_all(torch.cat([shared, left if side == "l" else right]), rows, g)
        for key in key_cols:
            cols[_FACTOR[key]] = cols[key].clone()
        cols[value] = runif_6dp(rows, g, device)
        out[name] = cols
    return out
