"""_data/groupby-datagen.R of H2O.ai db-benchmark, on the card.

    id1, id2 = sample(sprintf("id%03d", 1:K), N, TRUE)      -> codes in [0, K)
    id3      = sample(sprintf("id%010d", 1:(N/K)), N, TRUE) -> codes in [0, N/K)
    id4, id5 = sample(K, N, TRUE)                          -> [1, K]
    id6      = sample(N/K, N, TRUE)                        -> [1, N/K]
    v1 = sample(5, N, TRUE); v2 = sample(15, N, TRUE)
    v3 = round(runif(N, max=100), 6)

with nas = 0 and sort = 0 (no nulls, rows unsorted)."""

import torch

from portbench.datagen.seeding import generator, runif_6dp


def make(config: dict, tables, seed: int, device) -> dict:
    if config["nas"] != 0 or config["sort"] != 0:
        raise ValueError("only nas=0, sort=0 is generated")
    n, k = int(config["N"]), int(config["K"])
    out = {}
    for name in tables:
        if name != "x":
            raise KeyError(f"no table {name!r} in the groupby data")
        g = generator(seed, name, device)

        def draw(lo, hi):  # integers in [lo, hi)
            return torch.randint(lo, hi, (n,), generator=g, device=device, dtype=torch.int32)

        cols = {
            "id1": draw(0, k), "id2": draw(0, k), "id3": draw(0, n // k),
            "id4": draw(1, k + 1), "id5": draw(1, k + 1), "id6": draw(1, n // k + 1),
            "v1": draw(1, 6), "v2": draw(1, 16),
        }
        cols["v3"] = runif_6dp(n, g, device)
        out[name] = cols
    return out
