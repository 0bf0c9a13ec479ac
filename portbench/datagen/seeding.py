"""Seeds for the generators: one torch generator a table, so a table is the
same whichever other tables a cell makes."""

import hashlib

import torch


def generator(seed: int, part: str, device) -> torch.Generator:
    """A generator on `device` seeded from (`seed`, `part`); any integer seed."""
    digest = hashlib.sha256(f"{int(seed)}/{part}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return g


def runif_6dp(n: int, g: torch.Generator, device) -> torch.Tensor:
    """round(runif(n, max=100), 6) as float64."""
    v = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return v.mul_(100e6).round_().div_(1e6)
