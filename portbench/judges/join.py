"""The comparison of a join's result: the program's against the plain
reference's, both as {column: values} with int64 or float64 values, rows
in any order.

- ``columns``: column names on one side only;
- ``rows``: the multisets' difference: the row counts' difference, then
  the rows that differ once both sides are put in one canonical order.
  Float64 values are compared bit for bit.
"""

import torch


_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 (wrapping products)."""
    x = (x ^ _lsr(x, 30)) * _M1
    x = (x ^ _lsr(x, 27)) * _M2
    return x ^ _lsr(x, 31)


def _bits(values: torch.Tensor) -> torch.Tensor:
    return values.view(torch.int64) if values.dtype == torch.float64 else values.to(torch.int64)


def canonical_order(columns: dict, names) -> torch.Tensor:
    """A row order that depends only on each row's values: by two 64-bit
    fingerprints of the row.  Rows that tie on both are equal but for a
    collision of 128 bits."""
    h1 = h2 = None
    for i, name in enumerate(names):
        x = _bits(columns[name])
        a, b = _mix(x + 2 * i + 1), _mix(x ^ (0x5851F42D4C957F2D + i))
        h1 = a if h1 is None else _mix(h1 ^ a)
        h2 = b if h2 is None else _mix(h2 + b)
    order = torch.argsort(h2, stable=True)
    return order[torch.argsort(h1[order], stable=True)]


def compare(program: dict, reference: dict) -> dict:
    names = sorted(reference)
    columns = len(set(program) ^ set(reference))
    nref = reference[names[0]].numel()
    if columns:
        return {"columns": columns, "rows": nref}
    nprog = program[names[0]].numel()
    n = min(nprog, nref)
    porder = canonical_order(program, names)[:n]
    rorder = canonical_order(reference, names)[:n]
    differ = torch.zeros(n, dtype=torch.bool, device=porder.device)
    for name in names:
        differ |= _bits(program[name])[porder] != _bits(reference[name])[rorder]
    return {"columns": 0, "rows": abs(nprog - nref) + int(differ.sum())}
