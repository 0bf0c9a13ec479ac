"""dbgen's lineitem of TPC-H, on the card: all sixteen columns, by the rules
of the specification's clause 4.2.3 (dates as date32 days since 1970-01-01,
decimals as int64 counts of 0.01):

    orders          SF x 1,500,000 of them, each of 1-7 lines (drawn until the rows are reached)
    L_ORDERKEY      sparse: of each 32 keys the first 8 are used, from 1
    L_LINENUMBER    1..(the order's lines)
    O_ORDERDATE     uniform in [STARTDATE, ENDDATE - 151 days] = [1992-01-01, 1998-08-02], once an order
    L_SHIPDATE      O_ORDERDATE + [1, 121] days
    L_COMMITDATE    O_ORDERDATE + [30, 90] days
    L_RECEIPTDATE   L_SHIPDATE + [1, 30] days
    L_QUANTITY      [1, 50]
    L_PARTKEY       [1, SF x 200000]
    L_SUPPKEY       (partkey + (j x (S/4 + (partkey - 1)/S))) mod S + 1, j in [0, 3], S = SF x 10000
    P_RETAILPRICE   (90000 + ((partkey / 10) mod 20001) + 100 x (partkey mod 1000)) / 100
    L_EXTENDEDPRICE L_QUANTITY x P_RETAILPRICE
    L_DISCOUNT      [0.00, 0.10];  L_TAX [0.00, 0.08]
    L_RETURNFLAG    R or A at random if L_RECEIPTDATE <= CURRENTDATE (1995-06-17), else N
    L_LINESTATUS    O if L_SHIPDATE > CURRENTDATE, else F
    L_SHIPINSTRUCT  one of 4 instructions;  L_SHIPMODE one of 7 modes
    L_COMMENT       a text string of 10-43 characters

The flags, the instruction and the mode are uint8 codes of their sorted
dictionaries (A, N, R -> 0, 1, 2; F, O -> 0, 1; COLLECT COD, DELIVER IN
PERSON, NONE, TAKE BACK RETURN -> 0-3; AIR, FOB, MAIL, RAIL, REG AIR, SHIP,
TRUCK -> 0-6).  The port has no string arrays, so L_COMMENT is a uint32
code of a comment dictionary (the configuration's ``assumed``)."""

import torch

from portbench.datagen.seeding import generator

STARTDATE = 8035  # 1992-01-01
LAST_ORDERDATE = 10440  # 1998-08-02 = ENDDATE (1998-12-31) - 151 days
CURRENTDATE = 9298  # 1995-06-17
FLAG_N, FLAG_R = 1, 2  # A is 0
STATUS_F, STATUS_O = 0, 1
INSTRUCTIONS, MODES = 4, 7


def retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE in counts of 0.01 (int64)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def supplier_key(partkey: torch.Tensor, j: torch.Tensor, sf: int) -> torch.Tensor:
    """PS_SUPPKEY of supplier j (0-3) of a part (clause 4.2.3), int64."""
    s = sf * 10000
    return (partkey + j * (s // 4 + (partkey - 1) // s)) % s + 1


def order_key(order: torch.Tensor) -> torch.Tensor:
    """O_ORDERKEY of the order of 0-based index `order`: 8 keys used of
    each 32."""
    return order // 8 * 32 + order % 8 + 1


def make(config: dict, tables, seed: int, device) -> dict:
    n, sf = int(config["rows"]), int(config["SF"])
    out = {}
    for name in tables:
        if name != "lineitem":
            raise KeyError(f"no table {name!r} in the TPC-H data")
        g = generator(seed, name, device)

        def draw(lo, hi, dtype=torch.int32, size=n):  # integers in [lo, hi]
            return torch.randint(lo, hi + 1, (size,), generator=g, device=device, dtype=dtype)

        lines = draw(1, 7, torch.int64, n // 4 + 64)
        while int(lines.sum()) < n:
            lines = torch.cat([lines, draw(1, 7, torch.int64, n // 400 + 64)])
        order = torch.repeat_interleave(torch.arange(lines.numel(), device=device), lines)[:n]
        first = torch.cumsum(lines, 0).sub_(lines)
        linenumber = torch.arange(1, n + 1, device=device).sub_(first[order]).to(torch.int32)
        del first
        orderdate = draw(STARTDATE, LAST_ORDERDATE, size=lines.numel())[order]
        ship = draw(1, 121).add_(orderdate)
        commit = draw(30, 90).add_(orderdate)
        del orderdate
        receipt = draw(1, 30).add_(ship)
        quantity = draw(1, 50, torch.int64)
        partkey = draw(1, sf * 200000, torch.int64)
        price = quantity * retail_price_cents(partkey)
        suppkey = supplier_key(partkey, draw(0, 3, torch.int64), sf)
        either = draw(0, 1, torch.uint8).mul_(FLAG_R)  # A (0) or R (2)
        flag = torch.where(receipt <= CURRENTDATE, either, torch.full_like(either, FLAG_N))
        del either
        out[name] = {
            "l_orderkey": order_key(order).to(torch.int32),
            "l_partkey": partkey.to(torch.int32),
            "l_suppkey": suppkey.to(torch.int32),
            "l_linenumber": linenumber,
            "l_quantity": quantity.mul_(100),
            "l_extendedprice": price,
            "l_discount": draw(0, 10, torch.int64),
            "l_tax": draw(0, 8, torch.int64),
            "l_returnflag": flag,
            "l_linestatus": (ship > CURRENTDATE).to(torch.uint8),
            "l_shipdate": ship,
            "l_commitdate": commit,
            "l_receiptdate": receipt,
            "l_shipinstruct": draw(0, INSTRUCTIONS - 1, torch.uint8),
            "l_shipmode": draw(0, MODES - 1, torch.uint8),
            "l_comment": draw(0, n - 1),
        }
        del order, partkey, suppkey
    return out
