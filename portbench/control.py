"""Readings for the limits of the check, many seeds in one process:

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--device cuda]

For each seed it makes the cell's tables, asks each question once through
the port (the entry the window drives, at the cell's size) and compares
the result with the reference, then puts the reference computed one
precision lower (the control) in the program's place and compares that.
It prints one line a seed, question and side with every number compared.
The benchmark's own runs do not run it."""

import argparse
import gc
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def readings(cat, cell_name: str, seeds, device) -> list:
    """[(seed, question, side, numbers)] with side "program" or "control"."""
    import arrow_tpu_torch as att

    cell = cat.json("cells", cell_name)
    config = cat.json("configs", cell["config"])
    questions = {q: cat.module("questions", q) for q in cell["questions"]}
    names = sorted({t for q in questions.values() for t in q.TABLES})
    out = []
    for seed in seeds:
        raw = cat.module("datagen", config["generator"]).make(config, names, seed, device)
        tables = harness.port_tables(att, config, raw)
        for q, mod in questions.items():
            result = mod.run(att, tables, config)
            program = {n: harness.values(c, c.dtype.value) for n, c in result.columns().items()}
            del result
            ref_mod, judge = cat.module("reference", q), cat.module("judges", mod.OPERATOR)
            reference = ref_mod.run(config, raw)
            out.append((seed, q, "program", judge.compare(program, reference)))
            del program
            control = ref_mod.run(config, raw, lower=True)
            out.append((seed, q, "control", judge.compare(control, reference)))
            del control, reference
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        del tables, raw
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    print(harness.card_line(device), flush=True)
    for seed, q, side, numbers in readings(harness.Catalog(), args.workload, args.seeds, device):
        print(json.dumps({"seed": seed, "question": q, "side": side, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
