"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result line.

A cell (``cells/<cell>.json``) names its configuration and questions and
how they are issued; everything else is found by name: the configuration
(``configs/``), its generator (``datagen/``), each question's client
(``questions/``) and reference (``reference/``), the comparison of each
operator's results (``judges/``), and each metric's reader
(``metrics/<metric>.py``, for the metrics that ``BENCHMARK.json`` lists
for the cell).  Adding any of them adds files and edits none.

The loop is closed: one client issues a question, waits until its result is
complete on the device, then issues the next.  The questions come in
rounds, each round every question of the cell once, in an order drawn
from the seed.  The window runs for ``--seconds``; a traced run instead
traces a fixed number of rounds (the cell's ``trace_rounds``), so that its
counts repeat exactly.  From each question's first ``sample_rounds``
occurrences one, drawn from the seed, is kept and compared with the
reference once the window has closed.
"""

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from . import counting, tracing

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "arrow_tpu")


def process_start() -> float:
    """The wall time at which this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Catalog:
    """A benchmark's parts, found by name as files under `bases` (the first
    base that holds one wins), and its ``BENCHMARK.json``."""

    def __init__(self, bases=(HERE,), benchmark: Optional[dict] = None):
        self.bases = [pathlib.Path(b) for b in bases]
        if benchmark is None:
            benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
        self.benchmark = benchmark
        self._modules = {}

    def path(self, kind: str, name: str, suffix: str) -> pathlib.Path:
        for base in self.bases:
            path = base / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind} named {name!r} ({kind}/{name}{suffix})")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.path(kind, name, ".py")
        if path not in self._modules:
            safe = "".join(c if c.isalnum() else "_" for c in f"{kind}_{name}")
            spec = importlib.util.spec_from_file_location(f"portbench_{safe}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def reader(self, metric: str, cell: dict):
        """The reader of `metric`: ``metrics/<metric>.py``, or, where there
        is no such file and the name ends in the cell's ``metric_suffix``,
        the reader of the name without it: the same quantity in a cell whose
        end-to-end metrics carry that suffix, under bounds of their own."""
        suffix = cell.get("metric_suffix", "")
        try:
            return self.module("metrics", metric)
        except FileNotFoundError:
            if not (suffix and metric.endswith(suffix)):
                raise
            return self.module("metrics", metric[: -len(suffix)])

    def workload(self, name: str) -> dict:
        for entry in self.benchmark["workloads"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The metrics a run of `cell` reports: per-layer ones when traced."""
        entries = self.benchmark["per_layer" if traced else "end_to_end"]
        return [m for m in entries if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Window:
    """What a run measured; the metric readers take their numbers from it."""

    setup_s: float
    seconds: float  # from the first query's issue to the last one's completion
    latencies: List[float]  # seconds, every query completed in the window
    rows: int  # input rows of the queries completed
    peak_bytes: Optional[int]  # device memory over the window, the kept results left out
    device_name: str
    operators: Dict[str, str]  # question -> operator
    least_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)  # operator -> traced bytes
    trace: Optional[tracing.Trace] = None
    tap: Optional[tracing.KernelTap] = None
    trace_complete: bool = False

    @property
    def peak_bandwidth(self) -> Optional[float]:
        return counting.peak_bytes_per_s(self.device_name)


def values(column, kind: str) -> torch.Tensor:
    """A result column's logical rows as values: float64, or int64 (unsigned
    32-bit storage read as unsigned)."""
    data = column.data[: column.length]
    if kind.startswith("float"):
        return data.to(torch.float64)
    out = data.to(torch.int64)
    if kind in ("uint8", "uint16", "uint32"):
        out &= (1 << (8 * data.element_size())) - 1
    return out


def port_tables(att, config: dict, raw: dict) -> dict:
    """The generated tables as the port's RecordBatches, over the same
    tensors, each column in its configured Arrow type."""
    return {
        table: att.RecordBatch({
            name: att.PrimitiveArray.from_torch(data, dtype=att.ArrowType(config["tables"][table][name]))
            for name, data in cols.items()
        })
        for table, cols in raw.items()
    }


def rounds(questions: List[str], rng: random.Random):
    """Round after round, each a permutation of `questions`."""
    while True:
        order = list(questions)
        rng.shuffle(order)
        yield from order


def card_query(device: torch.device) -> Optional[subprocess.Popen]:
    """Start nvidia-smi's reading of the card's name and power limit, so
    that it runs beside the rest of the set-up; `card_line` reads it."""
    if device.type != "cuda":
        return None
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={device.index or 0}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
    except OSError:
        return None


def card_line(device: torch.device, query: Optional[subprocess.Popen] = None) -> str:
    if device.type != "cuda":
        return f"device {device}"
    query = card_query(device) if query is None else query
    smi = "nvidia-smi not read"
    if query is not None:
        try:
            smi = query.communicate(timeout=20)[0].strip()
        except subprocess.TimeoutExpired:
            query.kill()
            query.wait()
    return f"device {torch.cuda.get_device_name(device)}; nvidia-smi name, power limit: {smi}"


def run_cell(cat: Catalog, cell_name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, started: float) -> dict:
    """Run `cell_name` once on `device` and return the result line's object."""
    log = lambda msg: print(f"portbench: {msg}", file=sys.stderr, flush=True)  # noqa: E731
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    card = card_query(device)
    cell = cat.json("cells", cell_name)
    config = cat.json("configs", cell["config"])
    names = list(cell["questions"])
    questions = {q: cat.module("questions", q) for q in names}
    log(f"set-up: process start to the harness's imports done {time.time() - started:.3f} s")
    phase = time.time()
    if cuda:
        torch.cuda.init()
    log(f"set-up: CUDA initialised (torch.cuda.init) in {time.time() - phase:.3f} s")
    phase = time.time()

    import arrow_tpu_torch as att

    log(f"set-up: the port imported in {time.time() - phase:.3f} s")
    if cuda:
        phase = time.time()
        library = att.compute.kernels._build.load()
        # a checkout's first run builds the library: that build is logged
        # apart here, and stays in setup_s, as compilation does
        log(f"set-up: the port's kernel library loaded in {time.time() - phase:.3f} s, "
            f"of it nvcc's build {library.build_seconds:.3f} s")
    phase = time.time()
    table_names = sorted({t for q in questions.values() for t in q.TABLES})
    raw = cat.module("datagen", config["generator"]).make(config, table_names, seed, device)
    tables = port_tables(att, config, raw)
    sync()
    log(f"set-up: tables {', '.join(table_names)} made on the device in {time.time() - phase:.3f} s")
    phase = time.time()
    rng = random.Random(f"{seed}/order")
    sample_at = {q: rng.randint(1, int(cell["sample_rounds"])) for q in names}
    tap = None
    if traced:
        tap = tracing.KernelTap(att.compute.kernels)
        tap.install()
    for _ in range(int(cell["warmup_rounds"])):  # every shape the window will use
        for q in names:
            out = questions[q].run(att, tables, config)
            sync()
            del out
    log(f"set-up: {cell['warmup_rounds']} warm-up rounds in {time.time() - phase:.3f} s")

    order = rounds(names, rng)
    latencies, rows, failed, attempted = [], 0, 0, 0
    seen = dict.fromkeys(names, 0)
    kept = {}
    least = {}
    input_rows = {q: sum(len(tables[t]) for t in questions[q].TABLES) for q in names}
    prof = None
    log(card_line(device, card))
    if cuda:
        peak_before = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        held_before = torch.cuda.memory_allocated(device)
    if traced:
        before = {k: (v.launches, v.passes) for k, v in att.compute.kernels._build.KERNELS.items()}
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        tap.on = True
    total = int(cell["trace_rounds"]) * len(names) if traced else None
    gc.disable()
    setup_s = time.time() - started
    start = time.perf_counter()
    with torch.profiler.record_function("portbench.window"):
        while (attempted < total) if traced else (time.perf_counter() - start < seconds):
            q = next(order)
            attempted += 1
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"portbench.query.{q}"):
                    out = questions[q].run(att, tables, config)
                sync()
            except Exception as exc:  # noqa: BLE001 - a failed query is counted, the window goes on
                failed += 1
                out = None
                log(f"query {q} failed: {type(exc).__name__}: {exc}")
                continue
            latencies.append(time.perf_counter() - t0)
            rows += input_rows[q]
            seen[q] += 1
            if traced:
                shapes = {n: (len(c), c.data.element_size()) for n, c in out.columns().items()}
                op = questions[q].OPERATOR
                least[op] = least.get(op, 0) + counting.question_bytes(questions[q], raw, shapes)
            if seen[q] <= sample_at[q]:
                kept[q] = out
            del out
    window_s = time.perf_counter() - start
    gc.enable()
    if traced:
        tap.on = False
        prof.stop()
    peak = held = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(device)
        # every result but the kept ones is freed by now: what the window
        # left allocated is the kept results, which the engine does not need
        # and which are resident at the peak once the sample rounds are over
        held = torch.cuda.memory_allocated(device) - held_before
    memory_peak = max(peak_before, peak) if cuda else 0
    w = Window(setup_s=setup_s, seconds=window_s, latencies=latencies, rows=rows,
               peak_bytes=None if peak is None else peak - held,
               device_name=torch.cuda.get_device_name(device) if cuda else str(device),
               operators={q: questions[q].OPERATOR for q in names}, least_bytes=least, tap=tap)
    if traced:
        after = {k: (v.launches, v.passes) for k, v in att.compute.kernels._build.KERNELS.items()}
        w.trace = tracing.Trace(prof)
        del prof
        tap.uninstall()
        w.trace_complete = check_trace(w.trace, tracing.launch_deltas(before, after), log)
    log(f"window: {len(latencies)} queries completed of {attempted} attempted in {window_s:.6f} s; "
        f"set-up {setup_s:.6f} s; peak {peak} bytes, of it the kept results {held} bytes")

    # the check: the kept results against the reference, once the program's
    # state is freed and the peak has been read
    del tables
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers: Dict[str, float] = {}
    compared = 0
    for q in names:
        if q not in kept:
            continue
        result = kept.pop(q)
        program = {n: values(c, c.dtype.value) for n, c in result.columns().items()}
        del result
        reference = cat.module("reference", q).run(config, raw)
        judge = cat.module("judges", questions[q].OPERATOR)
        for key, value in judge.compare(program, reference).items():
            numbers[key] = max(numbers.get(key, 0), value)
        compared += 1
        del program, reference
    limits = config["limits"]
    correct = failed == 0 and compared == len(names) and all(numbers[k] <= limits[k] for k in numbers)
    log(f"check: {compared} of {len(names)} questions' kept results against the reference in "
        f"{time.perf_counter() - t_check:.3f} s")

    metrics = {}
    for entry in cat.metrics(cell_name, traced):
        value = cat.reader(entry["name"], cell).read(w)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": w.device_name, "count": 1,
           "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if traced and w.trace is not None:
        dev["busy_s"] = w.trace.busy_ns() / 1e9
        dev["window_s"] = w.trace.window_ns / 1e9
        result["breakdown"] = w.trace.breakdown()
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(numbers)}
    return result


def check_trace(trace: tracing.Trace, want: Dict[str, int], log) -> bool:
    """Whether the trace holds every launch: each hand-written kernel's
    events against its launch counters, and every runtime launch call
    against the device's kernel events.  Prints the coverage."""
    have = trace.own_counts()
    parts = [f"{f} {have[f]}/{n}" for f, n in sorted(want.items()) if n or have[f]]
    launches, kernels = trace.launch_calls(), trace.kernel_ops()
    ok = all(have[f] == n for f, n in want.items()) and launches == kernels
    log(f"trace check: hand-written kernel events / counted launches: {', '.join(parts) or 'none'}; "
        f"kernel events / runtime launch calls {kernels}/{launches}; "
        f"{'complete' if ok else 'RECORDS LOST: no share is read from this trace'}")
    idle = trace.window_ns - trace.busy_ns()
    log(f"trace: window {trace.window_ns / 1e9:.6f} s, device busy {trace.busy_ns() / 1e9:.6f} s, "
        f"idle {idle / 1e9:.6f} s, of it in the profiler's buffer requests "
        f"{trace.buffer_request_ns() / 1e9:.6f} s")
    return ok


def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    cat = Catalog()
    chips = int(cat.workload(args.workload)["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 3
    cache = ROOT / "build" / "portbench"  # fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    result = run_cell(cat, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), started)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
