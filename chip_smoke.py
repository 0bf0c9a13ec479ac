#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (arrow_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing lines that start with its name:

1. device: the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build: compiles every kernel from arrow_tpu_torch/csrc with nvcc into
   build/arrow_tpu_torch/ and loads it; nvcc's per-kernel register report
   goes to build/arrow_tpu_torch/nvcc.log;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, over lengths, masks/flags, ops, dtypes, plane counts, digit widths,
   key domains, class orders and run lengths (exact, except float adds: f32
   at rtol 1e-6, f64 at rtol 1e-12, and an f32-accumulating stand-in for the
   f64 add must fail that check); the segmented scan (B2) also on misaligned
   views and in a race check (ten repeats of two 2^27-row scans, bit for bit
   alike), and timed at 2^27 rows on four calls; the radix sort (B3) also by
   given bit positions with the number of passes it makes (bits 12-19 in
   one), on keys that stress its look-back (the group-by's skew, one value in
   99% of the rows, a descending arange, an all-equal key), on 8 planes, and
   in a race check of its own (ten repeats of a 2^27-row sort by 31 bits and
   of the skewed class sort); the merge (B7) also at lengths and run lengths
   around its 3712-row tile, on run pairs of edge shapes (A below B, B below
   A, all keys equal, alternating keys, equal keys across the middle, the
   join's two call shapes), on 8 planes, on views one row in and in a race
   check (ten repeats of the join's expand call at 2^27 rows); the split
   (B8) and the one-plane compaction (B9), which no operator calls, are also
   timed there at 2^27 rows; take_columns, the join's output take, over
   column widths, BOOL, validity, lengths and 2-33 columns (one launch a
   16), then timed at join q5's shapes (2^27-row index planes, 9e7 live,
   6 u32 and 1 f64 column a side) beside torch.index_select a column;
4. flagship: the flagship query (compare -> filter -> sort group-by) through
   the public API at 2^20 and 2^27 rows, checked against the same query on
   the plain versions and against a numpy oracle; the kernels' launch counts
   during the query; per-step times for the kernel and plain paths;
5. sort_join: the sort-join query (the flagship's filter and group-by, the
   groups joined back onto the kept rows, the kept rows sorted by key) at
   2^27 rows, checked against the plain path and a numpy oracle; its join
   meets one group a kept row (the one-match emit), so the groups' keys are
   also probed against the kept rows (a repeated build key a group: the
   merge-expand emit, B7), each kept row once; the launch counts and peak
   device memory during both (every kernel but the 2-bit radix must
   launch); each kernel call of a second run of both,
   replayed on its own arguments against its plain version and timed beside
   it; the sort rerun on
   compute.kernels.radix_sort with digit_bits=2 (the 2-bit radix, whose
   launches and calls are read there) and with sort_by_key(method="xla");
   per-step times for both paths and the
   sort's crossover, radix against torch.sort, at 2^24, 2^26 and 2^27;
6. groupby: the group-by query (GROUP BY u32 key, SUM and COUNT of i32
   values in [0, 200)) at 2^27 rows for each key distribution (1K, 1M,
   skewed and ~100M distinct keys): the route hash_aggregate's auto mode
   took, read from the launch counts (the dense-table kernel for 1K, the
   radix sort, in one pass, and the region kernel for 1M and skew, the radix
   sort and the segmented scans for ~100M), the answer against the
   plain path and a numpy oracle (against the sort route for ~100M keys),
   peak device memory, each kernel call replayed against its plain version
   and timed; the query's time on auto's route against the sort route (at
   ~100M keys, 31 significant bits, that is the radix route against the sort
   route, which sets auto's choice between them), and on the plain path;
7. distributed: the distributed tier (arrow_tpu_torch.parallel) at P = 1 on
   a one-rank NCCL group (a file store), so that NCCL's all_gather and
   all_to_all_single run: (a) the dryrun's step (shard_batch, filter,
   aggregate, sum, join_indices of the aggregate's keys against the kept
   rows, sort) at 2^27 rows a shard, checked against numpy and, operator by
   operator and bit for bit, against the same step on the plain versions;
   the launches of each operator (the filter must launch B1, the aggregate
   B2 and B1, the sort B3); (b) BASELINE.json configs[4]'s join on one
   shard: 2^27 unique u64 build keys, 2^27 probe keys drawn as the
   group-by's skew, each with an i32 payload, distributed_join(fused=True)
   giving exactly 2^27 rows, checked against a numpy oracle of the (key,
   lv, rv) multiset; each operator's time beside the single-chip operator
   on the same rows (compute.filter, hash_aggregate(method="sort"),
   join_indices, sort_by_key, hash_join), the time of an exchange's count
   read, peak device memory; (a)'s sort and (b)'s join each profiled beside
   its single-chip operator (as in phase 10, with the device time in fills
   and copies); then, if gloo moves CUDA tensors (checked on 2 ranks
   first: only gloo's refusal of the device skips the step, any other
   failure fails the phase), the dryrun's step on 4 gloo ranks sharing
   the card at 2^22 rows a rank, every rank's shards held exactly against
   4 CPU gloo ranks' (no times: the ranks share one card), or the reason
   it was not run; the distributed tools (arrow_tpu_torch.tools):
   dist_sort_1b at P = 1 in the NCCL group on BASELINE.json configs[3]'s
   2^30 rows of u32 key and payload (row conservation, global order, the
   key checksum, each payload following its key; its time, peak device
   memory and launches), and on the 4 gloo ranks sharing the card at 2^20
   rows a rank dist_sort_1b with its checks, one scaling_bench point and
   overlap_ab (the fused and composed joins' rows equal, the u64 route
   hash's share of rank 0's profiled device time);
8. elementwise: the elementwise tier (plain torch ops, as XLA's ops were in
   the JAX package): every registered op over every dtype its API accepts,
   at 2^20 rows with nulls, on the card against the port's CPU result on
   the same inputs (exact, a NaN matching any NaN, except exp, exp2, log,
   log2, cbrt, float power and the trigonometry within rtol 2e-6 / 1e-14
   and float sums within 1e-5 / 1e-12), outputs asserted on the card; then
   the fused pipeline (runtime/fusion.py, kernel fused_pipeline): every one
   of those cases whose op the fusion covers, recorded into one pipeline
   for each ops module (their kernels built together, the builds and their
   seconds printed), each equal to its eager run on the card;
   examples/simple.py's chain and a 6-op chain (arithmetic, cast, compare,
   merge) pipelined against their eager runs and their eager replays
   (plain versions) at 10 485 760 and 2^27 rows, each exactly one launch
   of fused_pipeline a finish(); add_scalar f32, sum_ u32 and both chains
   (fused, and replayed eagerly in turns) timed beside their bounds (8, 4,
   8 and 12.25 bytes a row) and beside a torch expression on the bare
   buffers; the phase's peak device memory; a runtime line:
   Device.synchronize() and memory_stats(), the health probe's latency,
   profiler.device_report's top 5 kernels of the flagship query at 2^27,
   and utils.timing's device time of add_scalar beside its CUDA-event time;
9. probes: the probe tools (arrow_tpu_torch.tools.mosaic_probe and
   probe_r4, the counterparts of tools/mosaic_probe.py and tools/probe_r4.py)
   through their entry points, the launch counts set to 0 just before and
   read just after: mosaic_probe's 25 probes, every one OK against the JAX
   probe's numpy oracle, and probe_r4's seven steps at 2^27 rows (its
   report in build/arrow_tpu_torch/TORCH_PROBE_R4.json: every key of
   PROBE_R4.json, no step failed but the Pallas sum that the JAX package
   no longer has, the mask matmul all 128, the one-rank all_to_all_single's
   head [0, 0, 0, 1, 2, 3, 0, 0]); every one of their 28 kernels launched
   there; then each kernel on the JAX probe's inputs against its plain
   version on the card (exact) and its oracle, the merge steps also with one
   block an SM (every block's output equal), each timed with the host
   ahead of the device (utils.timing.queued_seconds_per_call: calls
   enqueued behind a spin kernel, so that the events time the device's work
   alone; a probe's wrapper takes longer on the host than its kernel on the
   device), beside an empty kernel timed the same way, its bound (bytes, or
   for the two matmuls the tensor-core operations and for the merge steps
   the integer operations of their R = 3 steps where larger), its plain
   version (host-bound for the merge steps, which read R on the host) and
   its library call (take_along_dim, roll, cumsum, sort, _int_mm, a slice's
   clone, pad, x + 1, gt into an int8 or bf16 out, ...; none for the mask
   product, whose bf16 matmul of a mask made beforehand is printed apart,
   the scalar loop and the u32 shifts), and back to back (the wrapper's
   rate); the merge steps' us a step beside one SM's floor for a step (its
   operations over one SM's integer rate); the twenty-two redesigned
   kernels (probe_designs.REDESIGNED: P2, the int8 product, the row slice,
   P4, P3, P7, the transpose, P6, the bitcast, the merge step in both forms,
   the column cumsum, P9, the sublane gather, P5, the row store, the in-row
   sort, the lane cumsum, the lane gather in its four probes, the lane roll
   in its two, the scalar loop, the compare cast in its two and the u32
   shifts: every kernel of the probe tools) timed in turns with their other designs
   (arrow_tpu_torch.tools.probe_designs: the earlier mosaic_probe.cu or
   probe_r4.cu where build/parent/<commit> holds it, and each kernel's
   alternatives, listed in that module), each held to its plain version
   first on the inputs that its held_inputs gives (the row windows at every
   s, the scalar add where its sum wraps, full-range tiles, the merge steps
   on tied, full-range and extreme keys at R = 0, 1 and 5, the sort on six
   tiles, the lane cumsum on 16 one-hot tiles, the lane gathers on six or
   seven index sets, the dynamic roll at every shift in [-130, 260] and at
   both ends of the int32 range, the compare casts on boundary tiles at
   each position of a 16-byte word, the u32 shifts on high-bit words, ...);
   the merge steps also in us a step on one block, in turns;
10. profile: each query at each size under torch.profiler: device busy time,
   the device time in fills and in copies, the device's idle share of the
   query's wall time (also without the idle time spent in the profiler's
   own buffer requests), the device ops that
   take the most time, the CUDA runtime calls that take the most host time,
   and the longest idle gaps with the host events inside them.

A replayed or timed kernel call is timed (CUDA events, the median of 5
samples of 4 back-to-back calls, per call, in turns with its plain version)
beside one PyTorch library call that computes the same function, where there
is one, and given its bound: the bytes it must move (each input row it needs
read once, each output row written once) over the card's 3.35 TB/s.

It then prints the nvidia-smi line, a JSON line with, for every kernel, its
launch count on the main paths (the sort-join query, its 2-bit rerun, the
four group-by queries, the distributed phase's P = 1 operators and
dist_sort_1b, the elementwise phase's pipelined chains and the probe
tools' runs), its largest error against its plain version, and its
kernel, plain, library and bound times summed over the calls of those runs
(B8, B9 and take_columns: over their timed calls of phase 3;
fused_pipeline: simple.py's chain at 2^27, fused, replayed eagerly, and as
(x + 10.0) * 10.0 on the bare buffer; the probe kernels: their calls on the
JAX probes' inputs in phase 9, device times queued behind a spin), and last
the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero without that line; so does a machine
without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
FLAGSHIP_SIZES = (1 << 20, 1 << 27)
# B1's tiles are four parts: 32768 rows (8192 a part) of 4-byte planes,
# 16384 (4096 a part) where a plane is 8 bytes wide
B1_TILES = (16384, 32768)
B1_SIZES = (0, 1, 31, 4095, 4096, 4097, 8191, 8192, 8193, 16383, 16384, 16385, 32767, 32768, 32769,
            5 * 32768 + 3, (1 << 20) + 17, 1 << 27)
# random masks of a selectivity, and patterns that stress the tile edges:
# only the first row, only the last, every other row, the second 8192-row
# block alone
B1_PATTERNS = ("0", "0.01", "0.5", "0.99", "1", "every32", "first", "last", "alternate", "block")
B1_MISALIGNED_N = (8193, (1 << 20) + 17)
B1_RACE_REPEATS = 10
B2_SIZES = (1, 8193, (1 << 20) + 17, 1 << 27)
B2_FLAGS = {"none": 0.0, "sparse": 0.001, "dense": 0.3}
B2_TYPES = ("int32", "uint32", "float32", "int64", "uint64", "float64")
B2_PLANES = (1, 2, 3)
B2_MISALIGNED_N = (1 << 20) + 17
B2_RACE_REPEATS = 10
B3_SIZES = (0, 1, 31, 8193, (1 << 20) + 17, 1 << 27)
B3_WIDTHS = (1, 2, 8)
B3_KEYS = ("int32", "uint32", "float32", "uint64", "int64")
B3_DOMAINS = (2, 10_000, 1 << 32)
B3_BITS_SIZES = ((1 << 20) + 17, 1 << 27)  # given bits, look-back stress, 8 planes
B3_SHAPES = ("skew", "hot", "reversed")
B3_RACE_REPEATS = 10
# B7's tiles are 3712 output rows (a tile of whole pairs where a pair is shorter)
B7_TILE = 3712
B7_SIZES = (1, 31, B7_TILE - 1, B7_TILE, B7_TILE + 1, 8193, 5 * B7_TILE + 3, (1 << 20) + 17, 1 << 27)
B7_RUNS = (1, 7, B7_TILE // 2 - 1, B7_TILE // 2, B7_TILE // 2 + 1, B7_TILE, 8192, "half")
# run pairs that stress the tile edges (see _b7_pattern), checked at B7_PATTERN_N rows
B7_PATTERNS = ("a_below", "b_below", "all_equal", "alternate", "straddle", "expand", "rank_fill")
B7_PATTERN_N = (1 << 20) + 17
B7_RACE_REPEATS = 10
B5_DOMAINS = (1, 7, 1024, 4096)
B6_CLASSES = (1, 2, 256, 1024)
B6_ORDERS = ("skew", "unsorted", "grouped")
B8_FORMS = ("0", "0.01", "0.5", "0.99", "1", "first", "last", "alternate", "block", "bit0", "bit31")
TIMED_N = 1 << 27  # where B8 and B9 are timed
# take_columns (the join's take): (capacity, length) of its index planes, the
# column kinds (torch dtype names, "bool": packed bits), and the shapes of
# join q5 (h2o db-benchmark J1_1e8: 9e7 of 2^27 emit rows live, sources of
# 1e8 rows, 6 u32 and 1 f64 column a side) where it is timed
TAKE_SHAPES = ((0, 0), (64, 0), (64, 64), (130, 37), (257, 255), (8193, 8191), ((1 << 20) + 4, 1_000_003))
TAKE_KINDS = ("int8", "int16", "int32", "float32", "int64", "float64", "bool")
TAKE_Q5_CAP, TAKE_Q5_LIVE, TAKE_Q5_ROWS = 1 << 27, 90_000_000, 100_000_000
TAKE_Q5_SIDE = ("int32",) * 6 + ("float64",)
SECTOR_BYTES = 32  # what the card fetches for one random element
SORT_JOIN_N = 1 << 27
GROUPBY_N = 1 << 27
# kernels that the group-by query's auto route must launch, by key distribution
GROUPBY_ROUTES = {"1k": ("groupby_dense",), "1m": ("radix_sort", "groupby_region"),
                  "skew": ("radix_sort", "groupby_region"), "100m": ("radix_sort", "segmented_scan")}
# the partition route's class sort (bits 12-19) is one 8-bit pass
GROUPBY_ONE_PASS = ("1m", "skew")
# the distributed phase: rows a shard at P = 1 (DIST_SORT_1B.json puts 2^26-2^27
# rows on each chip of the BASELINE's 1B-row configurations), and the gloo ranks
# that share the card and their rows a rank
DIST_N = 1 << 27
DIST_P4_RANKS = 4
DIST_P4_N = 1 << 22
# arrow_tpu_torch.tools: dist_sort_1b at P = 1 on BASELINE.json configs[3]'s
# 2^30 rows of u32 key and payload, and the three tools on DIST_P4_RANKS gloo
# ranks sharing the card at DIST_TOOLS_N rows a rank
DIST_1B_ROWS = 1 << 30
DIST_TOOLS_N = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's data-sheet memory rate
CROSSOVER_SIZES = (1 << 24, 1 << 26, 1 << 27)
# float adds differ from the plain ladder in summation order only
ADD_RTOL = {"float32": 1e-6, "float64": 1e-12}
REPS = 5
# a timed kernel call is a run of this many back-to-back calls, so that the
# wrapper's host work overlaps the device work of the call before it
CALLS_PER_SAMPLE = 4
PROFILE_TOP = 8
PROFILE_GAPS = 4  # the longest device-idle gaps of a profiled query, printed
# the device functions of the hand-written kernels (arrow_tpu_torch/csrc)
OWN_DEVICE_FUNCTIONS = ("compact_pass", "seg_lookback",
                        "radix_histogram", "radix_scan_histogram", "radix_onesweep", "radix_or_and",
                        "merge_partition", "merge_tiles", "dense_histogram", "region_histogram",
                        "take_columns_kernel")

# device ops that profile_query sums apart: buffers filled with a constant
# (zeros), and copies (memcpy, torch's copy and concatenation kernels, NCCL)
FILL_OPS = ("FillFunctor", "Memset")
COPY_OPS = ("Memcpy", "copy_kernel", "CatArrayBatchedCopy", "nccl")


class PhaseFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi printed no card")
    return out[0]


def _event_ms(fn, calls=1) -> float:
    """CUDA-event time of `calls` back-to-back fn() calls, synchronised, per call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def cuda_ms(fn, calls=1):
    """Median of REPS timed samples (of `calls` calls each) after one warm-up."""
    fn()
    return statistics.median(_event_ms(fn, calls) for _ in range(REPS))


def interleaved_ms(kernel_fn, plain_fn, calls=1):
    """Median times of two versions after a warm-up, timed in turns on one
    card, REPS samples of `calls` calls each."""
    kernel_fn(), plain_fn()
    pairs = [(_event_ms(kernel_fn, calls), _event_ms(plain_fn, calls)) for _ in range(REPS)]
    return statistics.median(k for k, _ in pairs), statistics.median(p for _, p in pairs)


@contextlib.contextmanager
def plain_path():
    from arrow_tpu_torch.compute.kernels import plain_versions

    with plain_versions():
        yield


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise PhaseFailed("torch.cuda.is_available() is false: this script needs a CUDA GPU")
    line = smi_line()
    print(line)
    print(f"device: {torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}; CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    return line


def phase_build():
    from arrow_tpu_torch.compute.kernels import _build

    t0 = time.perf_counter()
    lib = _build.load()
    wall = time.perf_counter() - t0
    log_path = lib.path.parent / "nvcc.log"
    log_path.write_text(lib.log)
    # ptxas -v: "Used 24 registers, ..." and "0 bytes spill stores, 0 bytes spill loads"
    regs = [int(w.split()[0]) for w in lib.log.split("Used ")[1:] if w.split()[0].isdigit()]
    spilled = [
        ln for ln in lib.log.splitlines()
        if "spill stores" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln
    ]
    print(f"build: nvcc {lib.build_seconds:.1f} s (load {wall:.1f} s) -> {lib.path.name}; "
          f"{len(regs)} kernels, max {max(regs) if regs else 0} registers/thread; "
          f"{len(spilled)} with spills; log {log_path}")


def _rand_mask(n, pattern, gen, device):
    import torch

    rows = torch.arange(n, device=device)
    shaped = {"every32": lambda: rows % 32 == 0, "first": lambda: rows == 0, "last": lambda: rows == n - 1,
              "alternate": lambda: rows % 2 == 0, "block": lambda: (rows >= 8192) & (rows < 16384)}
    if pattern in shaped:
        return shaped[pattern]()
    return torch.rand(n, generator=gen, device=device) < float(pattern)


def _b1_planes(kind, n, gen, device, offset=0):
    """(value planes, bitmap planes) of a B1 case: "4-byte" (two 4-byte
    planes: 8192-row tiles), "mixed" (4- and 8-byte planes and a bitmap plane:
    4096-row tiles) or "16 planes" (4-, 8-byte and bitmap planes mixed).
    With `offset`, each plane is a view that starts `offset` rows (bitmap
    planes: words) into a larger tensor."""
    import torch

    from arrow_tpu_torch.utils import bits as B

    def i32():
        return torch.randint(-(2**31), 2**31, (n + offset,), dtype=torch.int32, generator=gen, device=device)

    def f32():
        return torch.randn(n + offset, generator=gen, device=device)

    def i64():
        return torch.randint(-(2**62), 2**62, (n + offset,), generator=gen, device=device)

    def f64():
        return torch.randn(n + offset, dtype=torch.float64, generator=gen, device=device)

    def bitmap():
        return B.pack_bits(torch.rand(n + 32 * offset, generator=gen, device=device) < 0.5)

    makers = {"4-byte": ((i32, f32), ()), "mixed": ((i32, f64), (bitmap,)),
              "16 planes": ((i32, i64, f32, f64, i32, i64, f32, f64, i32, i64, f32, f64), (bitmap,) * 4)}[kind]
    return ([m()[offset:] for m in makers[0]], [m()[offset:] for m in makers[1]])


def _b1_case(C3, vplanes, wplanes, mask, n):
    """One B1 call against its plain version: (exact incl. zero tail and
    count, max abs err)."""
    import torch

    kv, kw, kc = C3.compact_multi(vplanes, wplanes, mask, n)
    pv, pw, pc = C3.compact_multi_plain(vplanes, wplanes, mask, n)
    torch.cuda.synchronize()
    ok, err = _exact(kv + kw, pv + pw)
    return ok and int(kc) == int(pc), err


def check_b1(device, gen):
    """B1 over lengths at and around its tile sizes, random and shaped masks
    and two plane sets; 16 mixed planes; views one row in; a race check."""
    import torch

    from arrow_tpu_torch.compute.kernels import compaction3 as C3
    from arrow_tpu_torch.utils import bits as B

    worst, cases, failures = 0.0, 0, []
    for n in B1_SIZES:
        for kind in ("4-byte", "mixed"):
            vplanes, wplanes = _b1_planes(kind, n, gen, device)
            for pattern in B1_PATTERNS:
                cases += 1
                ok, err = _b1_case(C3, vplanes, wplanes, B.pack_bits(_rand_mask(n, pattern, gen, device)), n)
                worst = max(worst, err)
                if not ok:
                    failures.append(f"n={n} {kind} mask={pattern}")
            del vplanes, wplanes
        torch.cuda.empty_cache()
    for n in (*B1_TILES, B1_MISALIGNED_N[-1]):
        vplanes, wplanes = _b1_planes("16 planes", n, gen, device)
        require(len(vplanes) + len(wplanes) == C3.MAX_PLANES, "the widest case is not MAX_PLANES planes")
        for pattern in ("0.5", "first", "last", "alternate"):
            cases += 1
            ok, err = _b1_case(C3, vplanes, wplanes, B.pack_bits(_rand_mask(n, pattern, gen, device)), n)
            worst = max(worst, err)
            if not ok:
                failures.append(f"16 planes n={n} mask={pattern}")
    for n in B1_MISALIGNED_N:  # views one row (bitmaps and mask: one word) in
        for kind in ("4-byte", "mixed", "16 planes"):
            vplanes, wplanes = _b1_planes(kind, n, gen, device, offset=1)
            require(all(p.data_ptr() % 16 for p in vplanes + wplanes), "the views are aligned")
            for pattern in ("0.5", "first", "last", "alternate", "block"):
                cases += 1
                mask = torch.cat([torch.zeros(1, dtype=torch.int32, device=device),
                                  B.pack_bits(_rand_mask(n, pattern, gen, device))])[1:]
                ok, err = _b1_case(C3, vplanes, wplanes, mask, n)
                worst = max(worst, err)
                if not ok:
                    failures.append(f"misaligned n={n} {kind} mask={pattern}")
            del vplanes, wplanes
    print(f"kernels: compact_multi vs plain: {cases} cases (n in {list(B1_SIZES)}, masks {list(B1_PATTERNS)}, "
          f"two 4-byte planes or 4- and 8-byte value planes + a bitmap plane; {C3.MAX_PLANES} mixed planes at n in "
          f"{[*B1_TILES, B1_MISALIGNED_N[-1]]}; views one row in, mask and bitmaps one word in, at n in "
          f"{list(B1_MISALIGNED_N)}), exact incl. zero tail and count; max abs err {worst}; failures {failures}")
    require(not failures, "compact_multi disagrees with its plain version")

    # the race check: the look-back's order of publication varies from run to
    # run; the output may not
    n = B1_SIZES[-1]
    planes = [torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, generator=gen, device=device),
              torch.randn(n, generator=gen, device=device), torch.arange(n, dtype=torch.int32, device=device)]
    mask = B.pack_bits(_rand_mask(n, "0.5", gen, device))
    race = {}
    for name, run in (("compact_multi", lambda: C3.compact_multi(planes, [], mask, n)),
                      ("split_multi", lambda: C3.split_multi(planes, mask))):
        first = run()
        same = True
        for _ in range(B1_RACE_REPEATS - 1):
            again = run()
            torch.cuda.synchronize()
            same &= _exact(_flat(again), _flat(first))[0]
            del again
        want = (C3.compact_multi_plain(planes, [], mask, n) if name == "compact_multi"
                else C3.split_multi_plain(planes, mask))
        race[name] = same and _exact(_flat(first), _flat(want))[0]
        del first, want
    print(f"kernels: compact_multi and split_multi race check: {B1_RACE_REPEATS} repeats each of a 3-plane "
          f"compaction and a 3-plane split by a 0.5 mask at n={n}: each equal bit for bit to the first repeat "
          f"and to the plain version, count included: {race}")
    require(all(race.values()), f"compaction or split differs between repeats or from plain: {race}")
    del planes, mask
    torch.cuda.empty_cache()
    return worst


def _flat(result):
    """A compaction's or split's outputs and count as one tuple of tensors."""
    return (*result[0], *result[1], result[2].reshape(1))


def _b2_values(name, n, gen, device):
    import torch

    if name in ("float32", "float64"):  # positive: a well-conditioned sum
        return torch.rand(n, generator=gen, device=device, dtype=getattr(torch, name)) + 0.5, False
    dtype = torch.int32 if name.endswith("32") else torch.int64
    bits = 32 if dtype == torch.int32 else 64
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return torch.randint(lo, hi, (n,), dtype=dtype, generator=gen, device=device), name.startswith("u")


def _b2_compare(got, want, op):
    """(matches, max abs err, max rel err) of a scan's planes against the
    plain version's: float adds within ADD_RTOL, everything else exact."""
    import torch

    ok, err, rel = True, 0.0, 0.0
    for g, w in zip(got, want):
        if w.is_floating_point():
            err = max(err, float((g.double() - w.double()).abs().max()))
            r = _max_rel(g, w)
            rel = max(rel, r)
            ok &= (r <= ADD_RTOL[str(w.dtype)[6:]]) if op == "add" else bool(torch.equal(g, w))
        else:
            ok &= bool(torch.equal(g, w))
    return ok, err, rel


def check_b2(device, gen, smi):
    """B2 over lengths, dtypes, 1-3 planes, flag densities and ops; views with
    a storage offset; a race check; then four calls timed at TIMED_N rows."""
    import torch

    from arrow_tpu_torch.compute.kernels import segscan as S

    worst_abs, cases = 0.0, 0
    worst_rel = {"float32": 0.0, "float64": 0.0}
    standin_rel = float("inf")  # smallest error of the f32-accumulating stand-in
    failures = []
    for n in B2_SIZES:
        for name in B2_TYPES:
            for nplanes in B2_PLANES:
                planes, unsigned = [], False
                for _ in range(nplanes):
                    vals, unsigned = _b2_values(name, n, gen, device)
                    planes.append(vals)
                for fname, density in B2_FLAGS.items():
                    flags = torch.rand(n, generator=gen, device=device) < density if density else None
                    for op in S.OPS:
                        if nplanes == 1:  # the one-plane entry the operators call
                            got = [S.segmented_scan(planes[0], flags, op, unsigned)]
                        else:
                            got = S.segmented_scan_multi(planes, flags, op, unsigned)
                        want = S.segmented_scan_multi_plain(planes, flags, op, unsigned)
                        torch.cuda.synchronize()
                        cases += 1
                        ok, err, rel = _b2_compare(got, want, op)
                        worst_abs = max(worst_abs, err)
                        if op == "add" and name in worst_rel:
                            worst_rel[name] = max(worst_rel[name], rel)
                        if nplanes == 1 and name == "float64" and op == "add":
                            # what a B2 that kept the group-by's f64 sum in f32 would give
                            standin = S.segmented_scan(planes[0].float(), flags, "add").double()
                            standin_rel = min(standin_rel, _max_rel(standin, want[0]))
                        if not ok:
                            failures.append(f"n={n} {name} planes={nplanes} flags={fname} op={op}")
                        del got, want
                del planes
            torch.cuda.empty_cache()
    n = B2_MISALIGNED_N
    for name in B2_TYPES:  # views one row in: the kernel's element-wise path
        bases = [_b2_values(name, n + 1, gen, device) for _ in range(2)]
        unsigned = bases[0][1]
        planes = [b[0][1:] for b in bases]
        flags = (torch.rand(n + 1, generator=gen, device=device) < B2_FLAGS["sparse"])[1:]
        require(planes[0].data_ptr() % 16 != 0 and flags.data_ptr() % 16 != 0, "the views are aligned")
        for op in S.OPS:
            got = S.segmented_scan_multi(planes, flags, op, unsigned)
            want = S.segmented_scan_multi_plain(planes, flags, op, unsigned)
            torch.cuda.synchronize()
            cases += 1
            ok, err, _rel = _b2_compare(got, want, op)
            worst_abs = max(worst_abs, err)
            if not ok:
                failures.append(f"misaligned n={n} {name} op={op}")
        del bases, planes, flags
    print(f"kernels: segmented_scan vs plain: {cases} cases (n in {list(B2_SIZES)}, "
          f"ops {list(S.OPS)}, i32/u32/f32/i64/u64/f64, {list(B2_PLANES)} planes, flags "
          f"{list(B2_FLAGS)}; and 2-plane views one row in, flags too, at n={n}); integers and "
          f"max/min/first exact, float add rtol {ADD_RTOL}; max abs err {worst_abs}; "
          f"failures {failures}")
    print(f"kernels: segmented_scan f32 add: max rel err {worst_rel['float32']} "
          f"(rtol {ADD_RTOL['float32']})")
    print(f"kernels: segmented_scan f64 add: max rel err {worst_rel['float64']} "
          f"(rtol {ADD_RTOL['float64']}); an f32-accumulating stand-in reads at least "
          f"{standin_rel} on the same cases, so the check rejects it")
    require(not failures, "segmented_scan disagrees with its plain version")
    require(standin_rel > ADD_RTOL["float64"], "the f64 add check would pass an f32 accumulator")

    # the race check: the look-back's order of publication varies from run to
    # run; integer results and `first` may not
    n = B2_SIZES[-1]
    vals = _b2_values("int32", n, gen, device)[0]
    flags = torch.rand(n, generator=gen, device=device) < B2_FLAGS["sparse"]
    race = {}
    for op in ("first", "add"):
        want = S.segmented_scan_plain(vals, flags, op)
        runs = [S.segmented_scan(vals, flags, op) for _ in range(B2_RACE_REPEATS)]
        torch.cuda.synchronize()
        race[op] = bool(torch.equal(runs[0], want)) and all(bool(torch.equal(r, runs[0])) for r in runs)
        del want, runs
    print(f"kernels: segmented_scan race check: {B2_RACE_REPEATS} repeats each of i32 first and i32 "
          f"add at n={n}, sparse flags: each equal bit for bit to the first repeat and to the plain "
          f"version: {race}")
    require(all(race.values()), f"segmented_scan differs between repeats or from plain: {race}")
    del vals, flags
    torch.cuda.empty_cache()

    def i32(count):
        return [_b2_values("int32", TIMED_N, gen, device)[0] for _ in range(count)]

    def dense():
        return torch.rand(TIMED_N, generator=gen, device=device) < B2_FLAGS["dense"]

    timed = (
        ("i32 add, no flags", lambda: (i32(1), None, "add", False)),
        ("i32 max, dense flags", lambda: (i32(1), dense(), "max", False)),
        ("f64 add, sparse flags", lambda: ([_b2_values("float64", TIMED_N, gen, device)[0]],
                                           torch.rand(TIMED_N, generator=gen, device=device)
                                           < B2_FLAGS["sparse"], "add", False)),
        ("3 i32 planes, max, dense flags", lambda: (i32(3), dense(), "max", False)),
    )
    for label, make in timed:
        args = make()
        m, what = measure_call("segmented_scan", args)
        print(f"kernels: segmented_scan at n={TIMED_N}, {label} ({what}): {m.line()} ({smi})")
        del args
        torch.cuda.empty_cache()
    return worst_abs


def _max_rel(got, want) -> float:
    diff = (got.double() - want.double()).abs()
    return float((diff / want.double().abs().clamp_min(1e-300)).max()) if diff.numel() else 0.0


def _b3_keys(name, n, domain, gen, device):
    """Keys of Arrow type `name` drawn below `domain` (signed types around 0;
    64-bit keys with the draw in both halves; floats with +-0, +-NaN and
    +-inf mixed in) and their sort code, the plane B3 sorts by."""
    import torch

    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.compute.sort import key_code
    from arrow_tpu_torch.utils import bits as B

    def draw():
        v = torch.randint(0, domain, (n,), generator=gen, device=device, dtype=torch.int64)
        return v - domain // 2 if name.startswith(("int", "float")) else v

    if name in ("uint64", "int64"):
        data = (draw() << 32) + draw()
    elif name == "float32":
        data = draw().float()
        specials = torch.tensor([0, -(2**31), 0x7FC00000, -4194304, 0x7F800000, -8388608],
                                dtype=torch.int32, device=device).view(torch.float32)
        pick = torch.randint(0, 6, (n,), generator=gen, device=device)
        data = torch.where(torch.rand(n, generator=gen, device=device) < 0.05, specials[pick], data)
    else:
        data = B.to_int32(draw() & 0xFFFFFFFF)
    return key_code(data, dt.ArrowType(name))


def _b3_payloads(count, n, gen, device):
    import torch

    makers = (
        lambda: torch.arange(n, dtype=torch.int32, device=device),  # the stability witness
        lambda: torch.randn(n, dtype=torch.float64, generator=gen, device=device),
        lambda: torch.randint(-(2**62), 2**62, (n,), generator=gen, device=device),
        lambda: torch.randn(n, generator=gen, device=device),
    )
    return [make() for make in makers[:count]]


def _b3_shaped_key(shape, n, gen, device):
    """An int32 key plane that stresses the look-back: "skew" is the group-by's
    skewed distribution (a quarter of the rows in class 0), "hot" has one
    value in 99% of the rows, "reversed" is a descending arange."""
    import torch

    if shape == "skew":
        from arrow_tpu_torch import flagship

        keys = flagship.make_groupby_columns(n, "skew", seed=0)["k"]
        return torch.from_numpy(keys.view("int32")).to(device)
    if shape == "hot":
        cold = torch.randint(0, 1 << 31, (n,), generator=gen, device=device).to(torch.int32)
        return torch.where(torch.rand(n, generator=gen, device=device) < 0.99,
                           torch.full_like(cold, 0x00ABCDEF), cold)
    return torch.arange(n - 1, -1, -1, dtype=torch.int32, device=device)


def _b3_case(R, planes, bits, n, width, passes=None):
    """One call of the kernel against its plain version: (all planes equal,
    max abs err).  `passes`: the number of passes the kernel must make."""
    import torch

    counter = R.KERNEL_2BIT if width == 2 else R.KERNEL
    counter.passes = 0
    got = R.radix_sort(planes, bits, n, width)
    made = counter.passes
    want = R.radix_sort_plain(planes, bits, n, width)
    torch.cuda.synchronize()
    ok, err = _exact(got, want)
    return ok and (passes is None or made == passes), err


def check_b3(device, gen, smi):
    """B3 at digit widths 1, 2 and 8 (2 is B4) against its plain version:
    the significant bits of random keys; given bit positions; keys that
    stress the look-back; 8 planes; a race check; the cost of the
    significant-bits reduction."""
    import torch

    from arrow_tpu_torch.compute.kernels import radix as R

    worst, cases, failures = 0.0, 0, []
    for n in B3_SIZES:
        full = n == B3_SIZES[-1]
        for wi, width in enumerate(B3_WIDTHS):
            for ki, key in enumerate(B3_KEYS):
                # at full size one domain per (width, key), in turn
                domains = [B3_DOMAINS[(wi + ki) % 3]] if full else B3_DOMAINS
                for domain in domains:
                    cases += 1
                    code = _b3_keys(key, n, domain, gen, device)
                    planes = [code, *_b3_payloads(1 + cases % (2 if full else 4), n, gen, device)]
                    ok, err = _b3_case(R, planes, 8 * code.element_size(), n, width)
                    worst = max(worst, err)
                    if not ok:
                        failures.append(f"n={n} width={width} {key} domain={domain}")
                    del planes
        torch.cuda.empty_cache()
    print(f"kernels: radix_sort vs plain: {cases} cases (n in {list(B3_SIZES)}, digit widths "
          f"{list(B3_WIDTHS)} (2 is radix_sort_2bit), keys {list(B3_KEYS)} as sort codes, "
          f"key domains {list(B3_DOMAINS)}, 1-4 payload planes of 4 and 8 bytes), exact incl. "
          f"zero tail; max abs err {worst}; failures {failures}")
    require(not failures, "radix_sort disagrees with its plain version")

    # given bit positions (the digits start where the bits do), keys that
    # stress the look-back, and 8 planes of mixed widths
    extra = 0
    for n in B3_BITS_SIZES:
        for width in B3_WIDTHS:
            if n == B3_SIZES[-1] and width != 8:
                continue
            for key in ("uint32", "int64"):
                top = 8 * (8 if key == "int64" else 4) - 1
                for name, bits, passes in (("class bits", range(12, 20), {8: 1}), ("top bit", [top], {8: 1, 2: 1, 1: 1}),
                                           ("scattered", [3, 17, 30], {8: 3, 1: 3})):
                    extra += 1
                    code = _b3_keys(key, n, 1 << 32, gen, device)
                    planes = [code, *_b3_payloads(1 + extra % 3, n, gen, device)]
                    ok, err = _b3_case(R, planes, bits, n, width, passes.get(width))
                    worst = max(worst, err)
                    if not ok:
                        failures.append(f"bits {name}: n={n} width={width} {key}")
                    del planes
            for shape in B3_SHAPES:
                extra += 1
                planes = [_b3_shaped_key(shape, n, gen, device), *_b3_payloads(2, n, gen, device)]
                ok, err = _b3_case(R, planes, range(12, 20) if shape == "skew" else 32, n, width,
                                   1 if shape == "skew" and width == 8 else None)
                worst = max(worst, err)
                if not ok:
                    failures.append(f"key shape {shape}: n={n} width={width}")
                del planes
            extra += 1
            same = torch.full((n,), 0x01234567, dtype=torch.int32, device=device)
            ok, err = _b3_case(R, [same, *_b3_payloads(1, n, gen, device)], 32, n, width, 0)
            if not ok:
                failures.append(f"all-equal key: n={n} width={width}")
        torch.cuda.empty_cache()
    n = B3_BITS_SIZES[0]
    for key in ("uint32", "uint64"):
        for width in B3_WIDTHS:
            extra += 1
            code = _b3_keys(key, n, 1 << 32, gen, device)
            pay = _b3_payloads(4, n, gen, device)
            planes = [code, *pay, pay[1].float(), pay[2] ^ 0x5555, pay[0] + 1]
            require(len(planes) == R.MAX_PLANES, "the widest case is not MAX_PLANES planes")
            ok, err = _b3_case(R, planes, 8 * code.element_size(), n, width)
            worst = max(worst, err)
            if not ok:
                failures.append(f"8 planes: n={n} width={width} {key}")
            del planes, pay
    torch.cuda.empty_cache()
    print(f"kernels: radix_sort vs plain: {extra} more cases (n in {list(B3_BITS_SIZES)}; given bits "
          f"12-19 (one 8-bit pass), the top bit alone (the clamped digit), bits [3, 17, 30]; key shapes "
          f"{list(B3_SHAPES)} and an all-equal key (no pass); 8 planes of 4 and 8 bytes at n={n}; "
          f"widths {list(B3_WIDTHS)}, 8 only at n={B3_SIZES[-1]}), exact incl. zero tail and the number "
          f"of passes; failures {failures}")
    require(not failures, "radix_sort disagrees with its plain version")

    # the race check: the look-back's order of publication varies from run to
    # run; the sorted planes may not
    n = B3_SIZES[-1]
    race = {}
    for name, key, bits in (
        ("31 bits", torch.randint(0, 1 << 31, (n,), generator=gen, device=device).to(torch.int32), 32),
        ("skew class sort", _b3_shaped_key("skew", n, gen, device), range(12, 20)),
    ):
        planes = [key, torch.arange(n, dtype=torch.int32, device=device)]
        want = R.radix_sort_plain(planes, bits, n, 8)
        first = R.radix_sort(planes, bits, n, 8)
        torch.cuda.synchronize()
        same = _exact(first, want)[0]
        for _ in range(B3_RACE_REPEATS - 1):
            again = R.radix_sort(planes, bits, n, 8)
            torch.cuda.synchronize()
            same &= _exact(again, first)[0]
            del again
        race[name] = same
        del planes, want, first, key
        torch.cuda.empty_cache()
    print(f"kernels: radix_sort race check: {B3_RACE_REPEATS} repeats each of a 2-plane sort at n={n} by 31 "
          f"significant bits (4 passes) and of the skewed keys' class sort (bits 12-19, 1 pass): each "
          f"equal bit for bit to the first repeat and to the plain version: {race}")
    require(all(race.values()), f"radix_sort differs between repeats or from plain: {race}")

    key = torch.randint(0, 1 << 31, (n,), generator=gen, device=device).to(torch.int32)
    or_and_ms = cuda_ms(lambda: R.significant_mask_cuda(key, n), CALLS_PER_SAMPLE)
    print(f"kernels: radix_sort's significant-bits reduction (radix_or_and, its own read of the key and "
          f"one host sync) at n={n}, 4-byte keys: {or_and_ms:.3f} ms a call, bound "
          f"{4 * n / HBM_BYTES_PER_S * 1e3:.4f} ms ({smi})")
    del key
    torch.cuda.empty_cache()
    return worst


def _b7_runs(n, run_len, unique, payloads, gen, device):
    """int32 planes holding sorted runs of `run_len` rows: heavy duplicates,
    the int32 extremes and the merge sentinel as keys, row ids as the first
    payload (the unique one in unique mode), random payloads after it."""
    import torch

    pool = torch.tensor([-(2**31), -1, 0, 3, 2**31 - 2, 2**31 - 1], dtype=torch.int32, device=device)
    keys = pool[torch.randint(0, 6, (n,), generator=gen, device=device)]
    rows = torch.arange(n, dtype=torch.int32, device=device)
    full = n - n % run_len
    parts_k, parts_r = [], []
    for lo, hi, width in ((0, full, run_len), (full, n, n - full)):
        if hi > lo:
            k = keys[lo:hi].view(-1, width)
            order = torch.sort(k, dim=1, stable=True).indices
            parts_k.append(torch.gather(k, 1, order).reshape(-1))
            parts_r.append(torch.gather(rows[lo:hi].view(-1, width), 1, order).reshape(-1))
    extra = [torch.randint(-(2**31), 2**31, (n,), generator=gen, device=device, dtype=torch.int64)
             .to(torch.int32) for _ in range(0 if unique else payloads - 1)]
    return [torch.cat(parts_k), torch.cat(parts_r), *extra]


def _b7_pattern(name, n, run_len, unique, gen, device):
    """int32 planes of n rows whose every run pair (A, B) has one shape: A
    entirely below B or above it; all keys equal; strictly alternating keys;
    a run of equal keys straddling the pair's middle (A's last and B's first
    quarter); the join's expand call (A strictly increasing run ends, then
    sentinels; B an arange); its rank-fill call (A an arange; B sorted ranks
    with duplicates, then sentinels).  Plane 1 holds row ids (the unique
    payload); without `unique`, plane 2 random values."""
    import torch

    from arrow_tpu_torch.compute.kernels.merge import SENT

    rows = torch.arange(n, device=device)
    pair = 2 * run_len
    lo = rows // pair * pair
    la = torch.clamp(n - lo, max=run_len)  # the pair's A rows
    lb = torch.clamp(n - lo - la, max=run_len)
    in_b = rows - lo >= la
    r = torch.where(in_b, rows - lo - la, rows - lo)  # the row's index in its run
    length = torch.where(in_b, lb, la)
    if name == "a_below":
        key = torch.where(in_b, 2 * la + 2 * r, 2 * r - 5)
    elif name == "b_below":
        key = torch.where(in_b, r - 1000, lb + r)
    elif name == "all_equal":
        key = torch.full_like(rows, 7)
    elif name == "alternate":
        key = 2 * r + in_b
    elif name == "straddle":  # 100 across the middle; below it in A, above it in B
        key = torch.where(in_b, torch.where(r < length // 4, 100, 101 + r), torch.where(
            r >= length - length // 4, 100, r - length))
    elif name == "expand":  # A: strictly increasing ends (steps of 1-3) on its first half
        step = torch.randint(1, 4, (n,), generator=gen, device=device)
        ends = torch.cumsum(torch.where(in_b, 0, step), 0)
        ends = ends - torch.where(lo > 0, ends[torch.clamp(lo - 1, min=0)], 0)
        key = torch.where(in_b, r, torch.where(r < la // 2, ends, SENT))
    elif name == "rank_fill":  # B: ranks r // 3 (each three times) on its first two thirds
        key = torch.where(in_b, torch.where(r < length - length // 3, r // 3, SENT), r)
    else:
        raise ValueError(f"no merge pattern {name!r}")
    planes = [key.to(torch.int32), rows.to(torch.int32)]
    if not unique:
        planes.append(torch.randint(-(2**31), 2**31, (n,), generator=gen, device=device, dtype=torch.int64)
                      .to(torch.int32))
    return planes


def check_b7(device, gen):
    """B7 over lengths and run lengths around its tile, ragged last runs and
    byes, both modes; run pairs of edge shapes; 8 planes; views one row in;
    a race check."""
    import torch

    from arrow_tpu_torch.compute.kernels import merge as M

    worst, cases, failures = 0.0, 0, []

    def case(label, planes, run_len, unique):
        nonlocal worst, cases
        cases += 1
        got, want = M.merge_pass(planes, run_len, unique), M.merge_pass_plain(planes, run_len, unique)
        torch.cuda.synchronize()
        ok, err = _exact(got, want)
        worst = max(worst, err)
        if not ok:
            failures.append(label)

    for n in B7_SIZES:
        for run in B7_RUNS:
            run_len = max(1, n // 2) if run == "half" else run
            if n == B7_SIZES[-1] and run_len < 8192:
                continue  # shorter runs are checked up to 2^20 rows
            for unique in (False, True):
                planes = _b7_runs(n, run_len, unique, 1 + cases % 3, gen, device)
                case(f"n={n} run_len={run_len} unique={unique}", planes, run_len, unique)
                del planes
        torch.cuda.empty_cache()
    n = B7_PATTERN_N
    for name in B7_PATTERNS:
        for run_len in ((n + 1) // 2, 8192):
            for unique in (False, True):
                planes = _b7_pattern(name, n, run_len, unique, gen, device)
                case(f"{name} n={n} run_len={run_len} unique={unique}", planes, run_len, unique)
    for n in (B7_TILE + 1, B7_PATTERN_N):
        for run_len in (B7_TILE // 2 + 1, (n + 1) // 2):
            base = _b7_runs(n, run_len, False, 2, gen, device)
            extra = [torch.randint(-(2**31), 2**31, (n,), generator=gen, device=device, dtype=torch.int64)
                     .to(torch.int32) for _ in range(M.MAX_PLANES - len(base))]
            case(f"8 planes n={n} run_len={run_len}", base + extra, run_len, False)
    n = B7_PATTERN_N
    for run_len in (B7_TILE // 2 + 1, B7_TILE, (n + 1) // 2):
        for unique in (False, True):  # views one row in: contiguous, not 16-byte aligned
            planes = [torch.cat([torch.zeros(1, dtype=torch.int32, device=device), p])[1:]
                      for p in _b7_runs(n, run_len, unique, 3, gen, device)]
            require(all(p.data_ptr() % 16 for p in planes), "the views are aligned")
            case(f"misaligned n={n} run_len={run_len} unique={unique}", planes, run_len, unique)
    del planes
    torch.cuda.empty_cache()
    print(f"kernels: merge_pass vs plain: {cases} cases (n in {list(B7_SIZES)}, run_len in "
          f"{list(B7_RUNS)} (below 8192 up to 2^20+17 rows), ragged last runs and byes, keys of "
          f"INT32_MIN/-1/0/3/INT32_MAX-1/INT32_MAX (the sentinel), 1-3 payload planes, "
          f"unique-payload mode; run pairs {list(B7_PATTERNS)} at n={B7_PATTERN_N} in one pair and in "
          f"8192-row runs, both modes; {M.MAX_PLANES} planes; views one row in), exact; max abs err {worst}; "
          f"failures {failures}")
    require(not failures, "merge_pass disagrees with its plain version")

    # the race check: a tile's sources and co-ranks may depend on nothing but
    # its inputs; ten repeats of the expand call's shape must agree bit for bit
    n = SORT_JOIN_N
    planes = _b7_pattern("expand", n, n // 2, False, gen, device)
    first = M.merge_pass(planes, n // 2)
    same = True
    for _ in range(B7_RACE_REPEATS - 1):
        again = M.merge_pass(planes, n // 2)
        torch.cuda.synchronize()
        same &= _exact(again, first)[0]
        del again
    race = same and _exact(first, M.merge_pass_plain(planes, n // 2))[0]
    print(f"kernels: merge_pass race check: {B7_RACE_REPEATS} repeats of the expand call's shape (3 planes, one "
          f"pair of 2^26-row runs) at n={n}: each equal bit for bit to the first repeat and to the plain "
          f"version: {race}")
    require(race, "merge_pass differs between repeats or from plain")
    del planes, first
    torch.cuda.empty_cache()
    return worst


def _table_inputs(n, domain, order, gen, device):
    """int32 keys below `domain` (uniform, or floor(u^4 * domain) for
    "skew"), grouped by class (key >> 12) unless "unsorted", and values of
    every 32-bit pattern (u32 up to 2^32 - 1) as int32."""
    import torch

    if order == "skew":
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
        keys = (u.pow(4) * domain).to(torch.int64)
    else:
        keys = torch.randint(0, domain, (n,), generator=gen, device=device)
    if order != "unsorted":
        keys = keys[torch.sort(keys >> 12, stable=True).indices]
    vals = torch.randint(-(2**31), 2**31, (n,), generator=gen, device=device).to(torch.int32)
    return keys.to(torch.int32), vals


def _exact(got, want):
    """(all equal, max abs err) of two tuples of tensors."""
    import torch

    ok = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    err = max((float((g.double() - w.double()).abs().max()) for g, w in zip(got, want) if g.numel()),
              default=0.0)
    return ok, err


def check_b5(device, gen):
    """B5 over lengths and key domains; values of every 32-bit pattern cut
    to 1-4 limbs; `length` below n."""
    import torch

    from arrow_tpu_torch.compute.kernels import groupby_mxu as GM

    worst, cases, failures = 0.0, 0, []
    for n in B1_SIZES:
        for domain in B5_DOMAINS:
            cases += 1
            keys, vals = _table_inputs(n, domain, "unsorted", gen, device)
            nlimb, length = 1 + cases % 4, n - n // 3
            got = GM.groupby_dense(keys, vals, nlimb, length)
            want = GM.groupby_dense_plain(keys, vals, nlimb, length)
            torch.cuda.synchronize()
            ok, err = _exact(got, want)
            worst = max(worst, err)
            if not ok:
                failures.append(f"n={n} domain={domain} nlimb={nlimb}")
            del keys, vals, got, want
        torch.cuda.empty_cache()
    print(f"kernels: groupby_dense vs plain: {cases} cases (n in {list(B1_SIZES)}, key domains "
          f"{list(B5_DOMAINS)}, u32 values up to 2^32-1 cut to 1-4 limbs, length = n - n//3), exact; "
          f"max abs err {worst}; failures {failures}")
    require(not failures, "groupby_dense disagrees with its plain version")
    return worst


def check_b6(device, gen):
    """B6 over lengths, class counts and class orders (skewed and grouped,
    uniform and grouped, unsorted)."""
    import torch

    from arrow_tpu_torch.compute.kernels import region as GR

    worst, cases, failures = 0.0, 0, []
    for n in B1_SIZES:
        for nclass in B6_CLASSES:
            for order in B6_ORDERS:
                cases += 1
                keys, vals = _table_inputs(n, nclass * 4096, order, gen, device)
                nlimb = 4 if cases % 2 else 2
                got = GR.groupby_region(keys, vals, nlimb, nclass)
                want = GR.groupby_region_plain(keys, vals, nlimb, nclass)
                torch.cuda.synchronize()
                ok, err = _exact(got, want)
                worst = max(worst, err)
                if not ok:
                    failures.append(f"n={n} nclass={nclass} order={order}")
                del keys, vals, got, want
        torch.cuda.empty_cache()
    print(f"kernels: groupby_region vs plain: {cases} cases (n in {list(B1_SIZES)}, classes "
          f"{list(B6_CLASSES)}, orders {list(B6_ORDERS)}, u32 values up to 2^32-1 cut to 2 or 4 "
          f"limbs), exact; max abs err {worst}; failures {failures}")
    require(not failures, "groupby_region disagrees with its plain version")
    return worst


def _split_args(n, form, gen, device, offset=0):
    """Three 4-byte planes and the selection of `form`: a mask of that
    selectivity or shape, or "bitK" (the rows whose plane-0 bit K is zero).
    With `offset`, the planes and the mask are views that start `offset` rows
    (the mask: words) into larger tensors."""
    import torch

    from arrow_tpu_torch.utils import bits as B

    planes = [
        torch.randint(-(2**31), 2**31, (n + offset,), generator=gen, device=device).to(torch.int32),
        torch.randn(n + offset, generator=gen, device=device),
        torch.arange(n + offset, dtype=torch.int32, device=device),
    ]
    planes = [p[offset:] for p in planes]
    if form.startswith("bit"):
        return planes, None, int(form[3:])
    mask = B.pack_bits(_rand_mask(n, form, gen, device))
    lead = torch.zeros(offset, dtype=torch.int32, device=device)
    return planes, torch.cat([lead, mask])[offset:], None


def check_b8(device, gen, smi):
    """B8 over lengths, mask selectivities and the bit form; then timed at
    TIMED_N rows (mask form at 0.5; the bit form printed beside it)."""
    import torch

    from arrow_tpu_torch.compute.kernels import compaction3 as C3

    worst, cases, failures = 0.0, 0, []
    for n in B1_SIZES:
        for form in B8_FORMS:
            cases += 1
            args = _split_args(n, form, gen, device)
            got, want = C3.split_multi(*args), C3.split_multi_plain(*args)
            torch.cuda.synchronize()
            ok, err = _exact(got[0] + got[1], want[0] + want[1])
            ok &= int(got[2]) == int(want[2])
            worst = max(worst, err)
            if not ok:
                failures.append(f"n={n} form={form}")
            del args, got, want
        torch.cuda.empty_cache()
    n = B1_MISALIGNED_N[-1]  # views one row (the mask one word) in
    for form in ("0.5", "alternate", "bit0"):
        cases += 1
        planes, mask, bit = _split_args(n, form, gen, device, offset=1)
        require(all(p.data_ptr() % 16 for p in planes), "the views are aligned")
        got, want = C3.split_multi(planes, mask, bit), C3.split_multi_plain(planes, mask, bit)
        torch.cuda.synchronize()
        ok, err = _exact(_flat(got), _flat(want))
        worst = max(worst, err)
        if not ok:
            failures.append(f"misaligned n={n} form={form}")
        del planes, mask, got, want
    print(f"kernels: split_multi vs plain: {cases} cases (n in {list(B1_SIZES)}, selections "
          f"{list(B8_FORMS)}, three 4-byte planes; views one row in at n={n}), exact incl. both zero tails "
          f"and the count; max abs err {worst}; failures {failures}")
    require(not failures, "split_multi disagrees with its plain version")
    timed = {}
    for form in ("0.5", "bit0"):
        args = _split_args(TIMED_N, form, gen, device)
        timed[form], what = measure_call("split_multi", args)
        print(f"kernels: split_multi at n={TIMED_N} ({what}): {timed[form].line()} ({smi})")
        del args
    torch.cuda.empty_cache()
    return worst, timed["0.5"]


def check_b9(device, gen, smi):
    """B9 over lengths and B1's masks; then timed at TIMED_N rows (mask 0.5)."""
    import torch

    from arrow_tpu_torch.compute.kernels import compaction as C1
    from arrow_tpu_torch.utils import bits as B

    worst, cases, failures = 0.0, 0, []
    for n in B1_SIZES:
        data = torch.randint(-(2**31), 2**31, (n,), generator=gen, device=device).to(torch.int32)
        for pattern in B1_PATTERNS:
            cases += 1
            mask = B.pack_bits(_rand_mask(n, pattern, gen, device))
            got, want = C1.compact(data, mask), C1.compact_plain(data, mask)
            torch.cuda.synchronize()
            ok, err = _exact(got, want)
            worst = max(worst, err)
            if not ok:
                failures.append(f"n={n} mask={pattern}")
        del data
    print(f"kernels: compact vs plain: {cases} cases (n in {list(B1_SIZES)}, masks {list(B1_PATTERNS)}, "
          f"one int32 plane), exact incl. zero tail; max abs err {worst}; failures {failures}")
    require(not failures, "compact disagrees with its plain version")
    data = torch.randint(-(2**31), 2**31, (TIMED_N,), generator=gen, device=device).to(torch.int32)
    mask = B.pack_bits(_rand_mask(TIMED_N, "0.5", gen, device))
    timed, what = measure_call("compact", (data, mask))
    print(f"kernels: compact at n={TIMED_N} ({what}): {timed.line()} ({smi})")
    del data, mask
    torch.cuda.empty_cache()
    return worst, timed


def _take_source(kind, n, nulls, gen, device):
    """An AV of exactly `n` buffer rows (BOOL: whole words) on the card,
    with validity words of about half the rows when `nulls`."""
    import torch

    from arrow_tpu_torch import dtypes as dt
    from arrow_tpu_torch.ops.kernel import AV
    from arrow_tpu_torch.utils import bits as B

    def words(rows):
        w = torch.randint(-(2**31), 2**31, (B.num_words(rows),), generator=gen, device=device).to(torch.int32)
        return B.mask_tail(w, rows)

    valid = words(n) if nulls else None
    if kind == "bool":
        return AV(words(n), valid, n, dt.ArrowType.BOOL)
    if kind.startswith("float"):
        data = torch.randn(n, generator=gen, device=device, dtype=getattr(torch, kind))
    else:
        data = torch.randint(-(2**62), 2**62, (n,), generator=gen, device=device).to(getattr(torch, kind))
    return AV(data, valid, n, dt.from_torch_dtype(data.dtype))


def _take_plane(cap, length, rows, gen, device):
    """An int32 index plane of `cap` rows: u32 row ids in [0, rows) for the
    first `length` rows, zeros after them."""
    import torch

    ids = torch.randint(0, rows, (cap,), generator=gen, device=device, dtype=torch.int64)
    ids[length:] = 0
    return ids.to(torch.int32)


def check_take_columns(device, gen, smi):
    """take_columns over the column kinds, with and without validity, at the
    planes' (capacity, length) pairs, with indices past the sources (clamped)
    and 2 to 33 columns (one launch a 16); then timed at join q5's shapes
    beside its bound, its plain version and torch.index_select a column.
    Returns (max abs err, the timed call's Measured)."""
    import torch

    from arrow_tpu_torch.compute.kernels import take as TT

    worst, cases, failures = 0.0, 0, []
    for cap, length in TAKE_SHAPES:
        for ncols in (2, 7, 16, 17, 33):
            cases += 1
            cols = [_take_source(TAKE_KINDS[i % len(TAKE_KINDS)], 45 + 5000 * (i % 3), (i + ncols) % 2 == 1,
                                 gen, device) for i in range(ncols)]
            planes = [_take_plane(cap, length, 5100, gen, device), _take_plane(cap, length, 60, gen, device)]
            planes[1][: length // 7] = -1  # 2^32 - 1: past every source
            columns = [(c, i % 2) for i, c in enumerate(cols)]
            before = TT.KERNEL.launches
            got = TT.take_columns(columns, planes, length)
            torch.cuda.synchronize()
            want = TT.take_columns_plain(columns, planes, length)
            launched = TT.KERNEL.launches - before
            flat = [t for o in got for t in (o.data, o.validity) if t is not None]
            ok, err = _exact(flat, [t for o in want for t in (o.data, o.validity) if t is not None])
            ok &= launched == (-(-ncols // TT.MAX_COLUMNS) if cap else 0)
            worst = max(worst, err)
            if not ok:
                failures.append(f"cap={cap} length={length} columns={ncols} launches={launched}")
            del cols, planes, got, want, flat
    print(f"kernels: take_columns vs plain: {cases} cases ((capacity, length) in {list(TAKE_SHAPES)}, 2-33 "
          f"columns of {list(TAKE_KINDS)}, half with validity, indices past the sources), exact incl. the zero "
          f"tails; max abs err {worst}; failures {failures}")
    require(not failures, "take_columns disagrees with its plain version")
    torch.cuda.empty_cache()

    cap, live, rows = TAKE_Q5_CAP, TAKE_Q5_LIVE, TAKE_Q5_ROWS
    sides = [[_take_source(k, rows, False, gen, device) for k in TAKE_Q5_SIDE] for _ in range(2)]
    planes = [_take_plane(cap, live, rows, gen, device) for _ in range(2)]
    columns = [(c, side) for side in range(2) for c in sides[side]]
    got = TT.take_columns(columns, planes, live)
    want = TT.take_columns_plain(columns, planes, live)
    torch.cuda.synchronize()
    ok, err = _exact([o.data for o in got], [o.data for o in want])
    require(ok, "take_columns at join q5's shapes disagrees with its plain version")
    del got, want
    ms, plain_ms = interleaved_ms(lambda: TT.take_columns(columns, planes, live),
                                  lambda: TT.take_columns_plain(columns, planes, live))
    wide = [p[:live].to(torch.int64) for p in planes]
    library_ms = cuda_ms(lambda: [torch.index_select(c.data, 0, wide[side]) for c, side in columns])
    del wide
    width = sum(c.data.element_size() for c, _ in columns)
    least = 2 * 4 * live + live * width + cap * width  # planes and sources read once, outputs written once
    sectors = 2 * 4 * live + live * SECTOR_BYTES * len(columns) + cap * width
    timed = Measured(err, ms, plain_ms, library_ms, least / HBM_BYTES_PER_S * 1e3)
    print(f"kernels: take_columns at join q5's shapes ({len(columns)} columns, {list(TAKE_Q5_SIDE)} a side, "
          f"sources of {rows} rows, index planes of {cap} rows, {live} live; random ids): {timed.line()}; "
          f"library = torch.index_select a column on the live rows' int64 ids; the floor with a "
          f"{SECTOR_BYTES}-byte sector a random read {sectors / HBM_BYTES_PER_S * 1e3:.4f} ms; "
          f"{least / ms / 1e6:.1f} GB/s of least bytes, {sectors / ms / 1e6:.1f} GB/s with sectors ({smi})")
    del sides, planes, columns
    torch.cuda.empty_cache()
    return err, timed


def phase_kernels(smi):
    """Every kernel against its plain version.  Returns (max abs error by
    kernel, timed calls of B8, B9 and take_columns by kernel)."""
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    errs = {"compact_multi": check_b1(device, gen)}
    torch.cuda.empty_cache()
    errs["segmented_scan"] = check_b2(device, gen, smi)
    torch.cuda.empty_cache()
    errs["radix_sort"] = errs["radix_sort_2bit"] = check_b3(device, gen, smi)
    errs["merge_pass"] = check_b7(device, gen)
    torch.cuda.empty_cache()
    errs["groupby_dense"] = check_b5(device, gen)
    errs["groupby_region"] = check_b6(device, gen)
    timed = {}
    errs["split_multi"], timed["split_multi"] = check_b8(device, gen, smi)
    errs["compact"], timed["compact"] = check_b9(device, gen, smi)
    errs["take_columns"], timed["take_columns"] = check_take_columns(device, gen, smi)
    return errs, timed


# kernel name -> (module, name of the CUDA launcher, name of the plain version)
KERNEL_FUNCTIONS = {
    "compact_multi": ("compaction3", "compact_multi_cuda", "compact_multi_plain"),
    "split_multi": ("compaction3", "split_multi_cuda", "split_multi_plain"),
    "compact": ("compaction", "compact_cuda", "compact_plain"),
    "segmented_scan": ("segscan", "segmented_scan_multi_cuda", "segmented_scan_multi_plain"),
    "radix_sort": ("radix", "radix_sort_cuda", "radix_sort_plain"),
    "merge_pass": ("merge", "merge_pass_cuda", "merge_pass_plain"),
    "groupby_dense": ("groupby_mxu", "groupby_dense_cuda", "groupby_dense_plain"),
    "groupby_region": ("groupby_region", "groupby_region_cuda", "groupby_region_plain"),
}


def _functions(name):
    """(module, CUDA launcher, plain version) of a kernel (the 2-bit radix:
    the radix sort's)."""
    name = "radix_sort" if name == "radix_sort_2bit" else name
    mod = _kernel_module(name)
    _, launcher, plain = KERNEL_FUNCTIONS[name]
    return mod, getattr(mod, launcher), getattr(mod, plain)


@dataclasses.dataclass
class Measured:
    """A kernel's calls, summed: max abs error against the plain version,
    kernel, plain and library times (library None once a call has no
    library equivalent) and the bound (bytes over HBM_BYTES_PER_S, or for
    the probes' matmuls and merge steps operations over OPS_PER_S where
    that is larger: bound_by)."""

    err: float = 0.0
    ms: float = 0.0
    plain_ms: float = 0.0
    library_ms: object = 0.0
    bound_ms: float = 0.0
    bound_by: str = "bytes"

    def __add__(self, other):
        lib = None if self.library_ms is None or other.library_ms is None else self.library_ms + other.library_ms
        return Measured(max(self.err, other.err), self.ms + other.ms, self.plain_ms + other.plain_ms,
                        lib, self.bound_ms + other.bound_ms, self.bound_by)

    def line(self, digits=3):
        lib = "none" if self.library_ms is None else f"{self.library_ms:.{digits}f} ms"
        return (f"kernel {self.ms:.{digits}f} ms, plain {self.plain_ms:.{digits}f} ms, library {lib}, bound "
                f"{self.bound_ms:.{digits + 1}f} ms ({self.bound_by})")


def call_bytes(name, args) -> int:
    """The bytes a call must move: each input row it needs read once (a
    compaction reads its mask and the selected rows only), each output row
    written once (the outputs' zero tails included)."""
    from arrow_tpu_torch.utils import bits as B

    def width(ts, rows):
        return sum(rows * t.element_size() for t in ts)

    if name in ("compact_multi", "compact"):
        vplanes, wplanes, mask, n = args if name == "compact_multi" else ([args[0]], [], args[1], None)
        n = n if n is not None else (vplanes[0].shape[0] if vplanes else mask.shape[0] * 32)
        kept = int(B.unpack_bits(mask[: B.num_words(n)], n).sum())
        return n // 8 + width(vplanes, kept + n) + len(wplanes) * (n // 8 + 4 * n)
    if name == "split_multi":
        vplanes, mask, _bit = args
        n = vplanes[0].shape[0]
        return 3 * width(vplanes, n) + (n // 8 if mask is not None else 0)
    if name == "segmented_scan":
        planes, flags, _op, _unsigned = args
        n = planes[0].shape[0]
        return 2 * width(planes, n) + (n if flags is not None else 0)
    if name.startswith("radix_sort"):
        planes, _bits, n, _width = args
        return 2 * width(planes, planes[0].shape[0] if n is None else n)
    if name == "merge_pass":
        planes = args[0]
        return 2 * width(planes, planes[0].shape[0])
    if name == "groupby_dense":
        keys, _vals, _nlimb, length = args
        rows = keys.shape[0] if length is None else min(length, keys.shape[0])
        return 8 * rows + 4096 * 12
    keys, _vals, _nlimb, nclass = args  # groupby_region
    return 8 * keys.shape[0] + nclass * 4096 * 12


def library_call(name, args):
    """One PyTorch call (per plane) that computes the call's function on its
    inputs, or None where PyTorch has none; what it needs besides (an
    unpacked mask, int64 values) is made here, outside its time."""
    import torch

    from arrow_tpu_torch.compute.kernels.groupby_mxu import SLOTS, value_mask
    from arrow_tpu_torch.utils import bits as B

    if name in ("compact_multi", "compact"):
        vplanes, wplanes, mask, n = args if name == "compact_multi" else ([args[0]], [], args[1], None)
        if wplanes:
            return None
        n = vplanes[0].shape[0] if n is None else n
        sel = B.unpack_bits(mask[: B.num_words(n)], n)
        return lambda: [p[:n][sel] for p in vplanes]
    if name == "segmented_scan":
        planes, flags, op, _unsigned = args
        return (lambda: [torch.cumsum(p, 0) for p in planes]) if flags is None and op == "add" else None
    if name.startswith("radix_sort"):
        planes, _bits, n, _width = args
        key = planes[0][: planes[0].shape[0] if n is None else n]
        return lambda: torch.sort(key, stable=True)
    if name == "merge_pass":
        return lambda: torch.sort(args[0][0], stable=True)
    if name in ("groupby_dense", "groupby_region"):
        keys, vals, nlimb, extra = args
        rows, slots = keys.shape[0], SLOTS
        if name == "groupby_dense" and extra is not None:
            rows = min(extra, rows)
        if name == "groupby_region":
            slots *= extra
        k, v = keys[:rows], vals[:rows].to(torch.int64) & value_mask(nlimb)
        return lambda: (torch.zeros(slots, dtype=torch.int64, device=k.device).index_add_(0, k, v),
                        torch.bincount(k, minlength=slots))
    return None  # split_multi


def measure_call(name, args):
    """One kernel call on its arguments: checked against its plain version
    (as in phase 3), timed beside it and beside its library call, bounded.
    Returns (its Measured, a description of the call)."""
    import torch

    mod, kernel, plain = _functions(name)
    want = plain(*args)
    if name.startswith("radix_sort"):
        mod.KERNEL.passes = mod.KERNEL_2BIT.passes = 0  # _describe reads the kernel call's passes
    got = kernel(*args)
    torch.cuda.synchronize()
    ok, got_t, want_t, what = _describe(name, args, got, want)
    err = max((float((g.double() - w.double()).abs().max()) for g, w in zip(got_t, want_t) if g.numel()),
              default=0.0)
    require(ok, f"{name} ({what}) disagrees with its plain version")
    del got, want, got_t, want_t
    ms, plain_ms = interleaved_ms(lambda: kernel(*args), lambda: plain(*args), CALLS_PER_SAMPLE)
    lib = library_call(name, args)
    library_ms = cuda_ms(lib, CALLS_PER_SAMPLE) if lib is not None else None
    del lib
    bound_ms = call_bytes(name, args) / HBM_BYTES_PER_S * 1e3
    if name in ("compact_multi", "compact"):
        what += f"; {sector_shares(name, args)}"
    return Measured(err, ms, plain_ms, library_ms, bound_ms), what


def sector_shares(name, args) -> str:
    """The share of each value plane's 32-byte sectors (of the first n rows)
    that hold a selected row: a compaction must fetch those, whatever its
    bound counts.  Bitmap planes are read whole."""
    import torch

    from arrow_tpu_torch.utils import bits as B

    vplanes, wplanes, mask, n = args if name == "compact_multi" else ([args[0]], [], args[1], None)
    n = n if n is not None else (vplanes[0].shape[0] if vplanes else mask.shape[0] * 32)
    sel = B.unpack_bits(mask[: B.num_words(n)], n)
    shares = []
    for p in vplanes:
        per = 32 // p.element_size()  # rows a sector
        lead = (p.data_ptr() % 32) // p.element_size()  # rows of the first sector before row 0
        padded = torch.zeros(lead + n + per, dtype=torch.bool, device=sel.device)
        padded[lead:lead + n] = sel
        sectors = (lead + n + per - 1) // per
        shares.append(f"{float(padded[:sectors * per].view(sectors, per).any(1).float().mean()):.4f}"
                      if n else "-")
    bitmaps = f" (and {len(wplanes)} bitmap planes, read whole)" if wplanes else ""
    return f"32-byte sectors holding a selected row, by value plane: {', '.join(shares)}{bitmaps}"


def _kernel_module(name):
    import importlib

    return importlib.import_module(f"arrow_tpu_torch.compute.kernels.{KERNEL_FUNCTIONS[name][0]}")


@contextlib.contextmanager
def recorded_calls():
    """Record the arguments of every kernel launch made inside the block,
    by kernel (a 2-bit radix sort under radix_sort_2bit)."""
    calls = {name: [] for name in (*KERNEL_FUNCTIONS, "radix_sort_2bit")}
    saved = {}

    def recording(name, fn):
        def call(*args):
            key = "radix_sort_2bit" if name == "radix_sort" and args[3] == 2 else name
            calls[key].append(args)
            return fn(*args)
        return call

    for name, (_, launcher, _) in KERNEL_FUNCTIONS.items():
        mod = _kernel_module(name)
        saved[name] = getattr(mod, launcher)
        setattr(mod, launcher, recording(name, saved[name]))
    try:
        yield calls
    finally:
        for name, (_, launcher, _) in KERNEL_FUNCTIONS.items():
            setattr(_kernel_module(name), launcher, saved[name])


def _describe(name, args, got, want):
    """(matches, outputs to measure the error on, a description of the call)."""
    import torch

    from arrow_tpu_torch.compute.kernels import radix as R

    def dtypes(ts):
        return [str(t.dtype)[6:] for t in ts]

    if name == "compact_multi":
        vplanes, wplanes, mask, n = args
        got_t, want_t = got[0] + got[1], want[0] + want[1]
        ok = int(got[2]) == int(want[2]) and all(bool(torch.equal(g, w)) for g, w in zip(got_t, want_t))
        return ok, got_t, want_t, (f"{len(vplanes)} value planes {dtypes(vplanes)} + {len(wplanes)} "
                                   f"bitmap planes, n={n}, kept {int(got[2])}")
    if name == "split_multi":
        vplanes, mask, bit = args
        got_t, want_t = got[0] + got[1], want[0] + want[1]
        ok = int(got[2]) == int(want[2]) and all(bool(torch.equal(g, w)) for g, w in zip(got_t, want_t))
        sel = "a mask" if mask is not None else f"plane-0 bit {bit}"
        return ok, got_t, want_t, (f"{len(vplanes)} planes {dtypes(vplanes)}, n={vplanes[0].shape[0]}, "
                                   f"by {sel}, selected {int(got[2])}")
    if name == "compact":
        data, _mask = args
        ok = int(got[1]) == int(want[1]) and bool(torch.equal(got[0], want[0]))
        return ok, [got[0]], [want[0]], f"one {str(data.dtype)[6:]} plane, n={data.shape[0]}, kept {int(got[1])}"
    if name == "segmented_scan":
        planes, flags, op, unsigned = args
        ok = _b2_compare(got, want, op)[0]
        segs = int(flags.sum()) if flags is not None else 0
        kind = ("u" if unsigned else "") + str(planes[0].dtype)[6:]
        return ok, got, want, (f"{len(planes)} plane(s), {op} of {kind}, n={planes[0].shape[0]}, "
                               f"{segs} segment starts")
    ok = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    if name.startswith("radix_sort"):
        planes, bits, n, width = args
        n = planes[0].shape[0] if n is None else n
        by = f"its significant bits of {bits}" if isinstance(bits, int) else f"bits {list(bits)}"
        made = (R.KERNEL_2BIT if width == 2 else R.KERNEL).passes
        return ok, got, want, (f"{len(planes)} planes {dtypes(planes)}, n={n}, by {by}, {width}-bit digits, "
                               f"{made} passes")
    if name == "groupby_dense":
        keys, _vals, nlimb, length = args
        return ok, got, want, f"n={keys.shape[0]}, length={length}, {nlimb} limbs, {int(got[0].sum())} rows counted"
    if name == "groupby_region":
        keys, _vals, nlimb, nclass = args
        return ok, got, want, f"n={keys.shape[0]}, {nclass} classes, {nlimb} limbs"
    planes, run_len, unique = args
    return ok, got, want, (f"{len(planes)} int32 planes, n={planes[0].shape[0]}, run_len={run_len}"
                           f"{', unique payload' if unique else ''}")


def replay_calls(calls, smi, label):
    """Each recorded kernel call, on its own arguments, against its plain
    version (same tolerances as phase 3), timed beside it and beside its
    library call.  Returns a Measured per kernel that has calls, summed over
    them."""
    out = {}
    for name, args_list in calls.items():
        for i, args in enumerate(args_list):
            m, what = measure_call(name, args)
            print(f"{label}: {name} call {i + 1} ({what}): matches plain; {m.line()} ({smi})")
            out[name] = out[name] + m if name in out else m
    return out


def plain_step(fn, *args):
    with plain_path():
        return fn(*args)


def _run_flagship(n, smi):
    import numpy as np
    import torch

    from arrow_tpu_torch import flagship
    from arrow_tpu_torch.compute.kernels import _build

    host = flagship.make_host_columns(n, seed=0)
    batch = flagship.make_batch(n, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launch_counts()
    rows, groups = flagship.flagship_query(batch)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"flagship n={n}: {rows} rows kept, {groups.num_rows} groups; launches during the "
          f"query {launches}; peak device memory {peak_gib:.2f} GiB")
    require(launches["compact_multi"] > 0 and launches["segmented_scan"] > 0,
            f"a kernel of the query was not launched: {launches}")
    for name in groups.column_names:
        require(groups[name].data.is_cuda, f"output column {name} is not on CUDA")

    with plain_path():
        plain_rows, plain = flagship.flagship_query(batch)
    require(rows == plain_rows, f"rows {rows} vs plain {plain_rows}")
    require(np.array_equal(groups["key"].raw_values(), plain["key"].raw_values()), "keys vs plain")
    require(np.array_equal(groups["n"].raw_values(), plain["n"].raw_values()), "counts vs plain")
    tk, tp = groups["total"].raw_values(), plain["total"].raw_values()
    rel_plain = float(np.max(np.abs(tk.astype(np.float64) - tp) / np.abs(tp))) if len(tp) else 0.0
    require(np.allclose(tk, tp, rtol=1e-6, atol=0), f"sums vs plain: max rel err {rel_plain}")

    count, keys, counts, sums = flagship.numpy_reference(host["k"], host["v"])
    require(rows == count, f"rows {rows} vs numpy {count}")
    require(np.array_equal(groups["key"].raw_values(), keys), "group keys vs numpy")
    require(np.array_equal(groups["n"].raw_values(), counts), "group counts vs numpy")
    rel_np = float(np.max(np.abs(tk.astype(np.float64) - sums) / np.abs(sums))) if len(sums) else 0.0
    require(np.allclose(tk, sums, rtol=1e-5, atol=0), f"sums vs numpy: max rel err {rel_np}")
    require(bool(np.isfinite(tk).all()), "non-finite sums")
    print(f"flagship n={n}: matches the plain path (keys, counts exact; sums max rel err "
          f"{rel_plain:.3g} <= 1e-6) and numpy (rows, keys, counts exact; sums max rel err "
          f"{rel_np:.3g} <= 1e-5)")

    if n == FLAGSHIP_SIZES[-1]:
        with recorded_calls() as calls:  # the query once more, its kernel calls kept for replay
            flagship.flagship_query(batch)
            torch.cuda.synchronize()
        replay_calls(calls, smi, f"flagship n={n}")
        del calls
        torch.cuda.empty_cache()

    steps = {}
    mask = flagship.compare_step(batch)
    steps["compare"] = (cuda_ms(lambda: flagship.compare_step(batch)),) * 2
    kept_k = flagship.filter_step(batch, mask)
    kept_p = plain_step(flagship.filter_step, batch, mask)
    steps["filter"] = interleaved_ms(
        lambda: flagship.filter_step(batch, mask),
        lambda: plain_step(flagship.filter_step, batch, mask),
    )
    steps["group-by"] = interleaved_ms(
        lambda: flagship.groupby_step(kept_k), lambda: plain_step(flagship.groupby_step, kept_p)
    )
    total_k = sum(v[0] for v in steps.values())
    total_p = sum(v[1] for v in steps.values())
    detail = "; ".join(f"{s} kernel {k:.3f} ms, plain {p:.3f} ms" for s, (k, p) in steps.items())
    print(f"flagship n={n} step times (CUDA events, median of {REPS} after a warm-up; {smi}): "
          f"{detail}; total kernel {total_k:.3f} ms, plain {total_p:.3f} ms")


def phase_flagship(smi):
    """The query at every size."""
    import torch

    for n in FLAGSHIP_SIZES:
        _run_flagship(n, smi)
        torch.cuda.empty_cache()


def _sort_join_oracle(host):
    """numpy: the kept rows, their stable order by key, and the groups."""
    import numpy as np

    from arrow_tpu_torch import flagship

    keep = host["v"] > 0
    k, v = host["k"][keep], host["v"][keep]
    require(int(k.max()) < 1 << 16, "keys must fit 16 bits for numpy's stable radix argsort")
    order = np.argsort(k.astype(np.uint16), kind="stable")
    _, keys, counts, sums = flagship.numpy_reference(host["k"], host["v"])
    return k, v, order, keys, counts, sums


def _packed_rows(k, v):
    """(key << 32 | value bits) of each row, sorted: the rows as a multiset."""
    import torch

    return torch.sort((k.to(torch.int64) << 32) | (v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)).values


def check_sorted(label, sk, sv, oracle):
    import numpy as np

    k, v, order = oracle[:3]
    require(sk.length == sv.length == len(k), f"{label}: sorted length {sk.length} vs {len(k)}")
    require(np.array_equal(sk.raw_values(), k[order]), f"{label}: sorted keys vs numpy's stable sort")
    require(np.array_equal(sv.raw_values().view(np.uint32), v[order].view(np.uint32)),
            f"{label}: the payload does not follow numpy's stable argsort")


def check_sort_join(label, out, oracle, want_rows):
    """The query's result against the numpy oracle: the kept rows, the
    groups, every joined pair (probe key = build key, each kept row once, the
    group's total and count) and the sort."""
    import numpy as np
    import torch

    kept, groups, joined, (sk, sv) = out
    k, v, order, keys, counts, sums = oracle
    t = len(k)
    require(kept.num_rows == t, f"{label}: {kept.num_rows} kept rows vs numpy {t}")
    require(np.array_equal(groups["key"].raw_values(), keys), f"{label}: group keys vs numpy")
    require(np.array_equal(groups["n"].raw_values(), counts), f"{label}: group counts vs numpy")
    require(np.allclose(groups["total"].raw_values(), sums, rtol=1e-5, atol=0), f"{label}: sums vs numpy")
    require(joined.num_rows == t, f"{label}: {joined.num_rows} joined rows vs {t} kept rows")
    jk, jkey = joined["k"].data[:t], joined["key"].data[:t]
    require(bool(torch.equal(jk, jkey)), f"{label}: a pair's probe key differs from its build key")
    require(bool(torch.equal(_packed_rows(jk, joined["v"].data[:t]), want_rows)),
            f"{label}: the joined rows are not each kept row exactly once")
    device = jk.device
    lut_n = torch.zeros(1 << 16, dtype=torch.int64, device=device)
    lut_n[torch.from_numpy(keys.astype(np.int64)).to(device)] = torch.from_numpy(counts).to(device)
    lut_total = torch.zeros(1 << 16, dtype=torch.float32, device=device)
    ng = groups.num_rows
    lut_total[groups["key"].data[:ng].to(torch.int64)] = groups["total"].data[:ng]
    bkey = jkey.to(torch.int64)
    require(bool(torch.equal(joined["n"].data[:t], lut_n[bkey])), f"{label}: joined n vs the group count")
    require(bool(torch.equal(joined["total"].data[:t], lut_total[bkey])),
            f"{label}: joined total vs its group's total")
    check_sorted(label, sk, sv, oracle)


def general_join(kept, groups):
    """The groups' keys probed against the kept rows: each group meets its
    kept rows, so join_indices takes the merge-expand emit (B7)."""
    from arrow_tpu_torch import compute as C

    return C.join_indices(kept["k"], groups["key"])


def check_general_join(kept, groups, pairs):
    """Every kept row once, beside the group of its key."""
    import torch

    pi, bi, t = pairs
    rows = bi.data[:t].long()
    require(t == kept.num_rows and torch.equal(torch.sort(rows).values, torch.arange(t, device=rows.device))
            and torch.equal(kept["k"].data[rows], groups["key"].data[pi.data[:t].long()]),
            f"the groups probed against the kept rows: {t} pairs, not each of {kept.num_rows} kept rows once "
            "beside its group")


def phase_sort_join(smi):
    """The sort-join query at full size.  Returns (launches by kernel, replay
    numbers by kernel); the 2-bit radix's come from its rerun of the sort."""
    import numpy as np
    import torch

    from arrow_tpu_torch import compute as C
    from arrow_tpu_torch import flagship
    from arrow_tpu_torch.array.array import make_array
    from arrow_tpu_torch.compute import kernels as CK
    from arrow_tpu_torch.compute.kernels import _build

    n = SORT_JOIN_N
    host = flagship.make_host_columns(n, seed=0)
    oracle = _sort_join_oracle(host)
    device = torch.device("cuda")
    want_rows = _packed_rows(torch.from_numpy(oracle[0].view(np.int32)).to(device),
                             torch.from_numpy(oracle[1]).to(device))
    batch = flagship.make_batch(n, seed=0, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = flagship.sort_join_query(batch)
    general = general_join(out[0], out[1])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kept, groups, joined, (sk, sv) = out
    print(f"sort_join n={n}: {kept.num_rows} rows kept, {groups.num_rows} groups, "
          f"{joined.num_rows} joined rows; launches during the query {launches}; radix_sort passes "
          f"{_build.KERNELS['radix_sort'].passes}; peak device memory {peak_gib:.2f} GiB")
    for name in ("compact_multi", "segmented_scan", "radix_sort", "merge_pass"):
        require(launches[name] > 0, f"{name} was not launched by the sort-join query or the general join: {launches}")
    check_sort_join("sort_join", out, oracle, want_rows)
    check_general_join(out[0], out[1], general)
    del general
    with plain_path():
        plain = flagship.sort_join_query(batch)
    check_sort_join("sort_join plain path", plain, oracle, want_rows)
    require(bool(torch.equal(sk.data, plain[3][0].data) and torch.equal(sv.data, plain[3][1].data)),
            "sorted keys or values differ from the plain path")
    rel_plain = float(np.max(np.abs(groups["total"].raw_values().astype(np.float64)
                                    - plain[1]["total"].raw_values()) / np.abs(plain[1]["total"].raw_values())))
    require(rel_plain <= 1e-6, f"group sums vs the plain path: max rel err {rel_plain}")
    del plain
    print(f"sort_join n={n}: matches the plain path (kept rows, groups, joined rows as a set, "
          f"sorted keys and values exact; group sums max rel err {rel_plain:.3g} <= 1e-6) and numpy "
          f"(kept rows; group keys and counts exact, sums rtol 1e-5; {joined.num_rows} joined rows, "
          f"each kept row once, probe key = build key, the group's total and count; keys and "
          f"values in numpy's stable order)")

    kk, kv = kept["k"], kept["v"]
    with recorded_calls() as calls4:
        _build.reset_launch_counts()
        # u32 keys: their bits are their unsigned-order code
        k4, v4 = CK.radix_sort([kk.data, kv.data], 32, kk.length, digit_bits=2)
        torch.cuda.synchronize()
        launches4 = {name: k.launches for name, k in _build.KERNELS.items()}
    require(launches4["radix_sort_2bit"] > 0, f"digit_bits=2 launched no 2-bit sort: {launches4}")
    check_sorted("sort with digit_bits=2", make_array(k4, None, kk.length, kk.dtype),
                 make_array(v4, None, kv.length, kv.dtype), oracle)
    del k4, v4
    _build.reset_launch_counts()
    skx, svx = C.sort_by_key(kk, kv, method="xla")
    torch.cuda.synchronize()
    require(_build.KERNELS["radix_sort"].launches == 0, "method='xla' launched the radix sort")
    check_sorted("sort with method='xla'", skx, svx, oracle)
    del skx, svx
    print(f"sort_join n={n}: the sort rerun on the 2-bit radix (digit_bits=2, launches {launches4}) and "
          f"with method='xla' (torch.sort, no radix launch) matches numpy")
    launches["radix_sort_2bit"] = launches4["radix_sort_2bit"]
    del out, sk, sv
    with recorded_calls() as calls:  # the query once more, its kernel calls kept for replay
        again = flagship.sort_join_query(batch)
        general_join(again[0], again[1])
        torch.cuda.synchronize()
        del again
    calls["radix_sort_2bit"] = calls4["radix_sort_2bit"]
    measured = replay_calls(calls, smi, "sort_join")
    del calls, calls4
    torch.cuda.empty_cache()

    steps = {
        "filter": interleaved_ms(lambda: C.filter(batch, flagship.compare_step(batch)),
                                 lambda: plain_step(C.filter, batch, flagship.compare_step(batch))),
        "group-by": interleaved_ms(lambda: flagship.groupby_step(kept),
                                   lambda: plain_step(flagship.groupby_step, kept)),
        "join": interleaved_ms(lambda: C.hash_join(kept, groups, "k", "key"),
                               lambda: plain_step(C.hash_join, kept, groups, "k", "key")),
        "sort": interleaved_ms(lambda: C.sort_by_key(kept["k"], kept["v"]),
                               lambda: plain_step(C.sort_by_key, kept["k"], kept["v"])),
    }
    total_k = sum(v[0] for v in steps.values())
    total_p = sum(v[1] for v in steps.values())
    detail = "; ".join(f"{s} kernel {k:.3f} ms, plain {p:.3f} ms" for s, (k, p) in steps.items())
    print(f"sort_join n={n} step times (CUDA events, median of {REPS} after a warm-up; the filter "
          f"step includes its compare; {smi}): {detail}; total kernel {total_k:.3f} ms, plain "
          f"{total_p:.3f} ms")
    del batch, kept, groups, joined
    torch.cuda.empty_cache()

    for m in CROSSOVER_SIZES:
        b = flagship.make_batch(m, seed=1, device=device)
        radix_ms, torch_ms = interleaved_ms(
            lambda: C.sort_by_key(b["k"], b["v"], method="radix"),
            lambda: C.sort_by_key(b["k"], b["v"], method="xla"),
        )
        print(f"sort_join: sort_by_key crossover at n={m} (u32 keys in [0, 10000) + f32 values; "
              f"CUDA events, median of {REPS}; {smi}): radix {radix_ms:.3f} ms, torch.sort "
              f"{torch_ms:.3f} ms")
        del b
        torch.cuda.empty_cache()
    return launches, measured


def _same_groups(label, got, want):
    """Two group-by results hold the same groups, bit for bit."""
    import torch

    ng = got.num_rows
    require(ng == want.num_rows, f"{label}: {ng} groups vs {want.num_rows}")
    require(got.column_names == want.column_names, f"{label}: columns {got.column_names}")
    for name in got.column_names:
        require(bool(torch.equal(got[name].data[:ng], want[name].data[:ng])), f"{label}: column {name} differs")


def _route(launches):
    """The hash_aggregate route a query took, read from its launches."""
    for kernel, route in (("groupby_dense", "mxu"), ("groupby_region", "partition"), ("radix_sort", "radix")):
        if launches[kernel]:
            return route
    return "sort"


def phase_groupby(smi):
    """The group-by query at GROUPBY_N rows for each key distribution.
    Returns (launches by kernel, summed over the four queries; a Measured by
    kernel over their replayed calls)."""
    import numpy as np
    import torch

    from arrow_tpu_torch import compute as C
    from arrow_tpu_torch import flagship
    from arrow_tpu_torch.compute.kernels import _build
    from arrow_tpu_torch.table import RecordBatch

    n, device = GROUPBY_N, torch.device("cuda")
    launches_all = {name: 0 for name in _build.KERNELS}
    measured = {}
    for dist in flagship.GROUPBY_DISTS:
        label = f"groupby {dist}"
        host = flagship.make_groupby_columns(n, dist, seed=0)
        batch = RecordBatch.from_numpy(host, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gib = torch.cuda.memory_allocated() / 2**30
        _build.reset_launch_counts()
        out = flagship.groupby_query(batch)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in _build.KERNELS.items()}
        passes = _build.KERNELS["radix_sort"].passes
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        route = _route(launches)
        print(f"{label} n={n}: {out.num_rows} groups on the {route} route; launches during the query "
              f"{launches}; radix_sort passes {passes}; peak device memory {peak_gib:.2f} GiB "
              f"({base_gib:.2f} GiB of it the batch)")
        if dist in GROUPBY_ONE_PASS:
            require(passes == 1, f"{label}: the class sort took {passes} passes, not 1")
        for kernel in GROUPBY_ROUTES.get(dist, ()):
            require(launches[kernel] >= 1, f"{label}: {kernel} was not launched: {launches}")
        for name, count in launches.items():
            launches_all[name] += count
        for name in out.column_names:
            require(out[name].data.is_cuda, f"{label}: output column {name} is not on CUDA")

        with plain_path():
            plain = flagship.groupby_query(batch)
        _same_groups(f"{label} vs the plain path", out, plain)
        if dist == "100m":
            by_sort = C.hash_aggregate(batch["k"], [("s", batch["v"], "sum"), ("c", batch["v"], "count")],
                                       method="sort")
            _same_groups(f"{label} vs method=sort", out, by_sort)
            del by_sort
            oracle = "the sort route on the card"
        else:
            keys, counts, sums = flagship.groupby_reference(host["k"], host["v"])
            require(np.array_equal(out["key"].raw_values(), keys), f"{label}: group keys vs numpy")
            require(np.array_equal(out["c"].raw_values(), counts), f"{label}: counts vs numpy")
            require(np.array_equal(out["s"].raw_values(), sums), f"{label}: sums vs numpy")
            oracle = "numpy's bincount"
        print(f"{label} n={n}: matches the plain path and {oracle} (keys, sums, counts exact)")
        del out, plain, host

        with recorded_calls() as calls:  # the query once more, its kernel calls kept for replay
            flagship.groupby_query(batch)
            torch.cuda.synchronize()
        for name, m in replay_calls(calls, smi, label).items():
            measured[name] = measured[name] + m if name in measured else m
        del calls
        torch.cuda.empty_cache()
        aggs = [("s", batch["v"], "sum"), ("c", batch["v"], "count")]
        auto_ms, sort_ms = interleaved_ms(lambda: flagship.groupby_query(batch),
                                          lambda: C.hash_aggregate(batch["k"], aggs, method="sort"))
        plain_ms = _event_ms(lambda: plain_step(flagship.groupby_query, batch))  # warm from the check
        print(f"{label} n={n} query time (CUDA events; {smi}): the {route} route (auto) {auto_ms:.3f} ms, "
              f"{n / auto_ms / 1e6:.3f} G rows/s; the sort route {sort_ms:.3f} ms (both the median of "
              f"{REPS} after a warm-up, in turns); the plain path {plain_ms:.3f} ms (one run)")
        del batch, aggs
        torch.cuda.empty_cache()
    return launches_all, measured


# ---------------------------------------------------------------------------
# phase 7: the distributed tier (arrow_tpu_torch.parallel)
# ---------------------------------------------------------------------------


def _kernel_launches():
    from arrow_tpu_torch.compute.kernels import _build

    return {name: k.launches for name, k in _build.KERNELS.items()}


def _counted(fn, total):
    """fn() with the launch counts set to 0 just before it and read just
    after; adds them to `total` and returns (result, launches)."""
    import torch

    from arrow_tpu_torch.compute.kernels import _build

    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = {name: n for name, n in _kernel_launches().items() if n}
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    return out, launches


def _same_shards(label, got, want):
    """Two runs' shard prefixes (parallel.dryrun.shard_prefix) bit for bit."""
    import numpy as np

    require(sorted(got) == sorted(want), f"{label}: columns {sorted(got)} vs {sorted(want)}")
    for name in want:
        require(got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]),
                f"{label}: column {name} differs")


def _pairs(pidx, bidx, k):
    import numpy as np

    p, b = pidx.data[:k].cpu().numpy(), bidx.data[:k].cpu().numpy()
    order = np.lexsort((b, p))
    return np.stack([p[order], b[order]])


# what gloo says when it refuses a tensor's device; any other error is a failure
GLOO_REFUSAL = ("unsupported device type", "no backend type associated with device type")


def gloo_cuda_probe(outdir):
    """A rank's body (spawned): gloo's ragged all_to_all_single and
    all_gather on CUDA tensors, checked.  A refusal of the CUDA device (and
    only that) is written to ``outdir/rank<r>.refused`` and the rank exits
    cleanly; every other error fails the rank."""
    import pathlib as _pathlib

    import torch
    import torch.distributed as dist

    me, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda:0")
    # rank r sends d + 1 rows, each 1000 * r + d, to rank d
    send = torch.cat([torch.full((d + 1, 2), 1000 * me + d, dtype=torch.int32, device=dev) for d in range(world)])
    recv = torch.empty(((me + 1) * world, 2), dtype=torch.int32, device=dev)
    want = torch.cat([torch.full((me + 1, 2), 1000 * s + me, dtype=torch.int32, device=dev) for s in range(world)])
    parts = [torch.empty(3, dtype=torch.int64, device=dev) for _ in range(world)]
    try:
        dist.all_to_all_single(recv, send, [me + 1] * world, [d + 1 for d in range(world)])
        dist.all_gather(parts, torch.full((3,), me, dtype=torch.int64, device=dev))
    except (RuntimeError, ValueError) as e:
        if not any(m in str(e).lower() for m in GLOO_REFUSAL):
            raise
        (_pathlib.Path(outdir) / f"rank{me}.refused").write_text(str(e).strip().splitlines()[-1])
        return
    if not (torch.equal(recv, want) and all(bool((t == s).all()) for s, t in enumerate(parts))):
        raise RuntimeError("gloo moved CUDA tensors wrongly")


def _dist_workload_a(rt, smi, launches):
    """The dryrun's step at DIST_N rows a shard, operator by operator."""
    import numpy as np
    import torch

    from arrow_tpu_torch import compute as C
    from arrow_tpu_torch import parallel as PP
    from arrow_tpu_torch.parallel import dryrun as D

    n = DIST_N * rt.num_shards
    t0 = time.perf_counter()
    keys, vals, mask = D.dryrun_columns(n)
    batch = D.dryrun_batch(keys, vals, mask, rt.device)
    torch.cuda.synchronize()
    print(f"distributed (a) n={n}: the dryrun's batch (u32 keys in [0, 64), i32 values in [-50, 50), "
          f"mask v % 2 == 0) made and on the card in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30

    def step(with_counts):
        run = (lambda fn: _counted(fn, launches)) if with_counts else (lambda fn: (fn(), None))
        out, per = {}, {}
        sb, per["shard_batch"] = run(lambda: PP.shard_batch(batch, rt))
        out["filtered"], per["filter"] = run(lambda: PP.distributed_filter(sb, "m"))
        f = out["filtered"]
        out["agg"], per["aggregate"] = run(
            lambda: PP.distributed_aggregate(f, "k", [("s", "v", "sum"), ("c", None, "count")]))
        out["total"], per["sum"] = run(lambda: PP.distributed_sum(f, "v"))
        build = PP.ShardedBatch({"k": out["agg"].columns["key"]}, out["agg"].counts, rt)
        join, per["join_indices"] = run(
            lambda: PP.distributed_join_indices(build, f, "k", "k", out_capacity=4 * sb.capacity))
        out["join_counts"], out["probe_idx"], out["build_idx"] = join[:3]
        plain_sb = PP.ShardedBatch({"k": f.columns["k"], "v": f.columns["v"]}, f.counts, rt)
        out["sorted"], per["sort"] = run(lambda: PP.distributed_sort(plain_sb, "k"))
        return sb, build, plain_sb, out, per

    sb, build, plain_sb, out, per = step(True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    counts = D.check_dryrun(out, keys, vals, mask)
    print(f"distributed (a) n={n}: {counts['filtered']} rows filtered, {counts['groups']} groups, "
          f"{counts['matches']} join matches; matches numpy (the global sum, the sorted keys); "
          f"launches by operator {per}; peak device memory {peak_gib:.2f} GiB ({base_gib:.2f} GiB of it the batch)")
    for op, kernels in (("filter", ("compact_multi",)), ("aggregate", ("segmented_scan", "compact_multi")),
                        ("sort", ("radix_sort",))):
        for kernel in kernels:
            require(per[op].get(kernel, 0) >= 1, f"distributed (a): {op} launched no {kernel}: {per[op]}")
    with plain_path():
        plain = step(False)[3]
    for name in ("filtered", "agg", "sorted"):
        _same_shards(f"distributed (a) {name} vs the plain path", D.shard_prefix(out[name]),
                     D.shard_prefix(plain[name]))
    require(int(out["total"]) == int(plain["total"]), "distributed (a): the sum differs from the plain path")
    k = int(out["join_counts"][rt.rank])
    require(np.array_equal(_pairs(out["probe_idx"], out["build_idx"], k),
                           _pairs(plain["probe_idx"], plain["build_idx"], k)),
            "distributed (a): the join's pairs differ from the plain path")
    print(f"distributed (a) n={n}: every operator's shard matches the plain path bit for bit "
          f"(join pairs as a multiset)")
    del plain

    # the single-chip operators on the same rows
    kept = C.filter(batch.select(["k", "v"]), batch["m"])
    groups = C.hash_aggregate(kept["k"], [("s", kept["v"], "sum"), ("c", None, "count")], method="sort")
    f = out["filtered"]
    pairs = {
        "filter": (lambda: PP.distributed_filter(sb, "m"),
                   lambda: C.filter(batch.select(["k", "v"]), batch["m"]), "compute.filter"),
        "aggregate": (lambda: PP.distributed_aggregate(f, "k", [("s", "v", "sum"), ("c", None, "count")]),
                      lambda: C.hash_aggregate(kept["k"], [("s", kept["v"], "sum"), ("c", None, "count")],
                                               method="sort"), "hash_aggregate(method=sort)"),
        "sum": (lambda: PP.distributed_sum(f, "v"), None, None),
        "join_indices": (lambda: PP.distributed_join_indices(build, f, "k", "k", out_capacity=4 * sb.capacity),
                         lambda: C.join_indices(groups["key"], kept["k"]), "join_indices"),
        "sort": (lambda: PP.distributed_sort(plain_sb, "k"), lambda: C.sort_by_key(kept["k"], kept["v"]),
                 "sort_by_key"),
    }
    for op, (dist_fn, single_fn, single_label) in pairs.items():
        if single_fn is None:
            ms = cuda_ms(dist_fn)
            print(f"distributed (a) n={n} {op}: {ms:.3f} ms; no single-chip operator "
                  f"(CUDA events, median of {REPS} after a warm-up; {smi})")
            continue
        ms, single_ms = interleaved_ms(dist_fn, single_fn)
        print(f"distributed (a) n={n} {op}: {ms:.3f} ms; single-chip {single_label} on the same rows "
              f"{single_ms:.3f} ms; the distributed layer's own {ms - single_ms:.3f} ms (CUDA events, "
              f"median of {REPS} after a warm-up, in turns; {smi})")
    # where the sort's own cost goes: the distributed sort and the single-chip one, profiled
    profile_query("distributed (a) sort", n, lambda b: PP.distributed_sort(b, "k"), plain_sb, smi)
    profile_query("distributed (a) single-chip sort_by_key", n, lambda b: C.sort_by_key(b["k"], b["v"]), kept, smi)
    del batch, sb, build, plain_sb, out, kept, groups, f, pairs
    torch.cuda.empty_cache()


def _dist_workload_b(rt, smi, launches):
    """BASELINE.json configs[4]'s distributed join on one shard: DIST_N
    unique u64 build keys, DIST_N probe keys drawn as the group-by's skew."""
    import numpy as np
    import torch

    import arrow_tpu_torch as att
    from arrow_tpu_torch import compute as C
    from arrow_tpu_torch import parallel as PP

    n = DIST_N
    gen = torch.Generator(device=rt.device)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    bkey = torch.randperm(n, generator=gen, device=rt.device)  # unique keys: a permutation of [0, n)
    pkey = torch.floor(torch.rand(n, generator=gen, device=rt.device, dtype=torch.float64) ** 4 * n).long()
    rv = torch.randint(-(2**31), 2**31, (n,), generator=gen, device=rt.device, dtype=torch.int32)
    lv = torch.arange(n, dtype=torch.int32, device=rt.device)

    def table(k, name, v):
        return att.RecordBatch({"k": att.make_array(k, None, n, att.ArrowType.UINT64, rt.device),
                                name: att.make_array(v, None, n, att.ArrowType.INT32, rt.device)})

    right, left = table(bkey, "rv", rv), table(pkey, "lv", lv)
    torch.cuda.synchronize()
    print(f"distributed (b) n={n}: build {n} unique u64 keys (a permutation of [0, {n})) + i32 payload, probe "
          f"{n} u64 keys floor(u^4 * {n}) + i32 row ids, made on the card in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    rsb, lsb = PP.shard_batch(right, rt), PP.shard_batch(left, rt)
    joined, per = _counted(lambda: PP.distributed_join(lsb, rsb, "k", "k", fused=True), launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    m = joined.num_rows()
    print(f"distributed (b) n={n}: distributed_join(fused=True) gives {m} rows, columns {joined.column_names}; "
          f"launches {per}; peak device memory {peak_gib:.2f} GiB")
    require(m == n, f"distributed (b): {m} joined rows, not {n}")

    # numpy oracle: probe row lv matches the build row whose key is its key
    hk, hrv = bkey.cpu().numpy(), rv.cpu().numpy()
    rv_of_key = np.empty(n, np.int32)
    rv_of_key[hk] = hrv
    hpk = pkey.cpu().numpy()
    got = {c: joined.columns[c].data[:m] for c in ("k", "lv", "rv")}
    order = torch.argsort(got["lv"])
    g_lv, g_k, g_rv = (got[c][order].cpu().numpy() for c in ("lv", "k", "rv"))
    require(np.array_equal(g_lv, np.arange(n, dtype=np.int32)), "distributed (b): a probe row is lost or doubled")
    require(np.array_equal(g_k, hpk), "distributed (b): a joined key differs from its probe row's")
    require(np.array_equal(g_rv, rv_of_key[hpk]), "distributed (b): a joined rv is not its key's build row's")
    print(f"distributed (b) n={n}: the (key, lv, rv) multiset matches the numpy oracle (each probe row once, "
          f"with its key's build payload)")
    del joined, got, order, g_lv, g_k, g_rv, hk, hrv, hpk, rv_of_key

    fused_ms, unfused_ms = interleaved_ms(lambda: PP.distributed_join(lsb, rsb, "k", "k", fused=True),
                                          lambda: PP.distributed_join(lsb, rsb, "k", "k", fused=False))
    _, single_ms = interleaved_ms(lambda: PP.distributed_join(lsb, rsb, "k", "k", fused=True),
                                  lambda: C.hash_join(left, right, "k", "k"))
    print(f"distributed (b) n={n} join: fused {fused_ms:.3f} ms, unfused {unfused_ms:.3f} ms; single-chip "
          f"hash_join on the same rows {single_ms:.3f} ms; the distributed layer's own "
          f"{fused_ms - single_ms:.3f} ms (CUDA events, median of {REPS} after a warm-up, in turns; {smi})")
    profile_query("distributed (b) join fused", n, lambda b: PP.distributed_join(b[0], b[1], "k", "k", fused=True),
                  (lsb, rsb), smi)
    profile_query("distributed (b) single-chip hash_join", n, lambda b: C.hash_join(b[0], b[1], "k", "k"),
                  (left, right), smi)
    del left, right, lsb, rsb, bkey, pkey, rv, lv
    torch.cuda.empty_cache()


def _dist_p4(smi):
    """The dryrun's step on DIST_P4_RANKS gloo ranks sharing the card,
    held shard by shard against the same ranks on the CPU; or the reason
    why not (gloo refuses CUDA tensors), and then False."""
    import pathlib as _pathlib
    import shutil
    import tempfile

    from arrow_tpu_torch.parallel import dryrun as D

    p = DIST_P4_RANKS
    dirs = {d: tempfile.mkdtemp(prefix=f"chip_smoke_{d.replace(':', '')}_") for d in ("probe", "cuda:0", "cpu")}
    worlds = []
    try:
        # a rank that fails or hangs raises here and fails the phase
        D.spawn("chip_smoke:gloo_cuda_probe", 2, [dirs["probe"]], device="cuda:0", timeout=300)
        refused = sorted(_pathlib.Path(dirs["probe"]).glob("rank*.refused"))
        if refused:
            print(f"distributed P={p}: not run: gloo refused CUDA tensors on this machine: "
                  f"{refused[0].read_text()}")
            return False
        print("distributed: gloo takes CUDA tensors (ragged all_to_all_single and all_gather checked on 2 ranks)")
        t0 = time.perf_counter()
        worlds = [D.launch("arrow_tpu_torch.parallel.dryrun:dryrun_rank", p, [DIST_P4_N, d, dirs[d]], device=d,
                           timeout=900) for d in ("cuda:0", "cpu")]
        for w in worlds:
            w.join()
        _dist_p4_compare(p, {d: _pathlib.Path(dirs[d]) for d in ("cuda:0", "cpu")}, t0)
        return True
    finally:
        for w in worlds:
            w.kill()
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)


def _dist_p4_compare(p, dirs, t0):
    """Every rank's shards from the card held against the CPU ranks'."""
    import numpy as np

    for r in range(p):
        with np.load(dirs["cuda:0"] / f"rank{r}.npz") as zg, np.load(dirs["cpu"] / f"rank{r}.npz") as zc:
            got, want = {k: zg[k] for k in zg.files}, {k: zc[k] for k in zc.files}
        for key in ("join/probe", "join/build"):
            require(got[key].shape == want[key].shape, f"distributed P={p} rank {r}: {key} count differs")
        gp = np.lexsort((got["join/build"], got["join/probe"]))
        wp = np.lexsort((want["join/build"], want["join/probe"]))
        for key in ("join/probe", "join/build"):
            got[key], want[key] = got[key][gp], want[key][wp]
        _same_shards(f"distributed P={p} rank {r} (card vs CPU)", got, want)
    counts = json.loads((dirs["cuda:0"] / "result.json").read_text())
    print(f"distributed P={p}: {p} gloo ranks on one card ran the dryrun's step at {DIST_P4_N} rows a rank "
          f"({counts['filtered']} rows filtered, {counts['groups']} groups, {counts['matches']} join matches); "
          f"every rank's filtered, aggregated and sorted shard, sum and join pairs equal {p} CPU gloo ranks' "
          f"(exact; pairs as a multiset); {time.perf_counter() - t0:.1f} s with process start-up "
          f"(correctness only: {p} processes share the card, so no time is taken)")


def phase_distributed(smi):
    """The distributed tier at P = 1 on NCCL, then P = 4 gloo ranks on the
    card.  Returns the launches by kernel of the P = 1 operators (workloads
    (a) and (b))."""
    import tempfile

    import torch
    import torch.distributed as dist

    from arrow_tpu_torch import parallel as PP

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    launches = {}
    try:
        rt = PP.MeshRuntime.create(devices="cuda:0")
        require(rt.distributed and rt.num_shards == 1, f"distributed: {rt} is not a one-rank NCCL group")
        print(f"distributed: {rt} on NCCL ({dist.get_backend()}), world size {dist.get_world_size()}")
        cnt = torch.ones(1, dtype=torch.int32, device=rt.device)
        read_ms = statistics.median(_host_ms(lambda: rt.all_gather(cnt).cpu().numpy()) for _ in range(20))
        print(f"distributed: an exchange's count read at P=1 (all_gather of the (P,) counts, then one host read; "
              f"the device idle): {read_ms:.4f} ms (host clock, median of 20; {smi})")
        _dist_workload_a(rt, smi, launches)
        _dist_workload_b(rt, smi, launches)
        _dist_sort_1b(rt, smi, launches)
    finally:
        dist.destroy_process_group()
    print(f"distributed: launches on the P=1 main paths (a), (b) and dist_sort_1b {launches}")
    if _dist_p4(smi):
        _dist_tools_p4(smi)
    print(f"distributed: phase {time.perf_counter() - t0:.1f} s")
    return launches


def _gib(nbytes):
    return "not measured" if nbytes is None else f"{nbytes / 2**30:.2f} GiB"


def _dist_sort_1b(rt, smi, launches):
    """tools.dist_sort_1b at P = 1 in the phase's NCCL group: BASELINE.json
    configs[3], DIST_1B_ROWS rows of u32 key and payload, with its checks."""
    import torch

    from arrow_tpu_torch.tools import dist_sort_1b as DS

    t0 = time.perf_counter()
    (report, out), per = _counted(lambda: DS.run(rt, DIST_1B_ROWS, True), launches)
    checks = {k: report[k] for k in DS.CHECKS}
    require(report["ok"], f"dist_sort_1b P=1: a check failed: {checks}")
    require(per.get("radix_sort", 0) >= 1, f"dist_sort_1b P=1: the sort launched no radix_sort: {per}")
    print(f"distributed dist_sort_1b P=1 (NCCL) {report['rows_total']} rows of u32 key + payload, out_capacity "
          f"{report['out_capacity']}: {checks}; distributed_sort {report['sort_seconds'] * 1e3:.3f} ms (median of "
          f"calls {[round(t * 1e3, 3) for t in report['sort_seconds_each']]} ms, the first cold; host clock to a "
          f"synchronise); peak device memory {_gib(report['peak_device_bytes'][0])}; launches in the last call "
          f"{report['launches']}, in the run with its checks {per}; {time.perf_counter() - t0:.1f} s in all ({smi})")
    del out
    torch.cuda.empty_cache()


def _dist_tools_p4(smi):
    """The tools on DIST_P4_RANKS gloo ranks sharing the card, DIST_TOOLS_N
    rows a rank: dist_sort_1b with its checks, one scaling_bench point, and
    overlap_ab with the fused and composed joins' rows equal."""
    from arrow_tpu_torch.tools import dist_sort_1b as DS
    from arrow_tpu_torch.tools import overlap_ab as OA
    from arrow_tpu_torch.tools import scaling_bench as SB

    p, n = DIST_P4_RANKS, DIST_TOOLS_N
    t0 = time.perf_counter()
    r = DS.sort_1b(n, True, procs=p, device="cuda:0", timeout=600)
    checks = {k: r[k] for k in DS.CHECKS}
    require(r["ok"] and r["shared_card"], f"dist_sort_1b P={p}: {checks}, shared card {r['shared_card']}")
    print(f"distributed tools P={p} (gloo ranks sharing the card): dist_sort_1b {r['rows_total']} rows of key + "
          f"payload: {checks}; sort {r['sort_seconds'] * 1e3:.1f} ms (through the host; the ranks share the "
          f"card); peaks {[_gib(b) for b in r['peak_device_bytes']]}; rank 0's launches {r['launches']}")
    s = SB.sweep([p], [n], 1, "cuda:0", 600)
    point = s["sweep"].get(str(n), {}).get(str(p))
    require(point is not None, f"scaling_bench P={p} at {n} rows a shard failed")
    require(all(v["shared_card"] and "efficiency_vs_linear" not in v for v in point.values()),
            f"scaling_bench P={p}: a shared-card point has an efficiency: {point}")
    print(f"distributed tools P={p}: scaling_bench point at {n} rows a shard, seconds a call "
          f"{ {op: round(v['seconds_per_iter'], 4) for op, v in point.items()} } (shared card: no efficiency)")
    o = OA.overlap_ab(p * n, procs=p, device="cuda:0", timeout=600)
    require(o["fused_equals_composed"] and o["joined_rows"] > 0,
            f"overlap_ab P={p}: fused and composed rows differ, or none joined ({o['joined_rows']})")
    print(f"distributed tools P={p}: overlap_ab {p * n} rows a side: fused and composed give the same "
          f"{o['joined_rows']} rows; fused {o['fused_s'] * 1e3:.1f} ms, composed {o['composed_s'] * 1e3:.1f} ms; "
          f"the u64 route hash {o['route_hash_profiled_ms']:.3f} of rank 0's {o['fused_profiled_ms']:.3f} profiled "
          f"device ms ({o['route_hash_share']:.3f}); top ops {[(name[:60], calls, ms) for name, calls, ms in o['top_kernels'][:5]]}; "
          f"{time.perf_counter() - t0:.1f} s for the three tools ({smi})")


def _host_ms(fn) -> float:
    start = time.perf_counter()
    fn()
    return (time.perf_counter() - start) * 1e3


# ---------------------------------------------------------------------------
# phase 8: the elementwise tier (no hand-written kernel; plain torch ops)
# ---------------------------------------------------------------------------

EW_N = 1 << 20  # rows of each op's check against the CPU
EW_CHAIN_SIZES = (10_485_760, 1 << 27)  # the sizes of bench.py's elementwise mirrors
EW_NUMERIC = ("float32", "float64", "uint8", "uint16", "uint32", "uint64",
              "int8", "int16", "int32", "int64", "date32")
# the CPU differential tests' tolerances: exp, exp2, log, log2, cbrt, float
# power and the trigonometry within these; float sums (positive terms) within
# EW_SUM_RTOL; everything else exact, a NaN matching any NaN
EW_RTOL = {"float32": 2e-6, "float64": 1e-14}
EW_SUM_RTOL = {"float32": 1e-5, "float64": 1e-12}


def _ew_host(name, rng, family="general", n=EW_N):
    """n host values of Arrow type `name`, by input family, with the type's
    edge values planted (as the CPU tests' edge_values)."""
    import numpy as np

    if name == "bool":
        return rng.random(n) < 0.5
    if name.startswith("float"):
        v = {"general": lambda: rng.standard_normal(n) * 10, "exp": lambda: rng.uniform(-20, 20, n),
             "log": lambda: np.abs(rng.standard_normal(n) * 10) + 1e-3, "trig": lambda: rng.uniform(-10, 10, n),
             "acos": lambda: rng.uniform(-1.2, 1.2, n), "positive": lambda: rng.random(n)}[family]().astype(name)
        if family != "positive":
            v[:9] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 1e30, -1e30]
        return v
    npdt = np.dtype("int32" if name == "date32" else name)
    info = np.iinfo(npdt)
    v = rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)
    v[:7] = [info.min, info.max, 0, 1, info.max - 1, info.max // 2 + 1, info.min + 1]
    return v


def _ew_pair(name, host, valid, device="cuda"):
    """(cpu array, array on `device`) of the same host values and validity."""
    import numpy as np
    import torch

    import arrow_tpu_torch as att
    from arrow_tpu_torch.utils import bits as B

    if name == "bool":
        cpu = att.BooleanArray.from_slice(host, device="cpu")
    else:
        cpu = att.PrimitiveArray.from_slice(host, dtype=att.ArrowType(name), device="cpu")
    if valid is not None:
        words = torch.from_numpy(B.pack_bits_np(valid, cpu.data.shape[0] if name == "bool" else
                                                B.num_words(cpu.data.shape[0])).view(np.int32))
        cpu = att.make_array(cpu.data, words, cpu.length, cpu.dtype, "cpu")
    gpu = att.make_array(cpu.data.to(device), None if cpu.validity is None else cpu.validity.to(device),
                         cpu.length, cpu.dtype, device)
    return cpu, gpu


def _ew_inputs(n=EW_N, device="cuda"):
    """The inputs of every check, n rows each (the scatter's n // 2), as
    {key: (cpu array, array on `device`)}: per dtype a general column and a
    second operand (zero divisors, INT_MIN over -1), the float families,
    shift amounts, gather and scatter indices (distinct destinations),
    exponents and a mask; all with nulls."""
    import numpy as np

    rng = np.random.default_rng(0)
    cols = {}
    for name in (*EW_NUMERIC, "bool"):
        a, b = _ew_host(name, rng, n=n), _ew_host(name, rng, n=n)
        if name != "bool":
            b = np.roll(b, 5)
            if not name.startswith("float"):
                b[::7] = 0
                if np.iinfo(b.dtype).min < 0:
                    a[3::11], b[3::11] = np.iinfo(b.dtype).min, -1
        cols[name] = _ew_pair(name, a, rng.random(n) < 0.8, device=device)
        cols[name + "/b"] = _ew_pair(name, b, rng.random(n) < 0.7, device=device)
    for name in ("float32", "float64"):
        for family in ("exp", "log", "trig", "acos", "positive"):
            cols[f"{name}/{family}"] = _ew_pair(name, _ew_host(name, rng, family, n), rng.random(n) < 0.8, device=device)
        p = rng.uniform(-6, 6, n).astype(name)
        p[:7] = [0, 0.5, -1, np.inf, -np.inf, np.nan, 2]
        cols[f"{name}/exponent"] = _ew_pair(name, p, None, device=device)
    for name in ("int32", "int64"):
        cols[f"{name}/base"] = _ew_pair(name, rng.integers(-5, 6, n).astype(name), rng.random(n) < 0.8, device=device)
        cols[f"{name}/exponent"] = _ew_pair(name, rng.integers(-12, 70, n).astype(name), None, device=device)
    amounts = rng.integers(0, 70, n).astype(np.uint32)
    amounts[:4] = [31, 32, 63, 2**32 - 1]
    cols["amount"] = _ew_pair("uint32", amounts, rng.random(n) < 0.9, device=device)
    cols["take"] = _ew_pair("uint32", rng.integers(0, n, n).astype(np.uint32), rng.random(n) < 0.9, device=device)
    cols["put_src"] = _ew_pair("uint32", rng.integers(0, n, n // 2).astype(np.uint32), None, device=device)
    cols["put_dst"] = _ew_pair("uint32", rng.permutation(n)[: n // 2].astype(np.uint32), None, device=device)
    return cols


def _ew_cases():
    """(label, fn(inputs on one device, pipeline=None) -> array, rtol or
    None, op) for every registered op over every dtype its API accepts; op
    names the op that fn records into a pipeline when one is given (None
    where fn runs eagerly only: reductions, take, put, broadcast)."""
    import arrow_tpu_torch as att
    from arrow_tpu_torch import kernels as K

    A = att.ArrowType
    floats = ("float32", "float64")
    ints = ("uint8", "uint16", "uint32", "uint64", "int8", "int16", "int32", "int64")
    cases = []

    def add(label, fn, rtol=None, op=None):
        cases.append((label, fn, rtol, op))

    def call(name, *keys, rtol=None, op=None, label=None, **kw):
        """A case calling K.<name>(inputs[key]..., **kw), recorded as `op`."""
        add(label or f"{name} {keys[0]}", lambda c, p=None: getattr(K, name)(
            *(c[k] for k in keys), **kw, pipeline=p), rtol, op or name)

    for name in EW_NUMERIC:
        for op in ("add", "sub", "mul", "div", "rem"):
            call(op, name, name + "/b")
            for s in (7, 0):
                add(f"{op}_scalar {s} {name}", lambda c, p=None, op=op, name=name, s=s: getattr(K, f"{op}_scalar")(
                    c[name], s, pipeline=p), None, f"{op}_scalar")
        for op in ("eq", "gt", "gteq", "lt", "lteq"):
            call(op, name, name + "/b")
            add(f"{op}_scalar {name}", lambda c, p=None, op=op, name=name: getattr(K, f"{op}_scalar")(
                c[name], 7, pipeline=p), None, f"{op}_scalar")
        for op in ("min", "max"):
            call(op, name, name + "/b")
        for op in ("min_reduce", "max_reduce") + (() if name == "date32" else ("sum_",)):
            src = f"{name}/positive" if op == "sum_" and name in floats else name
            add(f"{op} {name}", lambda c, p=None, op=op, src=src: getattr(K, op)(c[src]),
                EW_SUM_RTOL.get(name) if op == "sum_" else None)
        for dst in EW_NUMERIC:
            if dst != name:
                call("cast", name, to=A(dst), label=f"cast {name}->{dst}")
        call("cast", "bool", to=A(name), label=f"cast bool->{name}")
        for dst in EW_NUMERIC:
            if dst != name and att.dtypes.bit_width(A(dst)) == att.dtypes.bit_width(A(name)):
                call("bitcast", name, to=A(dst), label=f"bitcast {name}->{dst}")
    for name in (*EW_NUMERIC, "bool"):
        call("merge", name, name + "/b", "bool/b")
        add(f"take {name}", lambda c, p=None, name=name: K.take(c[name], c["take"]))

        def put(c, p=None, name=name):
            dst = c[name + "/b"].clone()
            K.put(c[name], c["put_src"], dst, c["put_dst"])
            return dst
        add(f"put {name}", put)

        def broadcast(c, p=None, name=name):
            value = {"bool": True, "float32": 2.5, "float64": -0.5}.get(name, 7)
            with att.ComputePipeline(device=c["bool"].device) as pipe:
                out = K.broadcast_op(value, EW_N - 3, pipe, dtype=A(name))
            return out.bound()
        add(f"broadcast {name}", broadcast)
    for name in (*ints, "bool"):
        for op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
            call(op, name, name + "/b")
        call("bitwise_not", name)
    for name in ints:
        for op in ("bitwise_shl", "bitwise_shr"):
            call(op, name, "amount")
    for name in floats + ("int8", "int16", "int32", "int64"):
        call("neg", name)
        call("abs", name, op="math_abs")
    for name in floats:
        call("sqrt", name, op="math_sqrt")
        for op, family in (("cbrt", "general"), ("exp", "exp"), ("exp2", "exp"), ("log", "log"), ("log2", "log")):
            key = name if family == "general" else f"{name}/{family}"
            call(op, key, rtol=EW_RTOL[name], op=f"math_{op}", label=f"{op} {name}")
        call("power", f"{name}/log", f"{name}/exponent", rtol=EW_RTOL[name], label=f"power {name}")
    for name in ("int32", "int64"):
        call("power", f"{name}/base", f"{name}/exponent", label=f"power {name}")
    for name in floats + ("uint8", "uint16", "int8", "int16"):
        for op in ("sin", "cos", "acos", "sinh"):
            key = name if name not in floats else f"{name}/{'acos' if op == 'acos' else 'trig'}"
            call(op, key, rtol=EW_RTOL["float64" if name == "float64" else "float32"],  # integers give float32
                 op=f"trig_{op}", label=f"{op} {name}")
    return cases


# the module of the port's ops that each pipelined op comes from
EW_MODULES = {"arithmetic": ("add", "sub", "mul", "div", "rem", "neg"),
              "compare": ("eq", "gt", "gteq", "lt", "lteq", "min", "max"),
              "logical": ("bitwise_",), "cast": ("cast", "bitcast"), "swizzle": ("merge",),
              "math": ("math_", "power"), "trigonometry": ("trig_",)}


def ew_module(op):
    """The ops module a pipelined case's op belongs to."""
    base = op.removesuffix("_scalar")
    for module, prefixes in EW_MODULES.items():
        if any(base == q or (q.endswith("_") and base.startswith(q)) for q in prefixes):
            return module
    raise KeyError(op)


def _ew_check(label, got, want, rtol):
    """The card's result against the CPU's: on the card; same dtype, length
    and validity; values equal (floats: NaN where NaN, the rest bit for bit
    or within rtol); the whole padded buffer, so the zero tails too.
    Returns the largest relative error."""
    import torch

    require(got.data.is_cuda and (got.validity is None or got.validity.is_cuda), f"elementwise {label}: not on the card")
    require((got.dtype, got.length) == (want.dtype, want.length), f"elementwise {label}: dtype or length")
    require((got.validity is None) == (want.validity is None), f"elementwise {label}: validity buffer")
    if want.validity is not None:
        require(torch.equal(got.validity.cpu(), want.validity), f"elementwise {label}: validity bits")
    g, w = got.data.cpu(), want.data
    require(g.shape == w.shape, f"elementwise {label}: buffer of {g.shape[0]} rows, CPU {w.shape[0]}")
    if not w.is_floating_point():
        require(torch.equal(g, w), f"elementwise {label}: values")
        return 0.0
    nan = torch.isnan(w)
    require(torch.equal(torch.isnan(g), nan), f"elementwise {label}: NaN rows")
    g, w = g[~nan], w[~nan]
    bits = torch.int32 if w.dtype is torch.float32 else torch.int64
    finite = torch.isfinite(w)
    require(torch.equal(g[~finite], w[~finite]), f"elementwise {label}: infinities")
    gf, wf = g[finite].double(), w[finite].double()
    rel = float(((gf - wf).abs() / wf.abs().clamp_min(1e-300)).max()) if gf.numel() else 0.0
    if rtol is None:
        require(torch.equal(g.view(bits), w.view(bits)), f"elementwise {label}: bits differ (max rel err {rel:.3g})")
    else:
        require(rel <= rtol, f"elementwise {label}: max rel err {rel:.3g} > {rtol}")
    return rel


def _ew_chain(K, x, k, pipeline=None):
    """The 6-op chain: |2x + float(k)| by a compare and a merge."""
    c = K.add_op(K.mul_scalar_op(x, 2.0, pipeline), K.cast_op(k, x.dtype, pipeline), pipeline)
    return K.merge_op(c, K.neg_op(c, pipeline), K.gt_scalar_op(c, 0.0, pipeline), pipeline)


def _ew_same_buffers(label, a, b):
    import torch

    require((a.dtype, a.length) == (b.dtype, b.length), f"elementwise {label}: dtype or length")
    require(torch.equal(a.data, b.data), f"elementwise {label}: values")
    require((a.validity is None) == (b.validity is None)
            and (a.validity is None or torch.equal(a.validity, b.validity)), f"elementwise {label}: validity")


def _fused_cases(gpu, want):
    """Every pipelined case of _ew_cases, recorded into one pipeline for each
    ops module on the card (a handful of graph signatures, so a handful of
    builds, all started together), run fused and held to its eager run on
    the card (`want`, label -> CPU copy of the eager CUDA result).  Returns
    (cases, groups, builds, build seconds)."""
    import torch

    import arrow_tpu_torch as att
    from arrow_tpu_torch.compute.kernels import _build
    from arrow_tpu_torch.runtime import fusion

    by_module = {}
    for label, fn, rtol, op in _ew_cases():
        if op is not None:
            by_module.setdefault(ew_module(op), []).append((label, fn, rtol))
    pipes = {}
    for module, cases in by_module.items():
        pipe = att.ComputePipeline(device="cuda")
        pipes[module] = (pipe, [(label, fn(gpu, pipe), rtol) for label, fn, rtol in cases])
    plans = {module: pipe.plan() for module, (pipe, _) in pipes.items()}
    for module, plan in plans.items():
        require(not any(isinstance(s, fusion.Boundary) for s in plan.steps),
                f"fused {module}: an op of the table was planned as a boundary")
    batches = len(_build.GENERATED_BUILDS)
    t0 = time.perf_counter()
    fusion.prepare(list(plans.values()))
    build_s = time.perf_counter() - t0
    builds = sum(len(names) for names, _ in _build.GENERATED_BUILDS[batches:])
    groups = sum(len(plan.groups) for plan in plans.values())
    _build.reset_launch_counts()
    for pipe, _ in pipes.values():
        pipe.finish()
    torch.cuda.synchronize()
    launches = _build.KERNELS["fused_pipeline"].launches
    require(launches == groups, f"fused cases: {launches} launches of fused_pipeline for {groups} groups")
    count = 0
    for module, (_, handles) in pipes.items():
        for label, handle, rtol in handles:
            _ew_check(f"fused {label}", handle.bound(), want[label], rtol)
            count += 1
    return count, groups, builds, build_s


def _chain_bytes(*arrays) -> int:
    """The bytes a fused pass must move for each row: each live input's and
    output's data and validity, once."""
    return sum(a.data.element_size() + (0.125 if a.validity is not None else 0.0) for a in arrays)


def phase_elementwise(smi):
    """Every op of the elementwise tier on the card against the CPU; every
    op and dtype case that the fusion covers, pipelined and fused on the
    card, against its eager run there; the pipelined chains against their
    eager runs, each one launch of fused_pipeline a finish(); the times of
    add_scalar, sum_ and both chains (fused and replayed eagerly) beside
    their bounds; a runtime line (Device, health, profiler, timing).
    Returns (fused_pipeline launches on the chains' runs, {"fused_pipeline":
    Measured of the 2-op chain at the largest size})."""
    import torch

    import arrow_tpu_torch as att
    from arrow_tpu_torch import kernels as K
    from arrow_tpu_torch.compute.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    inputs = _ew_inputs()
    cpu = {key: pair[0] for key, pair in inputs.items()}
    gpu = {key: pair[1] for key, pair in inputs.items()}
    worst = {}
    cases = _ew_cases()
    eager_gpu = {}  # label -> the eager CUDA result, on the host, of each pipelined case
    for label, fn, rtol, op in cases:
        got = fn(gpu)
        rel = _ew_check(label, got, fn(cpu), rtol)
        if op is not None:
            eager_gpu[label] = att.make_array(got.data.cpu(), None if got.validity is None else got.validity.cpu(),
                                              got.length, got.dtype, "cpu")
        name = label.split()[0]
        worst[name] = max(worst.get(name, 0.0), rel)
    print(f"elementwise: {len(cases)} op and dtype cases at {EW_N} rows with nulls match the CPU "
          f"(exact, a NaN matching any NaN; exp, exp2, log, log2, cbrt, float power and the trigonometry "
          f"within rtol {EW_RTOL['float32']} / {EW_RTOL['float64']}, float sums of positive terms within "
          f"{EW_SUM_RTOL['float32']} / {EW_SUM_RTOL['float64']}); outputs on the card; "
          f"{time.perf_counter() - t0:.1f} s")
    print("elementwise: largest relative error by op: "
          + ", ".join(f"{op} {rel:.3g}" for op, rel in sorted(worst.items()) if rel))
    t1 = time.perf_counter()
    count, groups, builds, build_s = _fused_cases(gpu, eager_gpu)
    print(f"elementwise fused: {count} op and dtype cases pipelined ({len(EW_MODULES)} pipelines, one for each "
          f"ops module) run as {groups} fused groups, {groups} launches of fused_pipeline, each equal to its "
          f"eager run on the card (exact, a NaN matching any NaN; transcendental ops within the rtol above); "
          f"{builds} fused builds in {build_s:.1f} s (nvcc, one process for each source, all started together); "
          f"{time.perf_counter() - t1:.1f} s")
    del inputs, cpu, gpu, eager_gpu
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    launches, measured = 0, {}
    for n in EW_CHAIN_SIZES:
        x = att.make_array(torch.randn(n, generator=gen, device="cuda"),
                           torch.randint(-(2**31), 2**31, (n // 32,), generator=gen, device="cuda",
                                         dtype=torch.int32), n, att.ArrowType.FLOAT32)
        k = att.make_array(torch.randint(-(2**31), 2**31, (n,), generator=gen, device="cuda", dtype=torch.int32),
                           None, n, att.ArrowType.UINT32)
        plain = att.make_array(x.data, None, n, att.ArrowType.FLOAT32)
        ten = att.Float32Array.from_slice([10.0], device="cuda")  # simple.py's 1-row rhs

        def simple_chain(x=plain, ten=ten):
            with att.ComputePipeline() as p:
                r = K.mul_scalar_op_dyn(K.add_scalar_op_dyn(x, ten, p), ten, p)
            return r  # the intermediate's handle is dropped

        def six_op_chain(x=x, k=k):
            with att.ComputePipeline() as p:
                r = _ew_chain(K, x, k, p)
            return r

        eager = K.mul_scalar_dyn(K.add_scalar_dyn(plain, ten), ten)
        eager6 = _ew_chain(K, x, k)
        for label, chain, want in (("simple.py chain", simple_chain, eager), ("6-op chain", six_op_chain, eager6)):
            _build.reset_launch_counts()
            got = chain().bound()
            torch.cuda.synchronize()
            fused = _build.KERNELS["fused_pipeline"].launches
            require(fused == 1, f"elementwise n={n} {label}: {fused} launches of fused_pipeline in one finish()")
            launches += fused
            _ew_same_buffers(f"n={n} {label}", got, want)
            require(got.data.is_cuda and (got.validity is None or got.validity.is_cuda),
                    f"elementwise n={n} {label}: output not on the card")
            with plain_path():
                _ew_same_buffers(f"n={n} {label} replayed eagerly", chain().bound(), want)
        print(f"elementwise n={n}: simple.py's chain (add_scalar_op_dyn -> mul_scalar_op_dyn) and the 6-op chain "
              f"(mul_scalar, cast u32->f32, add, gt_scalar, neg, merge) pipelined equal their eager runs, "
              f"each one launch of fused_pipeline a finish(), and so do their eager replays (plain versions)")

        def replayed(chain):
            def run():
                with plain_path():
                    return chain()
            return run

        u32 = att.make_array(k.data, None, n, att.ArrowType.UINT32)
        times = {  # label: (the port's call, its plain version, bytes a row of its bound, a bare torch call)
            "add_scalar f32": (lambda: K.add_scalar(plain, 10.0), None, 8, lambda: plain.data + 10.0, "x + 10.0"),
            "sum_ u32": (lambda: K.sum_(u32), None, 4, lambda: torch.sum(u32.data),
                         "torch.sum(x), int64 accumulation"),
            "pipelined 2-op chain": (simple_chain, replayed(simple_chain), _chain_bytes(plain, eager),
                                     lambda: (plain.data + 10.0) * 10.0, "(x + 10.0) * 10.0"),
            "pipelined 6-op chain": (six_op_chain, replayed(six_op_chain), _chain_bytes(x, k, eager6),
                                     None, None),
        }
        for label, (fn, plain_fn, row_bytes, torch_fn, torch_label) in times.items():
            if plain_fn is None:
                ms, plain_ms = cuda_ms(fn, CALLS_PER_SAMPLE), None
            else:
                ms, plain_ms = interleaved_ms(fn, plain_fn, CALLS_PER_SAMPLE)
            torch_ms = cuda_ms(torch_fn, CALLS_PER_SAMPLE) if torch_fn is not None else None
            bound_ms = row_bytes * n / HBM_BYTES_PER_S * 1e3
            print(f"elementwise n={n} {label}: {ms:.4f} ms"
                  + (f" fused, {plain_ms:.4f} ms replayed eagerly (one pass an op)" if plain_ms is not None else "")
                  + f", bound {bound_ms:.4f} ms ({row_bytes:g} B a row at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
                  f"{100 * bound_ms / ms:.0f}% of it)"
                  + (f"; {torch_label} on the bare buffer {torch_ms:.4f} ms" if torch_ms is not None else "")
                  + f" (CUDA events, median of {REPS} samples of {CALLS_PER_SAMPLE} calls after a warm-up; {smi})")
            if label == "pipelined 2-op chain" and n == EW_CHAIN_SIZES[-1]:
                measured["fused_pipeline"] = Measured(0.0, ms, plain_ms, torch_ms, bound_ms)
        del x, k, plain, u32, eager, eager6
        torch.cuda.empty_cache()
    print(f"elementwise: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"fused builds in this process {sum(len(names) for names, _ in _build.GENERATED_BUILDS)} in "
          f"{len(_build.GENERATED_BUILDS)} batches, {sum(s for _, s in _build.GENERATED_BUILDS):.1f} s of nvcc "
          f"wall time; "
          f"phase {time.perf_counter() - t0:.1f} s")
    phase_runtime(smi)
    return {"fused_pipeline": launches}, measured


def phase_runtime(smi):
    """A runtime line on the card: Device.synchronize and memory_stats, the
    health probe's latency, device_report's top kernels of the flagship
    query, and utils.timing's device time of add_scalar beside the CUDA-event
    time of the same call."""
    import torch

    import arrow_tpu_torch as att
    from arrow_tpu_torch import flagship
    from arrow_tpu_torch import kernels as K
    from arrow_tpu_torch.runtime import health, profiler
    from arrow_tpu_torch.utils import timing

    device = att.default_device()
    require(device.platform == "cuda", f"runtime: the default device is {device}")
    device.synchronize()
    stats = device.memory_stats()
    require(bool(stats) and "allocated_bytes.all.current" in stats, "runtime: memory_stats() is empty on the card")
    latency = health.probe_device(timeout_s=60.0)
    n = FLAGSHIP_SIZES[-1]
    batch = flagship.make_batch(n, seed=0, device="cuda")
    flagship.flagship_query(batch)  # warm-up
    profiler.reset()
    rows = profiler.device_report(flagship.flagship_query, batch, top=5)
    require(bool(rows), "runtime: device_report saw no device kernel of the flagship query")
    del batch
    x = att.make_array(torch.randn(n, device="cuda"), None, n, att.ArrowType.FLOAT32)
    per_iter = timing.device_seconds_per_iter(lambda a: K.add_scalar(a, 1.0), x)
    event_ms = cuda_ms(lambda: K.add_scalar(x, 1.0), CALLS_PER_SAMPLE)
    print(f"runtime: Device.synchronize() ok; memory_stats() {len(stats)} keys, "
          f"{stats['allocated_bytes.all.current'] / 2**30:.2f} GiB allocated; probe_device {latency * 1e3:.3f} ms; "
          f"device_report of the flagship query at n={n}, top 5: "
          + "; ".join(f"{name[:60]} {calls} calls {ms:.3f} ms" for name, calls, ms in rows)
          + f"; device_seconds_per_iter(add_scalar f32, n={n}) {per_iter * 1e3:.4f} ms against "
          f"{event_ms:.4f} ms by CUDA events ({smi})")
    del x
    torch.cuda.empty_cache()


def idle_gaps(device, t0, t1):
    """The stretches [start, end) of [t0, t1) that no device interval covers
    (device: (start, end, name) sorted by start)."""
    gaps, cur = [], t0
    for s, e, _ in device:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def _overlap(a0, a1, b0, b1):
    return min(a1, b1) - max(a0, b0)


def profile_query(label, n, query, batch, smi):
    """One run of query(batch) under torch.profiler, after a warm-up run.
    Device busy time is the union of the device's kernel, copy and set
    intervals inside the query's host interval (the query and a
    synchronize); the idle share is the rest of that interval.  The
    profiler's own host overhead lengthens the interval, so the idle share
    of a profiled query is an upper bound; the idle time in which the host
    was inside the profiler's own "Activity Buffer Request" is printed
    apart.  Prints them, the device ops that take the most time, the CUDA
    runtime calls that take the most host time, and the longest idle gaps
    with the innermost host events that cover at least half of each;
    returns (interval, busy) in ms, or None when the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType

    query(batch)  # warm the allocator
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("the_query"):
            query(batch)
            torch.cuda.synchronize()
    events = prof.events()
    window = [e.time_range for e in events
              if e.name == "the_query" and e.device_type == DeviceType.CPU]
    require(len(window) == 1, f"profile: {len(window)} query ranges in the trace")
    t0, t1 = window[0].start, window[0].end
    device = sorted(
        (max(e.time_range.start, t0), min(e.time_range.end, t1), e.name) for e in events
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and e.name != "the_query" and e.time_range.end > t0 and e.time_range.start < t1
    )
    if not device:
        print(f"profile {label} n={n}: the profiler saw no device activity; device busy time and "
              f"idle share not measured")
        return None
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in device:  # union of the intervals
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    own = sum(us for name, us in by_name.items()
              if any(f"::{f}(" in name or f"::{f}<" in name for f in OWN_DEVICE_FUNCTIONS))
    fills = sum(us for name, us in by_name.items() if any(m in name for m in FILL_OPS))
    copies = sum(us for name, us in by_name.items() if any(m in name for m in COPY_OPS))
    wall = t1 - t0
    print(f"profile {label} n={n} ({smi}): query interval {wall / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall:.3f}; {len(device)} device ops; "
          f"the hand-written kernels {own / 1e3:.3f} ms of the busy time, fills {fills / 1e3:.3f} ms, "
          f"copies {copies / 1e3:.3f} ms")
    for name, us in top:
        print(f"profile {label} n={n}:   {us / 1e3:8.3f} ms  {name[:110]}")
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name != "the_query"
            and e.time_range.end > t0 and e.time_range.start < t1]
    runtime = {}
    for s, e, name in host:
        if name.startswith("cuda"):
            us, calls = runtime.get(name, (0.0, 0))
            runtime[name] = (us + e - s, calls + 1)
    print(f"profile {label} n={n}: host time in CUDA runtime calls: " + ", ".join(
        f"{name} {us / 1e3:.3f} ms ({calls})" for name, (us, calls) in
        sorted(runtime.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]))
    gaps = idle_gaps(device, t0, t1)
    requests = sum(min(ge - gs, sum(max(0.0, _overlap(gs, ge, hs, he)) for hs, he, name in host
                                    if name == "Activity Buffer Request")) for gs, ge in gaps)
    print(f"profile {label} n={n}: the profiler's buffer requests {requests / 1e3:.3f} ms of the idle time; "
          f"idle share without them {1 - (busy + requests) / wall:.3f}")
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:PROFILE_GAPS]:
        inside = sorted((he - hs, name, _overlap(gs, ge, hs, he)) for hs, he, name in host
                        if _overlap(gs, ge, hs, he) >= 0.5 * (ge - gs))[:3]
        print(f"profile {label} n={n}: device idle {(ge - gs) / 1e3:.3f} ms from +{(gs - t0) / 1e3:.3f} ms; "
              f"host in " + (", ".join(f"{name[:60]} ({ov / 1e3:.3f} ms)" for _, name, ov in inside) or "no op"))
    return wall / 1e3, busy / 1e3


def phase_profile(smi):
    """Each query at each size under torch.profiler (profile_query)."""
    import torch

    from arrow_tpu_torch import flagship

    queries = [("flagship", n, flagship.flagship_query, flagship.make_batch) for n in FLAGSHIP_SIZES]
    queries.append(("sort_join", SORT_JOIN_N, flagship.sort_join_query, flagship.make_batch))
    for dist in ("1k", "1m"):
        queries.append((f"groupby {dist}", GROUPBY_N, flagship.groupby_query,
                        lambda n, seed, device, dist=dist: flagship.make_groupby_batch(n, dist, seed, device)))
    for label, n, query, make in queries:
        batch = make(n, seed=0, device="cuda")
        profile_query(label, n, query, batch, smi)
        del batch
        torch.cuda.empty_cache()


# the probe tools: probe_r4's rows (its default, the JAX tool's 2^27), and
# the rates of the probes' operations: the tensor cores' for the two matmul
# probes (data sheet), and for the merge steps the card's 32-bit integer
# rate, 132 SMs x 64 lanes a clock at 1.98 GHz (the clock at which the data
# sheet's 67 TFLOP/s float32, 132 SMs x 128 lanes x 2, holds)
PROBE_R4_ROWS = 1 << 27
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_S = {"matmul_int8_s32acc": 1979e12, "i1_to_bf16_astype": 989e12,
             "mb_step_rollpair": INT32_OPS_PER_S, "mb_step_taa": INT32_OPS_PER_S}
PROBE_R4_OUT = HERE / "build" / "arrow_tpu_torch" / "TORCH_PROBE_R4.json"


def probe_bytes(label, args, out) -> int:
    """The bytes a probe must move: each input row it needs read once (the
    row windows' 8 rows, the sized copy's rows, one column of the scalar
    loop), the output written once."""
    if label in ("dma_unaligned_row_offset", "dynamic_slice_vmem_rows", "hbm_to_hbm_dma", "dma_dynamic_size_rows"):
        src = args[-1]  # after the device scalar, where there is one
        rows = int(args[0][0]) if label == "dma_dynamic_size_rows" else 8
        read = 4 * (len(args) - 1) + rows * src.shape[1] * src.element_size()
    elif label == "smem_scratch_scalar_loop":
        read = 8 * args[0].element_size()
    else:
        read = sum(a.numel() * a.element_size() for a in args)
    return read + out.numel() * out.element_size()


def phase_probes(smi):
    """The probe tools through their entry points (mosaic_probe's 25 probes,
    probe_r4's seven steps at PROBE_R4_ROWS rows), the launch counts set to
    0 just before and read just after; then each of their kernels against
    its plain version on the card and the JAX probe's oracle, timed on the
    device (utils.timing.queued_seconds_per_call) beside an empty kernel,
    its bound, its plain version and its library call, and back to back;
    the redesigned kernels in turns with their other designs
    (arrow_tpu_torch.tools.probe_designs).
    The merge steps' plain versions read R on the host, so their time is
    host-bound (back to back).  Returns (launches by kernel, Measured by
    probe kernel)."""
    import torch

    from arrow_tpu_torch.compute.kernels import _build
    from arrow_tpu_torch.tools import mosaic_probe as MP
    from arrow_tpu_torch.tools import probe_designs as PD
    from arrow_tpu_torch.tools import probe_r4 as PR

    queued_ms = PD.queued_ms
    device = torch.device("cuda")
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    MP.main([])
    PR.main(["--rows", str(PROBE_R4_ROWS), "--out", str(PROBE_R4_OUT)])
    torch.cuda.synchronize()
    launches = _kernel_launches()
    print(f"probes: both tools ran in {time.perf_counter() - t0:.1f} s; launches "
          f"{ {n: c for n, c in launches.items() if c} }")
    failed = [f"{label}: {msg}" for label, status, msg in MP.RESULTS if status != "OK"]
    require(len(MP.RESULTS) == len(MP.PROBES) and not failed, f"mosaic_probe: {failed or MP.RESULTS}")
    report = json.loads(PROBE_R4_OUT.read_text())
    keys = json.loads((HERE / "PROBE_R4.json").read_text()).keys()
    require(keys <= report.keys(), f"probe_r4: keys missing from its report: {sorted(keys - report.keys())}")
    errors = [k for k, v in report.items() if isinstance(v, dict) and "error" in v]
    require(errors == ["sum_pallas_128m_s"], f"probe_r4: steps failed: {errors}")
    require(report["i1_to_bf16_astype"] == {"ok": True}, "probe_r4: the mask matmul is not all 128")
    require(report["ragged_all_to_all_tpu_1dev"]["out_head"] == [0, 0, 0, 1, 2, 3, 0, 0],
            f"probe_r4: all_to_all_single gave {report['ragged_all_to_all_tpu_1dev']}")
    for name in PR.MERGE_STEPS:
        require(report[name]["us_per_step"] > 0 and report[name]["card"]["us_per_step"] > 0,
                f"probe_r4: {name}: {report[name]}")
    print(f"probes: probe_r4 at {PROBE_R4_ROWS} rows ({smi}): {json.dumps(report)}")
    for name in PR.MERGE_STEPS:
        print(f"probes: {name}: {report[name]['us_per_step']:.3f} us a step on one block, "
              f"{report[name]['card']['us_per_step']:.3f} with one block an SM; {PR.sm_floor_line()} ({smi})")
    probes = [*MP.PROBES, *PR.KERNELS]
    unlaunched = [p.label for p in probes if not launches.get(p.label)]
    require(not unlaunched, f"probe kernels not launched by the tools: {unlaunched}")

    empty_host_ms = cuda_ms(lambda: MP.empty_launch(device), CALLS_PER_SAMPLE)
    empty_ms = queued_ms(lambda: MP.empty_launch(device), "an empty kernel")
    print(f"probes: an empty kernel: {empty_ms:.5f} ms of the device's time a call, queued; "
          f"{empty_host_ms:.5f} ms a call back to back, host-bound ({smi})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    measured = {}
    for p in probes:
        args = MP.inputs_on(p, device)
        got = MP.launch(p, *args)
        want = MP.plain(p, *args)
        torch.cuda.synchronize()
        require(got.dtype == want.dtype and got.shape == want.shape and bool(torch.equal(got, want)),
                f"{p.label}: the kernel disagrees with its plain version")
        if p.oracle is not None:
            require(bool((MP.as_numpy(got) == p.oracle(*p.inputs())).all()), f"{p.label}: the kernel misses its oracle")
        if p.label in PR.MERGE_STEPS:
            many = MP.launch(p, *args, blocks=sms)
            require(bool(torch.equal(many, got.expand_as(many))), f"{p.label}: {sms} blocks disagree")
        err = float((got.double() - want.double()).abs().max())
        host_ms = cuda_ms(lambda: MP.launch(p, *args), CALLS_PER_SAMPLE)
        ms = queued_ms(lambda: MP.launch(p, *args), p.label)
        if p.label in PR.MERGE_STEPS:
            plain_ms, plain_how = cuda_ms(lambda: MP.plain(p, *args), CALLS_PER_SAMPLE), "host-bound"
        else:
            plain_ms, plain_how = queued_ms(lambda: MP.plain(p, *args), f"{p.label}'s plain version"), "queued"
        lib = MP.library_call(p.label, args)
        library_ms = queued_ms(lib, f"{p.label}'s library call") if lib is not None else None
        reference = ""
        if p.label == "i1_to_bf16_astype":  # a yardstick of its product alone, the bf16 mask made outside
            mask = (args[0] > 0).to(torch.bfloat16)
            ones = torch.ones_like(mask)
            reference = (f"; not its function: the bf16 matmul of the mask made beforehand "
                         f"{queued_ms(lambda: torch.matmul(mask, ones), 'the mask matmul'):.5f} ms queued")
        bytes_ms = probe_bytes(p.label, args, got) / HBM_BYTES_PER_S * 1e3
        ops_ms = p.ops / OPS_PER_S[p.label] * 1e3 if p.ops else 0.0
        m = Measured(err, ms, plain_ms, library_ms, max(bytes_ms, ops_ms),
                     "bytes" if bytes_ms >= ops_ms else "operations")
        measured[p.label] = m
        print(f"probes: {p.label} ({p.kernel.replaces}; inputs {[tuple(a.shape) for a in args]}): matches plain"
              f"{' and oracle' if p.oracle is not None else ''}; {m.line(5)} (kernel queued, plain {plain_how}"
              f"{', library queued' if lib is not None else ''}); {ms / empty_ms:.2f}x an empty kernel; "
              f"{host_ms:.5f} ms a call back to back{reference} ({smi})")

    # the redesigned kernels in turns with their other designs
    PD.run(device, lambda line: print(f"probes: {line} ({smi})"))
    print(f"probes: phase {time.perf_counter() - t0:.1f} s")
    return launches, measured


def main() -> int:
    if not (HERE / "arrow_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: arrow_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    smi = phase_device()
    phase_build()
    errs, measured = phase_kernels(smi)
    phase_flagship(smi)
    launches, sort_join_measured = phase_sort_join(smi)
    groupby_launches, groupby_measured = phase_groupby(smi)
    dist_launches = phase_distributed(smi)
    ew_launches, ew_measured = phase_elementwise(smi)
    probe_launches, probe_measured = phase_probes(smi)
    phase_profile(smi)

    from arrow_tpu_torch.compute.kernels import _build

    # each kernel's numbers from the runs that launch it: B8, B9 and
    # take_columns from their timed calls of phase 3, the rest from the main
    # paths' replayed calls
    for name, m in (*sort_join_measured.items(), *groupby_measured.items(), *ew_measured.items(),
                    *probe_measured.items()):
        measured[name] = measured[name] + m if name in measured else m
    kernels = []
    for name, k in _build.KERNELS.items():
        require(name in measured, f"{name}: no call of it was timed")
        m = measured[name]
        kernels.append({
            "name": name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": (launches.get(name, 0) + groupby_launches.get(name, 0) + dist_launches.get(name, 0)
                         + ew_launches.get(name, 0) + probe_launches.get(name, 0)),
            "max_abs_err": max(errs.get(name, 0.0), m.err),
            "ms": m.ms, "plain_ms": m.plain_ms, "bound_ms": m.bound_ms, "bound_by": m.bound_by,
            "library_ms": m.library_ms,
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
