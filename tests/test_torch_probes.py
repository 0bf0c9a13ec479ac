"""arrow_tpu_torch.tools.mosaic_probe and probe_r4 against the JAX tools on
the CPU.

The JAX tools (``tools/mosaic_probe.py``, ``tools/probe_r4.py``) are loaded
by path, with their module-level ``pl`` replaced by a shim whose
``pallas_call`` runs the kernel in TPU interpret mode and records each
call's inputs and output; nothing in them is edited.  mosaic_probe's 25
probes run as the tool runs them: 24 go through interpret mode, and
``smem_scratch_scalar_loop`` fails there (its weak-int ``fori_loop`` carry
under x64), so the port's version of that one is held to the probe's oracle
(3584).  probe_r4's ``main()`` runs with the module it can no longer import
(``arrow_tpu.compute.kernels.reduction``) stubbed, N at 2^14, no timing and
no file written; the shim runs each of its kernels once with the loop count
R at 3.  The port's plain versions then run on the recorded inputs.

Both command lines run once with jax blocked (``python -m``, ``--device
cpu``): the matrix lists every JAX label, and the report holds every
``PROBE_R4.json`` key.

Tolerance: exact everywhere (the bf16 values are 0, 1 and 128, and the f32
cumsum adds ones).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pl
from jax.experimental.pallas import tpu as pltpu

from arrow_tpu_torch.compute.kernels import _build
from arrow_tpu_torch.tools import mosaic_probe as MP
from arrow_tpu_torch.tools import probe_r4 as PR

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBE_R4_KEYS = json.loads((ROOT / "PROBE_R4.json").read_text()).keys()
NOT_INTERPRETABLE = "smem_scratch_scalar_loop"
INTERPRETED = [p.label for p in MP.PROBES if p.label != NOT_INTERPRETABLE]
R4_STEPS = 3
REDUCTION = "arrow_tpu.compute.kernels.reduction"  # the module probe_r4.py:88 imports, no longer in the package
BLOCK_JAX = ("import runpy, sys; sys.modules['jax'] = None; sys.argv = sys.argv[1:]; "
             "runpy.run_module(sys.argv[0], run_name='__main__')")
# probe_r4's command line with jax blocked and the merge step's R pair
# lowered from (256, 4096): the plain step takes 3-4 ms on the CPU
R4_STEPS_LOW = ("import sys; sys.modules['jax'] = None; import arrow_tpu_torch.tools.probe_r4 as m; "
                "m.STEPS = (2, 4); sys.exit(m.main(sys.argv[1:]))")
CLI_TIMEOUT = 120


def _shim(pallas_call):
    """A stand-in for a tool's ``pl``: Pallas with this pallas_call."""
    shim = types.SimpleNamespace(**{k: getattr(jax_pl, k) for k in dir(jax_pl) if not k.startswith("__")})
    shim.pallas_call = pallas_call
    return shim


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(x) -> np.ndarray:
    """A JAX or torch result as numpy: bf16 as float32, u32 as its int32 bits."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.astype(np.float32)
    return x.view(np.int32) if x.dtype == np.uint32 else x


@pytest.fixture(scope="module")
def jax_probes():
    """label -> (inputs, output) of each probe's pallas_call in interpret
    mode, the JAX tool's results, and the tool."""
    mod = _load("jax_mosaic_probe", "tools/mosaic_probe.py")
    calls = {}
    current = []

    def pallas_call(kernel, **kw):
        inner = jax_pl.pallas_call(kernel, interpret=pltpu.InterpretParams(), **kw)

        def call(*args):
            out = inner(*args)
            calls[current[0]] = ([_host(a) for a in args], _host(out))
            return out
        return call

    mod.pl = _shim(pallas_call)
    for fn in mod.ALL:
        current[:] = [fn.__name__]
        fn()
    return calls, {name: status for name, status, _ in mod.RESULTS}, mod


@pytest.fixture(scope="module")
def jax_r4():
    """The JAX probe_r4's kernels in interpret mode at R = 3, in call order
    (rollpair, taa, the mask matmul): (inputs, output) of each, and the
    tool's report.  Each kernel runs once; its later calls (the timing loop)
    return that output."""
    calls = []

    def pallas_call(kernel, **kw):
        inner = jax_pl.pallas_call(kernel, interpret=pltpu.InterpretParams(), **kw)
        slot = {}
        calls.append(slot)

        def call(*args):
            if not slot:
                if len(args) == 3:  # the merge step: its loop count to R4_STEPS
                    args = (jnp.full((1,), R4_STEPS, jnp.int32), *args[1:])
                slot["out"] = inner(*args)
                slot["record"] = ([_host(a) for a in args], _host(slot["out"]))
            return slot["out"]
        return call

    saved = sys.modules.get(REDUCTION)
    sys.modules[REDUCTION] = types.SimpleNamespace(sum_pallas=None)
    try:
        mod = _load("jax_probe_r4", "tools/probe_r4.py")
        mod.pl = _shim(pallas_call)
        mod.N = 1 << 14
        mod.save = lambda: None
        mod.device_seconds_per_iter = lambda *a, **k: 0.0
        mod.main()
    finally:
        if saved is None:
            sys.modules.pop(REDUCTION, None)
        else:
            sys.modules[REDUCTION] = saved
    return [slot["record"] for slot in calls], mod.OUT


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """Both command lines, started together with jax blocked: name -> (Popen,
    report path or None)."""
    root = tmp_path_factory.mktemp("probes")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    report = root / "TORCH_PROBE_R4.json"
    argv = {"mosaic_probe": (["-c", BLOCK_JAX, "arrow_tpu_torch.tools.mosaic_probe", "--device", "cpu"], None),
            "probe_r4": (["-c", R4_STEPS_LOW, "--device", "cpu", "--rows", "65536", "--out", str(report)], report)}
    procs = {name: (subprocess.Popen([sys.executable, *args], env=env, cwd=str(root),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT), out)
             for name, (args, out) in argv.items()}
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _cli(clis, name):
    proc, out = clis[name]
    log, _ = proc.communicate(timeout=CLI_TIMEOUT)
    log = log.decode(errors="replace")
    assert proc.returncode == 0, log[-4000:]
    return log, out


# ---------------------------------------------------------------------------
# mosaic_probe


def test_probe_table_is_the_jax_tools(jax_probes):
    """The port has the JAX tool's 25 labels, in its order of runs, and its
    QUICK substrings."""
    mod = jax_probes[2]
    assert [fn.__name__ for fn in mod.ALL] == [p.label for p in MP.PROBES]
    assert MP.QUICK == mod.QUICK
    assert jax_probes[1] == {p.label: "FAIL" if p.label == NOT_INTERPRETABLE else "OK" for p in MP.PROBES}


@pytest.mark.parametrize("label", INTERPRETED)
def test_probe_matches_jax(jax_probes, label):
    """The port's inputs are the JAX probe's, and its plain version gives
    the JAX kernel's output on them (the rows the JAX probe writes)."""
    probe = MP.BY_LABEL[label]
    jax_args, jax_out = jax_probes[0][label]
    ours = probe.inputs()
    assert len(ours) == len(jax_args)
    for a, b in zip(ours, jax_args):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    got = _host(MP.run(probe, *[torch.from_numpy(np.array(a)) for a in jax_args]))
    rows = probe.rows(*ours) if probe.rows else slice(None)
    assert got.shape == jax_out.shape
    np.testing.assert_array_equal(got[rows], jax_out[rows])


def test_smem_scratch_scalar_loop_oracle():
    """The probe that interpret mode rejects, against its oracle: the sum of
    a[i, 0] for i < 8 over the whole (8, 128) output."""
    probe = MP.BY_LABEL[NOT_INTERPRETABLE]
    got = MP.run(probe, *MP.inputs_on(probe, "cpu"))
    assert got.shape == (8, 128) and bool((got == 3584).all())


@pytest.mark.parametrize("label", [p.label for p in MP.PROBES])
def test_probe_oracle_on_the_cpu(label):
    """Each probe's check (plain version against the numpy oracle, whole
    output) passes on the CPU without a launch."""
    probe = MP.BY_LABEL[label]
    before = probe.kernel.launches
    MP.check(probe, "cpu")
    assert probe.kernel.launches == before


# the probes of a row window at a device row s, whose kernels read s on the
# card; every legal s, on full-range random rows
WINDOW_LABELS = ["dynamic_slice_vmem_rows", "dma_unaligned_row_write", "dma_unaligned_row_offset"]


@pytest.mark.parametrize("s", range(64 - 8 + 1))
@pytest.mark.parametrize("label", WINDOW_LABELS)
def test_row_window_plain_matches_oracle_at_every_row(label, s):
    probe = MP.BY_LABEL[label]
    rows = np.random.default_rng(s).integers(-2 ** 31, 2 ** 31, probe.inputs()[1].shape, np.int32)
    at = np.full((1,), s, np.int32)
    got = MP.run(probe, torch.from_numpy(at), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), probe.oracle(at, rows))


@pytest.mark.parametrize("s", [2 ** 31 - 7, -2 ** 31 + 7])
def test_prefetch_scalar_grid_plain_wraps_as_the_oracle(s):
    """x + s on full-range rows with s near either end of the int32 range:
    the plain version wraps as the JAX probe's numpy oracle does, and some
    sums do wrap."""
    probe = MP.BY_LABEL["prefetch_scalar_grid"]
    x = np.random.default_rng(16).integers(-2 ** 31, 2 ** 31, probe.inputs()[1].shape, np.int32)
    at = np.full((1,), s, np.int32)
    exact = x.astype(np.int64) + s
    assert ((exact > 2 ** 31 - 1) | (exact < -2 ** 31)).any()
    got = MP.run(probe, torch.from_numpy(at), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, probe.oracle(at, x))
    np.testing.assert_array_equal(got, ((exact + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32))


def test_no_probe_output_is_zeroed_by_its_wrapper():
    """dma_unaligned_row_write's kernel writes its own zeros outside the
    window, so the Probe table has no fill option left and the launcher
    allocates every output with torch.empty: a call is one kernel."""
    assert "zeroed" not in {f.name for f in dataclasses.fields(MP.Probe)}
    p4 = MP.BY_LABEL["dma_unaligned_row_write"]
    assert p4.rows(*p4.inputs()) == slice(5, 13) and p4.shape == (64, 128)


@pytest.mark.parametrize("label", ["grid_1d_blockspec", "mb_step_taa"])
def test_launch_needs_cuda_tensors(label):
    """The wrappers never run a plain version for the kernel: the launcher
    refuses CPU tensors, and a wrong shape raises before any launch."""
    probe = MP.BY_LABEL.get(label) or PR.BY_NAME[label]
    args = MP.inputs_on(probe, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        MP.launch(probe, *args)
    with pytest.raises(ValueError, match=f"input {len(args) - 1}"):
        MP.plain(probe, *args[:-1], args[-1][:1])


def test_kernel_records():
    """Each of the 28 kernels is registered with its source and the JAX
    tool's pallas_call site and label."""
    for probe in MP.PROBES:
        k = _build.KERNELS[probe.label]
        assert (k.source, k.route) == (MP.SOURCE, "cuda")
        assert k.replaces == f"tools/mosaic_probe.py:{probe.site} ({probe.label})"
        assert (ROOT / k.source).is_file()
    for probe in PR.KERNELS:
        k = _build.KERNELS[probe.label]
        assert k.source == PR.SOURCE and k.replaces == f"tools/probe_r4.py:{probe.site} ({probe.label})"
    lines = (ROOT / "tools/mosaic_probe.py").read_text().splitlines()
    assert {p.site for p in MP.PROBES if p.site != MP.SIMPLE_CALL} == {
        i + 1 for i, ln in enumerate(lines) if "pl.pallas_call(" in ln and "return" not in ln}
    assert sum(p.site == MP.SIMPLE_CALL for p in MP.PROBES) == 19


def test_mosaic_probe_cli(clis):
    log, _ = _cli(clis, "mosaic_probe")
    matrix = log.split("=== MATRIX ===")[1].split()
    labels = [matrix[i + 1] for i in range(0, len(matrix), 2)]
    assert labels == [p.label for p in MP.PROBES]
    assert matrix[::2] == ["OK"] * len(MP.PROBES)


def test_mosaic_probe_selection():
    mod_quick = [p.label for p in MP.selected("--quick")]
    assert mod_quick == [p.label for p in MP.PROBES if any(q in p.label for q in MP.QUICK)]
    assert {p.label for p in MP.selected("gather")} == {
        "gather_lanes_256wide_2gathers", "gather_lanes_taa_8x128_i32", "gather_lanes_taa_256x128_i32",
        "gather_lanes_f32", "gather_sublanes_taa_axis0"}


# ---------------------------------------------------------------------------
# probe_r4


@pytest.mark.parametrize("index,name", [(0, "mb_step_rollpair"), (1, "mb_step_taa"), (2, "i1_to_bf16_astype")])
def test_r4_kernel_matches_jax(jax_r4, index, name):
    """Each kernel's plain version on the JAX kernel's inputs (R = 3) gives
    its output exactly; the inputs are the port's."""
    jax_args, jax_out = jax_r4[0][index]
    probe = PR.BY_NAME[name]
    for a, b in zip(probe.inputs(), jax_args):
        np.testing.assert_array_equal(a, b)
    got = _host(MP.run(probe, *[torch.from_numpy(np.array(a)) for a in jax_args]))
    np.testing.assert_array_equal(got, jax_out)


def test_r4_merge_step_forms_differ(jax_r4):
    """The XOR form cleans its short stages in the opposite order, in JAX as
    in the port: the two outputs differ at R = 3."""
    (args, roll), (_, taa) = jax_r4[0][:2]
    assert not np.array_equal(roll, taa)
    t = [torch.from_numpy(np.array(a)) for a in args]
    assert not torch.equal(MP.run(PR.BY_NAME["mb_step_rollpair"], *t), MP.run(PR.BY_NAME["mb_step_taa"], *t))


# the merge step's inputs beyond the probe's: full-range random keys
def _random_step_inputs():
    rng = np.random.default_rng(180)
    return [torch.full((1,), R4_STEPS, dtype=torch.int32)] + [
        torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (PR.BUF // PR.LANES, PR.LANES), np.int32)) for _ in "ab"]


@pytest.mark.parametrize("inputs", ["probe", "random"])
@pytest.mark.parametrize("name", PR.MERGE_STEPS)
def test_r4_merge_step_invariants(name, inputs):
    """The two invariants the kernel's packed key relies on, after each
    step's clean at R = 3: the tags are unique (so every (k, t) is, and both
    forms' rules are a plain min/max), and v is k ^ 3 where t < 4096 (A's
    value) and k ^ 5 elsewhere (B's)."""
    args = MP.inputs_on(PR.BY_NAME[name], "cpu") if inputs == "probe" else _random_step_inputs()
    steps = list(PR.merge_step_rows(*args, name == "mb_step_taa"))
    assert len(steps) == R4_STEPS
    for k, t, v in steps:
        # each row index i once, as A's tag i or B's 8191 - i
        assert torch.equal(torch.sort(torch.where(t < PR.T, t, 2 * PR.T - 1 - t)).values, torch.arange(PR.T))
        assert len(torch.unique(t)) == PR.T and len(torch.unique(k.long() << 13 | t)) == PR.T
        assert torch.equal(v, k ^ torch.where(t < PR.T, 3, 5).int())


def _packed_step(r, a, b, xor):
    """The merge step on one biased 64-bit key a row, ((k + 2^31) << 13) | t,
    as the kernel cleans it: min/max a stage, the lesser key on the lower
    row (bit d of the row index clear) except at the XOR form's distances
    under 128, where it goes up; k and v rebuilt at the end."""
    fa, fb = a.reshape(-1).long(), b.reshape(-1).long()
    i = torch.arange(PR.T)
    acc = torch.zeros(PR.T, dtype=torch.int64)
    h = 0
    for _ in range(int(r[0])):
        wa, rb = fa[(i + h) % PR.BUF], fb[(PR.T - 1 - i + h + 7) % PR.BUF]
        key = (torch.minimum(wa, rb) + 2 ** 31) << 13 | torch.where(wa <= rb, i, 2 * PR.T - 1 - i)
        d = PR.T // 2
        while d:
            p, lower = key[i ^ d], (i & d) == 0
            key = torch.where(lower != (xor and d < PR.LANES), torch.minimum(key, p), torch.maximum(key, p))
            d //= 2
        k = (key >> 13) - 2 ** 31
        acc += k + (k ^ torch.where(key & PR.T != 0, 5, 3))
        h = (h + 1789) % PR.BUF
    return ((acc + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32).reshape(PR.TR, PR.LANES)


@pytest.mark.parametrize("name", PR.MERGE_STEPS)
def test_r4_packed_key_step_matches_plain(name):
    """The packed-key formulation equals the plain version on every input
    probe_designs holds the kernel's designs on: the probe's, keys in
    [0, 100) with many ties, full-range keys and all INT_MIN against all
    INT_MAX, at R = 0, 1 and 5."""
    from arrow_tpu_torch.tools import probe_designs as PD

    probe = PR.BY_NAME[name]
    cases = list(PD.held_inputs(probe, "cpu"))
    assert [int(c[0]) for c in cases] == [R4_STEPS] + list(PD.STEP_HELD_R) * 3
    for args in cases:
        assert torch.equal(_packed_step(*args, name == "mb_step_taa"), MP.plain(probe, *args))


@pytest.mark.parametrize("index,name", [(0, "mb_step_rollpair"), (1, "mb_step_taa")])
def test_r4_packed_key_step_matches_jax(jax_r4, index, name):
    """The packed-key formulation gives the JAX kernel's output on its
    inputs (R = 3)."""
    jax_args, jax_out = jax_r4[0][index]
    got = _packed_step(*[torch.from_numpy(np.array(a)) for a in jax_args], name == "mb_step_taa")
    np.testing.assert_array_equal(got.numpy(), jax_out)


def test_r4_jax_report(jax_r4):
    """The JAX main() ran to its end: every step recorded, the mask matmul
    ok, and only the CPU's missing ragged all-to-all failed."""
    report = jax_r4[1]
    assert report.keys() == PROBE_R4_KEYS
    assert report["i1_to_bf16_astype"] == {"ok": True}
    assert [k for k, v in report.items() if isinstance(v, dict) and "error" in v] == ["ragged_all_to_all_tpu_1dev"]


def test_probe_r4_cli(clis):
    log, path = _cli(clis, "probe_r4")
    report = json.loads(path.read_text())
    assert PROBE_R4_KEYS | {"device", "gpu"} <= report.keys()
    assert report["device"] == "cpu" and report["gpu"] is None
    assert [k for k, v in report.items() if isinstance(v, dict) and "error" in v] == ["sum_pallas_128m_s"]
    assert report["i1_to_bf16_astype"] == {"ok": True}
    assert report["ragged_all_to_all_tpu_1dev"]["out_head"] == [0, 0, 0, 1, 2, 3, 0, 0]
    for name in PR.MERGE_STEPS:
        assert report[name]["blocks"] == 1 and "card" not in report[name]
    assert "DONE" in log
