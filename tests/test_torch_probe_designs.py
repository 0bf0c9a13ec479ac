"""arrow_tpu_torch.tools.probe_designs on the CPU: the other designs of the
redesigned probe kernels are made from the current source by text
substitution, so each substitution must find its text exactly once; the
wgmma wrapper that the tool writes for a tile width must be the source's own
at the source's width; each redesigned kernel has its earlier source's path,
its turns and a library call.  The builds and times need the card
(``chip_smoke.py``'s ``probes`` phase)."""

import pytest
import torch

from arrow_tpu_torch.tools import mosaic_probe as MP
from arrow_tpu_torch.tools import probe_designs as PD


def test_wrapper_is_the_sources():
    assert PD.SOURCE.read_text().count(PD.wgmma_wrapper(PD.TILE)) == 1


@pytest.mark.parametrize("design", ["staging", "tile64", "tile128", "window", "bulk", "bulk_in", "one_block"])
def test_design_sources(design):
    source = PD.SOURCE.read_text()
    text = PD.design_sources()[design]
    assert text != source
    if design == "staging":
        assert PD.PRODUCT_CALL not in text and "wgmma_m64nNk32(d, " in text
    elif design == "window":
        assert source.count(PD.SLICE_EVERY_ROW) == 1
        assert PD.SLICE_EVERY_ROW not in text and text.count("constexpr bool kSliceEveryRow = false;") == 1
    elif design == "bulk":
        assert source.count(PD.WRITE_BULK) == 1
        assert PD.WRITE_BULK not in text and text.count("constexpr bool kWriteBulk = true;") == 1
    elif design == "bulk_in":
        assert source.count(PD.OFFSET_BULK) == 1
        assert PD.OFFSET_BULK not in text and text.count("constexpr bool kOffsetBulk = true;") == 1
    elif design == "one_block":
        assert source.count(PD.SCALAR_ONE_BLOCK) == 1
        assert PD.SCALAR_ONE_BLOCK not in text and text.count("constexpr bool kScalarOneBlock = true;") == 1
    else:
        n = int(design[4:])
        assert f"constexpr int kTileN = {n};" in text and f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8" in text
        assert f"%{n // 2 - 1}}}," in text and f'"+r"(d[{n // 2 - 1}])' in text and f'"+r"(d[{n // 2}])' not in text


@pytest.mark.parametrize("label", PD.REDESIGNED)
def test_redesigned_kernel_has_its_earlier_source_turns_and_library_call(label):
    """Each kernel's earlier design is the source of the commit before its
    redesign, under build/parent/<commit>/, a library of its own; every
    design it is timed against is one that the tool builds; and its library
    call gives its function on the probe's inputs."""
    path = PD.earlier_source(label)
    assert path.relative_to(PD.PARENT).parts == (PD.BEFORE[label], "arrow_tpu_torch", "csrc", "mosaic_probe.cu")
    assert PD.library_name(label, "earlier") == f"earlier_{PD.BEFORE[label]}"
    built = set(PD.design_sources()) | {PD.library_name(label, "earlier")}
    assert PD.TURNS[label][0] == "earlier" and {PD.library_name(label, d) for d in PD.TURNS[label]} <= built
    probe = MP.BY_LABEL[label]
    args = MP.inputs_on(probe, "cpu")
    got = MP.library_call(label, args)()
    assert torch.equal(got, MP.plain(probe, *args))


def test_held_inputs_cover_every_window_row():
    """A row window's designs are held at the probe's own s and at every
    legal s in [0, 56] on one set of full-range random rows."""
    for label in PD.WINDOWED:
        cases = list(PD.held_inputs(MP.BY_LABEL[label], "cpu"))
        assert [int(s) for s, _ in cases[1:]] == list(range(57))
        rows = cases[1][1]
        assert all(r is rows for _, r in cases[1:]) and rows.min() < -2 ** 30 and rows.max() > 2 ** 30
        assert [tuple(a.shape) for a in cases[0]] == [tuple(a.shape) for a in cases[1]]


def test_held_inputs_wrap_the_scalar_add():
    """The scalar add's designs are held at the probe's own inputs and on
    full-range rows with a scalar near either end of the int32 range, where
    the sum wraps both ways."""
    for label in PD.WRAPPED:
        probe = MP.BY_LABEL[label]
        cases = list(PD.held_inputs(probe, "cpu"))
        assert [int(s) for s, _ in cases[1:]] == [2 ** 31 - 3, -2 ** 31 + 3]
        for s, rows in cases[1:]:
            exact = rows.long() + int(s)
            assert ((exact > 2 ** 31 - 1) | (exact < -2 ** 31)).any()
            assert torch.equal(MP.plain(probe, s, rows).long(), (exact + 2 ** 31) % 2 ** 32 - 2 ** 31)
