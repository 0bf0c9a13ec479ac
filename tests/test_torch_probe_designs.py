"""arrow_tpu_torch.tools.probe_designs on the CPU: the other designs of the
two redesigned probe kernels are made from the current source by text
substitution, so each substitution must find its text exactly once; the
wgmma wrapper that the tool writes for a tile width must be the source's own
at the source's width.  The builds and times need the card
(``chip_smoke.py``'s ``probes`` phase)."""

import pytest

from arrow_tpu_torch.tools import probe_designs as PD


def test_wrapper_is_the_sources():
    assert PD.SOURCE.read_text().count(PD.wgmma_wrapper(PD.TILE)) == 1


@pytest.mark.parametrize("design", ["staging", "tile64", "tile128"])
def test_design_sources(design):
    text = PD.design_sources()[design]
    assert text != PD.SOURCE.read_text()
    if design == "staging":
        assert PD.PRODUCT_CALL not in text and "wgmma_m64nNk32(d, " in text
    else:
        n = int(design[4:])
        assert f"constexpr int kTileN = {n};" in text and f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8" in text
        assert f"%{n // 2 - 1}}}," in text and f'"+r"(d[{n // 2 - 1}])' in text and f'"+r"(d[{n // 2}])' not in text
